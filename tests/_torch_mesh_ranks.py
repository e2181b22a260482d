# tests/_torch_mesh_ranks.py
"""The rank side of tests/test_torch_mesh.py: a torch.distributed gloo group
of spawned processes on the CPU, each running every check of the group mesh
once and sending its results (numpy arrays) back to the parent.

Spawned children re-import the module that defines their target, so this
module imports neither JAX nor gpmp_tpu: only numpy, torch and the port.
The data and the model's kernel are defined here, for both sides.
"""

import datetime
import os
import socket
import traceback

import numpy as np

N, D, BLOCK, NT = 256, 3, 64, 16
N_STRADDLE, BLOCK_STRADDLE = 384, 128  # at two ranks, panel [128, 256) straddles them
GROUP_TIMEOUT_S = 60


def make_data(n=N, seed=20260817):
    """bench_large_n.py's make_data at n points (d = 3), NT test points, p0."""
    rng = np.random.default_rng(seed)
    xi = rng.uniform(size=(n, D))
    zi = (np.sin(3.0 * xi[:, 0]) + 0.5 * xi[:, 1] + 0.25 * xi[:, 2] ** 2
          + 0.05 * rng.normal(size=n))
    xt = rng.uniform(size=(NT, D))
    p0 = np.concatenate([[np.log(np.var(zi))], [np.log(1e-2)], -np.log(np.std(xi, axis=0))])
    return xi, zi, xt, p0


def kernel_for(gp, gnp):
    """bench_large_n.py's kernel (Matern p = 2 plus a noise variance), for
    either package."""
    def kernel(x, y, param, pairwise=False):
        sigma2, noise, loginvrho = gnp.exp(param[0]), gnp.exp(param[1]), param[2:]
        if y is x or y is None:
            if pairwise:
                return (sigma2 + noise) * gnp.ones((x.shape[0],))
            Dm = gnp.scaled_distance(loginvrho, x, x)
            return sigma2 * gp.kernel.maternp_kernel(2, Dm) + noise * gnp.eye(Dm.shape[0])
        Dm = (gnp.scaled_distance_elementwise if pairwise
              else gnp.scaled_distance)(loginvrho, x, y)
        return sigma2 * gp.kernel.maternp_kernel(2, Dm)

    return kernel


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np(t):
    return t.detach().cpu().numpy().copy()


def mesh_results(mesh, n=N, block=BLOCK, fit=True):
    """Every quantity the tests compare, computed through the port on
    ``mesh`` (a group mesh or the one-card mesh), replicated outputs as
    numpy arrays; the factor and the gram gathered to (n, n)."""
    import torch

    import gpmp_tpu_torch as gp
    import gpmp_tpu_torch.kernel  # noqa: F401
    import gpmp_tpu_torch.num as gnp
    from gpmp_tpu_torch import parallel as par
    from gpmp_tpu_torch.parallel import comm

    group = mesh.is_group
    rows = (lambda a: comm.slab(a, mesh)) if group else (lambda a: a)
    gather = (lambda a: comm.gather_rows(a, mesh)) if group else (lambda a: a)
    xi_np, zi_np, xt_np, p0_np = make_data(n)
    xi, zi, xt, p0 = (torch.as_tensor(a) for a in (xi_np, zi_np, xt_np, p0_np))
    mean = lambda x, p: gnp.ones((x.shape[0], 1))  # noqa: E731
    model = gp.Model(mean, kernel_for(gp, gnp), covparam=p0)
    out = {}

    K = par.sharded_covariance(model, p0, xi, mesh)
    out["K"] = _np(gather(K))
    L = par.sharded_cholesky(K, mesh, block=block)
    out["L"] = _np(gather(L))
    out["L32"] = _np(gather(par.sharded_cholesky(K.to(torch.float32), mesh, block=block,
                                                 panel_impl="direct")))
    B = torch.as_tensor(np.random.default_rng(1).normal(size=(n, 3)))
    y = par.blocked_solve_lower(L, rows(B), block=block, mesh=mesh)
    out["solve_lower"] = _np(gather(y))
    out["solve_upper_t"] = _np(gather(par.blocked_solve_upper_t(L, rows(B), block=block,
                                                                mesh=mesh)))

    p = p0.clone().requires_grad_(True)
    v = par.sharded_negative_log_restricted_likelihood(model, p, xi, zi, mesh, block=block)
    (g,) = torch.autograd.grad(v, p)
    out["reml"], out["reml_grad"] = _np(v), _np(g)
    out["nll0"] = _np(par.sharded_negative_log_likelihood_zero_mean(model, p0, xi, zi, mesh,
                                                                    block=block))
    out["reml_factor"] = _np(par.sharded_negative_log_restricted_likelihood(
        model, p0, xi, zi, mesh, block=block, factor=L))

    zpm, zpv = par.sharded_predict(model, xi, zi, xt, mesh, block=block)
    out["zpm"], out["zpv"] = _np(zpm), _np(zpv)
    xtg = xt.clone().requires_grad_(True)
    zpm_g, _ = par.sharded_predict(model, xi, zi, xtg, mesh, block=block)
    (gx,) = torch.autograd.grad(torch.sum(zpm_g ** 2), xtg)
    out["zpm_grad_xt"] = _np(gx)
    zloo, s2loo, eloo = par.sharded_loo(model, xi, zi, mesh, block=block)
    out["zloo"], out["s2loo"], out["eloo"] = _np(zloo), _np(s2loo), _np(eloo)
    out["lambda"] = _np(par.sharded_kriging_weights(model, xi, xt, mesh, block=block))
    g_paths = torch.Generator().manual_seed(5)
    out["paths"] = _np(par.sharded_sample_paths(model, xt, 4, mesh, block=8,
                                                generator=g_paths))

    Kg = par.sharded_gram(lambda a, b, c: model.covariance(a, b, c), xi, p0, mesh)
    out["gram"] = _np(gather(Kg))
    out["matvec"] = _np(gather(par.sharded_matvec(Kg, B, mesh)))

    if fit:
        fitted, info = gp.kernel.select_parameters_with_reml(
            gp.Model(mean, kernel_for(gp, gnp)), xi_np, zi_np, covparam0=p0_np, mesh=mesh,
            shard_block=block, method="L-BFGS-B", info=True, method_options={"maxiter": 1})
        out["fit_covparam"] = _np(fitted.covparam)
        out["fit_nfev"] = np.asarray(info.nfev)
        view = par.ShardedModelView(fitted, mesh, block=block)
        vm, vv = view.predict(xi_np, zi_np, xt_np)
        out["view_zpm"], out["view_zpv"] = _np(vm), _np(vv)
    return out


def mixed_results(mesh, n=N, block=BLOCK):
    """The REML value and gradient at p0 on the mixed engine through
    ``mesh``, on the series branch and with the series gate shut (the robust
    branch), as numpy arrays."""
    import torch

    import gpmp_tpu_torch as gp
    import gpmp_tpu_torch.kernel  # noqa: F401
    import gpmp_tpu_torch.num as gnp
    from gpmp_tpu_torch import config
    from gpmp_tpu_torch import parallel as par
    from gpmp_tpu_torch.parallel import mixed as pmixed

    xi_np, zi_np, _xt, p0_np = make_data(n)
    xi, zi, p0 = (torch.as_tensor(a) for a in (xi_np, zi_np, p0_np))
    model = gp.Model(lambda x, p: gnp.ones((x.shape[0], 1)), kernel_for(gp, gnp))
    out, prev, tau = {}, config.get_chol_engine(), pmixed._SERIES_TAU
    config.set_chol_engine("mixed")
    try:
        for branch, gate in (("series", tau), ("robust", 0.0)):
            pmixed._SERIES_TAU = gate
            p = p0.clone().requires_grad_(True)
            v = par.sharded_negative_log_restricted_likelihood(model, p, xi, zi, mesh,
                                                               block=block)
            (g,) = torch.autograd.grad(v, p)
            out[f"{branch} reml"], out[f"{branch} grad"] = _np(v), _np(g)
    finally:
        config.set_chol_engine(prev)
        pmixed._SERIES_TAU = tau
    return out


def _run_tasks(world, port, rank, tasks):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        from gpmp_tpu_torch.parallel import make_mesh

        mesh = make_mesh(world, axis_name="shard")
        res = {"rank": rank, "mesh": repr(mesh), "size": mesh.size}
        for name, kwargs in tasks:
            res[name] = (mixed_results(mesh) if name == "mixed"
                         else mesh_results(mesh, **kwargs))
        return res
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, ports, queue, tasks, solo_tasks):
    os.environ["GPMP_DEVICE"] = "cpu"
    import torch

    torch.set_num_threads(1)
    try:
        res = _run_tasks(world, ports[0], rank, tasks)
        if solo_tasks and rank == 0:  # then a group of one, in the same process
            res["solo"] = _run_tasks(1, ports[1], 0, solo_tasks)
        queue.put((rank, res))
    except BaseException:  # noqa: BLE001  (the parent reports it)
        queue.put((rank, traceback.format_exc()))


def run_group(world, tasks, solo_tasks=(), timeout=240):
    """Spawn ``world`` gloo ranks on the CPU, run ``mesh_results(**kwargs)``
    for each (name, kwargs) of ``tasks`` on every rank (``mixed_results``
    for the task named "mixed"), then ``solo_tasks`` on rank 0 alone in a
    1-rank group (its results under "solo"), and return the ranks' result
    dicts in rank order; raise on any rank's failure or past ``timeout``
    seconds (every group has a 60 s collective timeout)."""
    import multiprocessing as mp
    import queue as _queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    ports = (free_port(), free_port())
    procs = [ctx.Process(target=_rank_main, args=(r, world, ports, q, tasks, solo_tasks),
                         daemon=True)
             for r in range(world)]
    for pr in procs:
        pr.start()
    results = {}
    try:
        for _ in range(world):
            rank, res = q.get(timeout=timeout)
            if isinstance(res, str):
                raise RuntimeError(f"rank {rank} failed:\n{res}")
            results[rank] = res
    except _queue.Empty:
        raise RuntimeError(f"the {world}-rank group did not finish in {timeout} s") from None
    finally:
        for pr in procs:
            pr.join(timeout=30)
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=10)
    return [results[r] for r in range(world)]
