# tests/test_torch_mcmc_checkpoint.py
"""The port's sampler checkpoints (gpmp_tpu_torch.mcmc.checkpoint), the
counterparts of tests/test_checkpoint.py, on the CPU.

Resume is exact: a run interrupted at a checkpoint and resumed from it
reproduces the uninterrupted run bit for bit (the state holds the
generator's state and all adaptation state).  The JAX package's dispatch
options change no trajectory in the port: its draws come step by step from
one generator, so grouping steps into blocks, dispatches or scans does not
move them.  A gpmp_tpu checkpoint is refused with an error that names the
way across (interop.mh_state_from_numpy)."""

import contextlib
import io
import shutil

import numpy as np
import pytest
import torch

from gpmp_tpu_torch import config
from gpmp_tpu_torch.mcmc import MetropolisHastings, MHOptions, nuts_resume, nuts_sample
from gpmp_tpu_torch.mcmc import nuts as nuts_mod
from gpmp_tpu_torch.mcmc.checkpoint import load_sampler_checkpoint, save_sampler_checkpoint
from gpmp_tpu_torch.mcmc.nuts import NUTSOptions


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port computes on the card unless told otherwise: these tests ask
    for the CPU.  torch keeps to few threads beside the suite's other
    workers."""
    config.set_device("cpu")
    torch.set_num_threads(2)


def _log_target(x):
    return -0.5 * ((x[0] + 1.0) ** 2 / 0.5 + (x[1] - 2.0) ** 2 / 2.0)


def _options(tmp_path=None, every=1, **kw):
    kw = dict(dim=2, n_chains=2, seed=123, adaptation_interval=20,
              init_msg=None, show_global_progress=False, **kw)
    if tmp_path is not None:
        kw.update(checkpoint_path=str(tmp_path / "mh.npz"), checkpoint_every=every)
    return MHOptions(**kw)


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def _run(mh, *args):
    return _quiet(mh.scheduler, *args).numpy()


def test_checkpoint_roundtrip(tmp_path):
    path = tmp_path / "raw.npz"
    arrays = {"a": np.arange(6.0).reshape(2, 3), "b": np.uint32([1, 2]),
              "t": torch.arange(3.0), "skip": None}
    meta = {"kind": "test", "n": 5, "mode": "x", "f": np.float64(0.5)}
    save_sampler_checkpoint(path, arrays, meta)
    arrays2, meta2 = load_sampler_checkpoint(path)
    np.testing.assert_array_equal(arrays2["a"], arrays["a"])
    np.testing.assert_array_equal(arrays2["b"], arrays["b"])
    np.testing.assert_array_equal(arrays2["t"], [0.0, 1.0, 2.0])
    assert "skip" not in arrays2
    assert meta2["kind"] == "test" and meta2["n"] == 5 and meta2["f"] == 0.5
    assert meta2["format"] == "gpmp_tpu_torch.sampler_checkpoint"
    assert not (tmp_path / "raw.npz.tmp").exists()


def test_mh_resume_is_exact(tmp_path):
    x0 = np.zeros(2)
    n_total, burnin = 300, 120
    out_ref = _run(MetropolisHastings(_log_target, options=_options()), x0, n_total, burnin)

    mh_a = MetropolisHastings(_log_target, options=_options(tmp_path))
    stashed = []
    orig_save = mh_a.save_checkpoint

    def stashing_save(path):
        p = tmp_path / f"block_{len(stashed)}.npz"
        orig_save(str(p))
        stashed.append(p)

    mh_a.save_checkpoint = stashing_save
    out_a = _run(mh_a, x0, n_total, burnin)
    np.testing.assert_array_equal(out_a, out_ref)
    assert len(stashed) >= 4

    for mid in (stashed[1], stashed[len(stashed) // 2], stashed[-2]):
        mh_b = MetropolisHastings(_log_target, options=_options())
        mh_b.restore_checkpoint(str(mid))
        assert 0 < mh_b.global_iter < n_total
        out_b = _quiet(mh_b.continue_run).numpy()
        np.testing.assert_array_equal(out_b, out_ref)
        np.testing.assert_array_equal(mh_b.accept, mh_a.accept)
        np.testing.assert_array_equal(mh_b.log_target_values, mh_a.log_target_values)


def test_mh_restore_shape_mismatch(tmp_path):
    mh_a = MetropolisHastings(_log_target, options=_options())
    _run(mh_a, np.zeros(2), 60, 20)
    p = tmp_path / "state.npz"
    mh_a.save_checkpoint(str(p))
    bad = MetropolisHastings(lambda x: -0.5 * x[0] ** 2,
                             options=MHOptions(dim=1, n_chains=2, init_msg=None))
    with pytest.raises(ValueError, match="shape mismatch"):
        bad.restore_checkpoint(str(p))


def test_nuts_resume_is_exact(tmp_path):
    """NUTS sampling interrupted at a checkpoint and resumed is bitwise the
    checkpointed run and the plain run."""
    def log_prob(q):
        return -0.5 * torch.sum(q**2 / torch.tensor([0.5, 2.0], dtype=q.dtype))

    q0 = np.zeros((2, 2))
    common = dict(num_warmup=60, seed=11, verbose=0, progress=False)
    s_ref, info_ref = nuts_sample(log_prob, q0, 120, options=NUTSOptions(**common))

    path = tmp_path / "nuts.npz"
    stash = []
    orig_factory = nuts_mod._make_nuts_saver

    def stashing_factory(p, *args):
        inner = orig_factory(p, *args)

        def save_fn(q, t_done):
            inner(q, t_done)
            sp = tmp_path / f"nuts_{t_done}.npz"
            shutil.copy(p, sp)
            stash.append((t_done, sp))

        return save_fn

    nuts_mod._make_nuts_saver = stashing_factory
    try:
        s_a, info_a = nuts_sample(log_prob, q0, 120, options=NUTSOptions(
            checkpoint_path=str(path), checkpoint_every=40, **common))
    finally:
        nuts_mod._make_nuts_saver = orig_factory
    np.testing.assert_array_equal(s_a.numpy(), s_ref.numpy())
    assert [t for t, _ in stash] == [40, 80, 120]

    for t_mid, p_mid in stash[:2]:
        s_b, info_b = nuts_resume(log_prob, str(p_mid), verbose=0)
        np.testing.assert_array_equal(s_b.numpy(), s_ref.numpy())
        for key in ("accept_stat", "n_leapfrog", "tree_depth", "divergent", "log_prob_trace",
                    "warmup_step_size", "warmup_accept_stat"):
            np.testing.assert_array_equal(info_b[key], info_ref[key])
        assert info_b["step_size_final"] == info_ref["step_size_final"]
        assert info_b["accept_stat"].shape == (120, 2)
    with pytest.raises(ValueError, match="Not a NUTS"):
        mh = MetropolisHastings(_log_target, options=_options())
        _run(mh, np.zeros(2), 40, 20)
        mh.save_checkpoint(str(tmp_path / "mh.npz"))
        nuts_resume(log_prob, str(tmp_path / "mh.npz"))


def _mh_run(method="Haario", n_chains=4, n_total=6000, burnin=2000, **kw):
    o = MHOptions(dim=2, n_chains=n_chains, seed=5, adaptation_interval=25, init_msg=None,
                  adaptation_method=method, **kw)
    mh = MetropolisHastings(_log_target, options=o)
    return mh, _run(mh, np.zeros(2), n_total, burnin)


def test_mh_blocks_per_dispatch_equivalent():
    """blocks_per_dispatch moves no draw (tests/test_checkpoint.py's
    counterpart, its budget): with the burn-in's checks after every block
    (burnin_in_graph) K = 8 is bitwise K = 1, and both recover the
    target."""
    mh1, s1 = _mh_run()
    mh8, s8 = _mh_run(blocks_per_dispatch=8)
    np.testing.assert_array_equal(s8, s1)
    assert mh8.burnin_period == mh1.burnin_period
    post = s8[:, mh8.burnin_period:, :].reshape(-1, 2)
    np.testing.assert_allclose(post.mean(axis=0), [-1.0, 2.0], atol=0.4)
    np.testing.assert_allclose(post.var(axis=0), [0.5, 2.0], rtol=0.8)


def test_mh_checks_every_k_blocks():
    """Without burnin_in_graph the burn-in's checks fire every K blocks:
    the run is bitwise K = 1's up to the first check where K = 1 stops,
    and stops no earlier, on a multiple of K blocks or at the budget."""
    kw = dict(n_chains=4, n_total=3000, burnin=1500, burnin_in_graph=False)
    mh1, s1 = _mh_run(**kw)
    mh3, s3 = _mh_run(blocks_per_dispatch=3, **kw)
    assert mh1.burnin_period < 1500  # K = 1 stops early here
    assert mh3.burnin_period >= mh1.burnin_period
    assert mh3.burnin_period == 1500 or mh3.burnin_period % (3 * 25) == 0
    b = mh1.burnin_period + 1
    np.testing.assert_array_equal(s3[:, :b], s1[:, :b])


def test_mh_rm_blocks_and_adaptive_sampling_equivalent():
    """The RM blocks and the adaptive sampling phase (freeze_adaptation
    False) grouped K at a time, and a frozen phase cut at
    max_steps_per_dispatch: bitwise the one-at-a-time run."""
    for kw in (dict(method="RM"), dict(freeze_adaptation=False), {}):
        _mh, s1 = _mh_run(n_chains=2, n_total=1500, burnin=500, **kw)
        _mh, s3 = _mh_run(n_chains=2, n_total=1500, burnin=500, blocks_per_dispatch=3,
                          max_steps_per_dispatch=100, **kw)
        np.testing.assert_array_equal(s3, s1)


def test_mh_burnin_in_graph_matches_host_loop():
    """burnin_in_graph (checks every block) and the host loop at
    blocks_per_dispatch = 1 are one trajectory, stopping on a block
    boundary within the budget."""
    def run(in_graph):
        options = MHOptions(dim=2, n_chains=4, n_pool=2, adaptation_method="Haario",
                            adaptation_interval=50, init_msg=None, seed=3,
                            burnin_in_graph=in_graph)
        mh = MetropolisHastings(_log_target, options=options)
        _run(mh, np.zeros(2), 3000, 1200)
        return mh

    mh_g, mh_h = run(True), run(False)
    np.testing.assert_array_equal(mh_g.x, mh_h.x)
    np.testing.assert_array_equal(mh_g.accept, mh_h.accept)
    assert mh_g.burnin_period == mh_h.burnin_period
    assert mh_g.burnin_period % 50 == 0 and mh_g.burnin_period <= 1200
    post = mh_g.x[:, mh_g.burnin_period:mh_g.global_iter, :].reshape(-1, 2)
    np.testing.assert_allclose(post.mean(axis=0), [-1.0, 2.0], atol=0.3)


def test_nuts_dispatch_options_change_nothing():
    """scan_sampling, scan_warmup, fused and vmap_chains select gpmp_tpu's
    device programs; in the port the samples are bitwise the same."""
    def log_prob(q):
        return -0.5 * torch.sum((q - 1.0) ** 2)

    common = dict(num_warmup=40, seed=2, verbose=0, progress=False)
    ref, _ = nuts_sample(log_prob, np.zeros((2, 2)), 30, options=NUTSOptions(**common))
    for kw in (dict(scan_sampling=True), dict(scan_warmup=True, scan_warmup_chunk=7),
               dict(fused=True), dict(fused=False, vmap_chains=False)):
        s, _ = nuts_sample(log_prob, np.zeros((2, 2)), 30, options=NUTSOptions(**common, **kw))
        np.testing.assert_array_equal(s.numpy(), ref.numpy())


def test_jax_checkpoint_refused(tmp_path):
    """A gpmp_tpu checkpoint (its own meta key, a JAX key in its state)
    raises a clear error; set_state refuses a state without a generator."""
    import gpmp_tpu.mcmc as jmcmc

    jm = jmcmc.MetropolisHastings(lambda x: -0.5 * (x**2).sum(), options=jmcmc.MHOptions(
        dim=2, n_chains=2, seed=0, init_msg=None))
    _quiet(jm.scheduler, np.zeros(2), 60, 20)
    p = tmp_path / "jax_mh.npz"
    jm.save_checkpoint(str(p))
    mh = MetropolisHastings(_log_target, options=_options())
    with pytest.raises(ValueError, match="gpmp_tpu .JAX package. checkpoint"):
        mh.restore_checkpoint(str(p))
    with pytest.raises(ValueError, match="interop.mh_state_from_numpy"):
        load_sampler_checkpoint(str(p))
    arrays, meta = jm.get_state()
    with pytest.raises(ValueError, match="generator_state"):
        mh.set_state({k: np.asarray(v) for k, v in arrays.items()}, meta)
    np.savez(tmp_path / "other.npz", a=np.zeros(2))
    with pytest.raises(ValueError, match="not a gpmp_tpu_torch sampler checkpoint"):
        load_sampler_checkpoint(str(tmp_path / "other.npz"))
