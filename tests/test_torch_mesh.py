# tests/test_torch_mesh.py
"""The port's group mesh (gpmp_tpu_torch.parallel on torch.distributed): a
spawned 2-rank gloo group on the CPU, once per module, runs every rank-side
check (tests/_torch_mesh_ranks.py, which imports no JAX) and returns each
rank's results.  They are held against

- gpmp_tpu.parallel on its virtual 2-device mesh (``make_mesh(2,
  axis_name="shard")``, under ``jax.jit``) at n = 256, d = 3, panels of 64:
  L within 1e-12 of max |L| (the f32 direct factor of the mixed engine's
  preconditioner within 1e-5: f32 sums in another order, measured at a few
  eps32 at cond(K) ~ 280); the REML value within 1e-10 and its gradient
  within 1e-8 relative (tests/test_torch_core.py's bars); predict's mean and
  variance and LOO within 1e-8 relative (another factorization order);
- the port's own one-card path (``make_mesh(1)``), the same function in
  another summation order: every quantity within 1e-12 relative to its
  largest entry (the f32 factor within 1e-5), at n = 256 with panels of 64,
  at n = 384 with panels of 128
  (the panel [128, 256) straddles the two ranks), and on a 1-rank gloo
  group (the per-rank algorithm with gathers of one; rank 0 of the same
  spawn, after the 2-rank group);
- each other: every replicated result bitwise equal on both ranks (the
  ranks' SciPy loops must take the same steps).

The mixed branch (the sharded mixed engine on slabs) is held to
gpmp_tpu's on its 2-device mesh (the series branch) and to the port's
one-card branch (both branches) with
tests/test_torch_parallel.py's bars for the one-card branch: the REML value
to 1e-8 and the gradient within the class envelope (rtol 1e-3, atol 1e-6
max|g|), on the series branch and with the series gate shut (the robust
branch): the f32 preconditioners differ (the row-sharded direct factor
against LAPACK's), and so do the engines' own errors.
tests/test_torch_streamed.py holds the dispatcher's refusal to stream on a
group mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpmp_tpu as jgp
import gpmp_tpu.config as jconfig
import gpmp_tpu.num as jgnp
import gpmp_tpu.parallel.mixed as jpmixed
from gpmp_tpu.parallel import make_mesh as jmake_mesh
from gpmp_tpu.parallel.chol import (
    _sharded_cholesky_impl as j_cholesky_impl,
    sharded_cholesky as j_sharded_cholesky,
)
from gpmp_tpu.parallel.likelihood import (
    sharded_covariance as j_sharded_covariance,
    sharded_negative_log_restricted_likelihood as j_sharded_reml,
)
from gpmp_tpu.parallel.loo import sharded_loo as j_sharded_loo
from gpmp_tpu.parallel.predict import sharded_predict as j_sharded_predict

import _torch_mesh_ranks as ranks
from gpmp_tpu_torch import config
from gpmp_tpu_torch.parallel import make_mesh

ONE_CARD_KEYS = ["K", "L", "solve_lower", "solve_upper_t", "reml", "reml_grad", "nll0",
                 "reml_factor", "zpm", "zpv", "zpm_grad_xt", "zloo", "s2loo", "eloo", "lambda",
                 "paths", "gram", "matvec", "fit_covparam", "view_zpm", "view_zpv"]
STRADDLE_KEYS = [k for k in ONE_CARD_KEYS if not k.startswith(("fit", "view"))]


@pytest.fixture(autouse=True)
def _on_the_cpu():
    config.set_device("cpu")
    torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def group2():
    """Both ranks' results of a 2-rank gloo group: n = 256 / panels of 64
    (with a 1-iteration fit and the view), n = 384 / panels of 128, and the
    mixed branch; then rank 0's as a 1-rank group (under "solo")."""
    return ranks.run_group(2, [
        ("main", {}),
        ("straddle", {"n": ranks.N_STRADDLE, "block": ranks.BLOCK_STRADDLE, "fit": False}),
        ("mixed", {}),
    ], solo_tasks=[("main", {"fit": False}), ("mixed", {})])


@pytest.fixture(scope="module")
def group1(group2):
    """A 1-rank gloo group's results at n = 256, panels of 64."""
    return group2[0]["solo"]


@pytest.fixture(scope="module")
def one_card():
    config.set_device("cpu")
    torch.set_num_threads(2)
    mesh = make_mesh(1, axis_name="shard")
    return {"main": ranks.mesh_results(mesh),
            "straddle": ranks.mesh_results(mesh, n=ranks.N_STRADDLE,
                                           block=ranks.BLOCK_STRADDLE, fit=False),
            "mixed": ranks.mixed_results(mesh)}


@pytest.fixture(scope="module")
def jax_ref():
    """gpmp_tpu.parallel on a 2-device virtual mesh, under jax.jit."""
    xi, zi, xt, p0 = ranks.make_data()
    jmesh = jmake_mesh(2, axis_name="shard")
    model = jgp.Model(lambda x, p: jgnp.ones((x.shape[0], 1)),
                      ranks.kernel_for(jgp, jgnp), covparam=jnp.asarray(p0))
    xi_, zi_, xt_ = jnp.asarray(xi), jnp.asarray(zi), jnp.asarray(xt)
    K = jax.jit(lambda p: j_sharded_covariance(model, p, xi_, jmesh))(jnp.asarray(p0))
    L = jax.jit(lambda K: j_sharded_cholesky(K, jmesh, block=ranks.BLOCK))(K)
    L32 = jax.jit(lambda K: j_cholesky_impl(K.astype(jnp.float32), jmesh, "shard",
                                            ranks.BLOCK, "direct"))(K)
    v, g = jax.jit(jax.value_and_grad(lambda p: j_sharded_reml(
        model, p, xi_, zi_, jmesh, block=ranks.BLOCK)))(jnp.asarray(p0))
    zpm, zpv = jax.jit(lambda a, b, c: j_sharded_predict(
        model, a, b, c, jmesh, block=ranks.BLOCK))(xi_, zi_, xt_)
    zloo, s2loo, eloo = jax.jit(lambda a, b: j_sharded_loo(
        model, a, b, jmesh, block=ranks.BLOCK))(xi_, zi_)
    out = {k: np.asarray(a) for k, a in dict(
        L=L, L32=L32, reml=v, reml_grad=g, zpm=zpm, zpv=zpv, zloo=zloo, s2loo=s2loo, eloo=eloo).items()}
    prev, tau = jconfig.get_chol_engine(), jpmixed._SERIES_TAU
    jconfig.set_chol_engine("mixed")
    try:
        for branch, gate in (("series", tau),):
            jpmixed._SERIES_TAU = gate
            vm, gm = jax.jit(jax.value_and_grad(lambda p: j_sharded_reml(
                model, p, xi_, zi_, jmesh, block=ranks.BLOCK)))(jnp.asarray(p0))
            out[f"{branch} reml"], out[f"{branch} grad"] = np.asarray(vm), np.asarray(gm)
    finally:
        jconfig.set_chol_engine(prev)
        jpmixed._SERIES_TAU = tau
    return out


# ---------------------------------------------------------------------------
# against gpmp_tpu on its 2-device mesh
# ---------------------------------------------------------------------------
def test_group_factor_matches_jax(group2, jax_ref):
    L = group2[0]["main"]["L"]
    assert np.max(np.abs(L - jax_ref["L"])) <= 1e-12 * np.max(np.abs(jax_ref["L"]))
    assert np.all(np.triu(L, 1) == 0.0)


def test_group_f32_direct_factor_matches_jax(group2, jax_ref):
    L32 = group2[0]["main"]["L32"]
    assert L32.dtype == np.float32 and np.all(np.triu(L32, 1) == 0.0)
    assert _rel(L32, jax_ref["L32"]) <= 1e-5


def test_group_reml_matches_jax(group2, jax_ref):
    r = group2[0]["main"]
    assert abs(float(r["reml"]) - float(jax_ref["reml"])) <= 1e-10 * abs(float(jax_ref["reml"]))
    assert _rel(r["reml_grad"], jax_ref["reml_grad"]) <= 1e-8


@pytest.mark.parametrize("key", ["zpm", "zpv", "zloo", "s2loo", "eloo"])
def test_group_predict_and_loo_match_jax(group2, jax_ref, key):
    assert _rel(group2[0]["main"][key], jax_ref[key]) <= 1e-8


# ---------------------------------------------------------------------------
# against the port's one-card path, and across ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", ONE_CARD_KEYS)
def test_two_rank_group_matches_one_card(group2, one_card, key):
    assert _rel(group2[0]["main"][key], one_card["main"][key]) <= 1e-12


@pytest.mark.parametrize("key", STRADDLE_KEYS)
def test_straddling_panels_match_one_card(group2, one_card, key):
    assert _rel(group2[1]["straddle"][key], one_card["straddle"][key]) <= 1e-12


@pytest.mark.parametrize("key", STRADDLE_KEYS)
def test_one_rank_group_matches_one_card(group1, one_card, key):
    assert _rel(group1["main"][key], one_card["main"][key]) <= 1e-12


@pytest.mark.parametrize("case", ["two ranks", "straddling", "one rank"])
def test_group_f32_direct_factor_matches_one_card(group2, group1, one_card, case):
    got, want = {"two ranks": (group2[0]["main"], one_card["main"]),
                 "straddling": (group2[0]["straddle"], one_card["straddle"]),
                 "one rank": (group1["main"], one_card["main"])}[case]
    assert _rel(got["L32"], want["L32"]) <= 1e-5


def _mixed_close(got, want, branch):
    v, vw = float(got[f"{branch} reml"]), float(want[f"{branch} reml"])
    assert abs(v - vw) <= 1e-8 * abs(vw)
    gw = want[f"{branch} grad"]
    np.testing.assert_allclose(got[f"{branch} grad"], gw, rtol=1e-3,
                               atol=1e-6 * np.max(np.abs(gw)))


@pytest.mark.parametrize("branch", ["series"])
def test_group_mixed_branch_matches_jax(group2, jax_ref, branch):
    _mixed_close(group2[0]["mixed"], jax_ref, branch)


@pytest.mark.parametrize("case", ["two ranks series", "two ranks robust", "one rank series",
                                  "one rank robust"])
def test_group_mixed_branch_matches_one_card(group2, group1, one_card, case):
    got = group2[0]["mixed"] if case.startswith("two") else group1["mixed"]
    _mixed_close(got, one_card["mixed"], case.rsplit(" ", 1)[1])


def test_ranks_agree_bitwise(group2):
    r0, r1 = group2
    assert (r0["size"], r1["size"]) == (2, 2) and "rank=1" in r1["mesh"]
    for task in ("main", "straddle", "mixed"):
        for key in r0[task]:
            np.testing.assert_array_equal(r0[task][key], r1[task][key], err_msg=f"{task}/{key}")
    assert int(r0["main"]["fit_nfev"]) >= 2


def test_make_mesh_without_a_group_raises():
    assert make_mesh().size == 1 and not make_mesh(1).is_group
    with pytest.raises(RuntimeError, match="start 2 processes"):
        make_mesh(2)
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(0)
