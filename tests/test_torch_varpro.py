"""The port's batched variable projection against muse_tpu's, on the same
numpy inputs, and the lensing model's two-phase MAP (VarPro, then the
Newton-CG polish) built on it.

Tolerances:
  * whole solves at weak lensing (θ = −1), where the 16² objective has one
    basin: final f within 1e-5 relative, both packages under ``g_atol``,
    outer iterations within ±2, with the explicit operator pair and with
    the AD pair;
  * strong lensing (θ = 0.5) has several basins and float32 rounding
    decides which one a cold-started lane falls into, in either package:
    there the test holds that every lane converges and that the summed
    objective is no worse than muse_tpu's by more than 2%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muse_tpu.ops.varpro as jvp
from muse_tpu.models.lensing import lensing_problem as j_lensing
from muse_tpu_torch.models.lensing import lensing_problem as t_lensing
from muse_tpu_torch.models.lensing import zhat_varpro_counts
from muse_tpu_torch.ops import newton_cg as tnc
from muse_tpu_torch.ops import varpro as tvp

torch.set_num_threads(1)

CPU = "cpu"
N = 16
N2 = N * N
B = 4


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------------ #
# toy problems (muse_tpu's own oracles, tests/test_newton_varpro.py)
# ------------------------------------------------------------------ #

def test_linear_case_is_wiener():
    """obs = z (identity G, nothing depends on u): the solution is the
    ridge/Wiener estimate z = x/(1+σ²), and u_nl stays at 0."""
    s2 = 0.25
    xs = _t(np.random.default_rng(1).standard_normal((3, 32))
            .astype(np.float32))
    res = tvp.batched_varpro(lambda U, Z: Z, xs,
                             torch.zeros((3, 4)), torch.zeros((3, 32)),
                             sigma2=s2, g_atol=1e-6)
    assert res.converged.all()
    torch.testing.assert_close(res.z_lin, xs / (1 + s2), rtol=0, atol=1e-5)
    torch.testing.assert_close(res.u_nl, torch.zeros((3, 4)), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("explicit", [False, True])
def test_separable_bilinear_matches_jax(explicit):
    """obs = (1 + tanh u)·z: jointly nonconvex, separable. The same xs
    through both packages, with the AD pair and with an explicit (G, Gᵀ):
    the full-space gradient meets the tolerance, f agrees to 1e-5 and the
    outer iteration counts to ±2."""
    s2, n = 0.1, 16
    xs = (2.0 * np.random.default_rng(2).standard_normal((B, n))
          ).astype(np.float32)

    def lin_j(U):
        s = 1.0 + jnp.tanh(U)
        return (lambda Z: s * Z), (lambda W: s * W)

    def lin_t(U):
        s = 1.0 + torch.tanh(U)
        return (lambda Z: s * Z), (lambda W: s * W)

    kw = dict(sigma2=s2, g_atol=1e-4, max_outer=300)
    rj = jvp.batched_varpro(lambda U, Z: (1.0 + jnp.tanh(U)) * Z,
                            jnp.asarray(xs), jnp.zeros((B, n)),
                            jnp.zeros((B, n)),
                            lin_ops=lin_j if explicit else None, **kw)
    rt = tvp.batched_varpro(lambda U, Z: (1.0 + torch.tanh(U)) * Z, _t(xs),
                            torch.zeros((B, n)), torch.zeros((B, n)),
                            lin_ops=lin_t if explicit else None, **kw)
    assert rt.converged.all() and bool(rj.converged.all())
    assert not rt.failed.any()
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), rtol=1e-5)
    assert np.abs(rt.iterations.numpy()
                  - np.asarray(rj.iterations)).max() <= 2

    def nll(u, z, x):
        r = x - (1.0 + torch.tanh(u)) * z
        return 0.5 * ((r * r).sum() / s2 + (u * u).sum() + (z * z).sum())
    g_u, g_z = torch.func.vmap(torch.func.grad(nll, argnums=(0, 1)))(
        rt.u_nl, rt.z_lin, _t(xs))
    assert float(g_u.abs().max()) < 1e-4 and float(g_z.abs().max()) < 1e-4
    torch.testing.assert_close(rt.g_norm, torch.maximum(
        g_u.abs().amax(-1), g_z.abs().amax(-1)), rtol=0, atol=2e-5)


# ------------------------------------------------------------------ #
# batched_varpro on the 16² lensing operator
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module")
def lensing16():
    """muse_tpu's and the port's 16² lensing problems on the same data;
    observations of 4 lanes drawn by muse_tpu at θ = −1, 0 and 0.5; and what
    muse_tpu's zhat_varpro hands to its batched_varpro at θ = −1."""
    pj = j_lensing(N, solver="varpro", data_key=jax.random.PRNGKey(1))
    pt = t_lensing(N, solver="varpro", x_obs=np.asarray(pj.x), device=CPU)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    xs = {th: np.asarray(jax.vmap(pj.sample_x_z, in_axes=(0, None))(
        keys, jnp.float32(th))[0]) for th in (-1.0, 0.0, 0.5)}
    captured = {}
    orig = jvp.batched_varpro

    def spy(obs_op, xs_, U0, Z0, **kw):
        captured.update(obs_op=obs_op, kw=kw)
        return orig(obs_op, xs_, U0, Z0, **kw)

    jvp.batched_varpro = spy
    try:
        full_j = pj.custom_zhat(jnp.asarray(xs[-1.0]),
                                jnp.zeros((B, 2 * N2), jnp.float32),
                                jnp.asarray([-1.0], jnp.float32), 1e-2)
    finally:
        jvp.batched_varpro = orig
    return {"pj": pj, "pt": pt, "xs": xs, "jax": captured, "full_j": full_j}


@pytest.mark.parametrize("explicit", [True, False])
def test_batched_varpro_on_lensing_matches_jax(lensing16, explicit):
    """The same xs and (U0, Z̃0) = 0 through muse_tpu's batched_varpro (on
    the operators its lensing model hands over) and the port's, with and
    without ``lin_ops``."""
    xs = lensing16["xs"][-1.0]
    kw = dict(lensing16["jax"]["kw"])
    if not explicit:
        kw["lin_ops"] = None
    L = 2 * N * (N // 2 + 1)
    rj = jvp.batched_varpro(lensing16["jax"]["obs_op"], jnp.asarray(xs),
                            jnp.zeros((B, N2)), jnp.zeros((B, L)), **kw)
    ops = lensing16["pt"].varpro_ops(torch.tensor([-1.0]))
    rt = tvp.batched_varpro(
        ops["obs_op"], _t(xs), torch.zeros((B, N2)), torch.zeros((B, L)),
        sigma2=kw["sigma2"], g_atol=1e-2, max_outer=kw["max_outer"],
        inner_maxiter=kw["inner_maxiter"], max_ls=kw["max_ls"], m=kw["m"],
        precond_lin=ops["precond_lin"], lin_sup=ops["lin_sup"],
        lin_ops=ops["lin_ops"] if explicit else None)
    assert rt.converged.all() and bool(rj.converged.all())
    assert float(rt.g_norm.max()) < 1e-2 and float(rj.g_norm.max()) < 1e-2
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f), rtol=1e-5)
    assert np.abs(rt.iterations.numpy()
                  - np.asarray(rj.iterations)).max() <= 2
    Uj = np.asarray(rj.u_nl)
    np.testing.assert_allclose(rt.u_nl.numpy(), Uj, rtol=0,
                               atol=1e-3 * np.abs(Uj).max())


def test_zhat_varpro_matches_jax_at_weak_lensing(lensing16):
    """The whole two-phase MAP: Z within 1e-4·max|Z|, the same flags and
    iteration counts, the true-gradient certificate under the tolerance,
    and no polish (VarPro left no lane)."""
    pt = lensing16["pt"]
    Zj, aj = lensing16["full_j"]
    before = zhat_varpro_counts.polish_entries
    Zt, at = pt.custom_zhat(_t(lensing16["xs"][-1.0]),
                            torch.zeros((B, 2 * N2)), torch.tensor([-1.0]),
                            1e-2)
    assert zhat_varpro_counts.polish_entries == before
    Zj = np.asarray(Zj)
    np.testing.assert_allclose(Zt.numpy(), Zj, rtol=0,
                               atol=1e-4 * np.abs(Zj).max())
    for k in ("converged", "failed", "iterations", "cg_iterations"):
        np.testing.assert_array_equal(at[k].numpy(), np.asarray(aj[k]), k)
    np.testing.assert_allclose(at["neg_logp"].numpy(),
                               np.asarray(aj["neg_logp"]), rtol=1e-5)
    np.testing.assert_allclose(at["g_norm"].numpy(), np.asarray(aj["g_norm"]),
                               rtol=0, atol=1e-3)
    # the certificate is the true joint gradient
    _, g = pt.value_and_grad(_t(lensing16["xs"][-1.0]),
                             torch.tensor([-1.0]))(Zt)
    torch.testing.assert_close(at["g_norm"], g.abs().amax(-1))
    assert float(at["g_norm"].max()) < 1e-2


def test_zhat_varpro_at_strong_lensing(lensing16):
    """θ = 0.5: every lane ends converged (VarPro, then the polish for the
    lanes it left), and the summed objective is within 2% of muse_tpu's."""
    pj, pt = lensing16["pj"], lensing16["pt"]
    xs = lensing16["xs"][0.5]
    _, aj = pj.custom_zhat(jnp.asarray(xs), jnp.zeros((B, 2 * N2), jnp.float32),
                           jnp.asarray([0.5], jnp.float32), 1e-2)
    Zt, at = pt.custom_zhat(_t(xs), torch.zeros((B, 2 * N2)),
                            torch.tensor([0.5]), 1e-2)
    assert at["converged"].all() and not at["failed"].any()
    _, g = pt.value_and_grad(_t(xs), torch.tensor([0.5]))(Zt)
    assert float(g.abs().max()) < 1e-2
    fj, ft = float(np.asarray(aj["neg_logp"]).sum()), float(
        at["neg_logp"].sum())
    assert ft <= 1.02 * fj, (ft, fj)


def test_polish_runs_only_when_varpro_leaves_a_lane(lensing16):
    """With VarPro cut to 2 outer iterations every lane is left open: the
    polish is entered once and finishes them by Newton-CG."""
    pt2 = t_lensing(N, solver="varpro", x_obs=lensing16["pt"].x.numpy(),
                    gn_max_outer=2, device=CPU)
    calls = tnc.batched_newton_cg.iterations
    entries = zhat_varpro_counts.polish_entries
    Zt, at = pt2.custom_zhat(_t(lensing16["xs"][-1.0]),
                             torch.zeros((B, 2 * N2)), torch.tensor([-1.0]),
                             1e-2)
    assert zhat_varpro_counts.polish_entries == entries + 1
    assert tnc.batched_newton_cg.iterations > calls
    assert at["converged"].all()
    assert int(at["iterations"].min()) > 2


def test_warm_start_cuts_iterations(lensing16):
    """A re-solve from the solution (the muse loop's steady state) takes
    far fewer reduced iterations than the cold start."""
    pt = lensing16["pt"]
    xs, th = _t(lensing16["xs"][0.0]), torch.tensor([0.0])
    Z1, a1 = pt.custom_zhat(xs, torch.zeros((B, 2 * N2)), th, 1e-2)
    Z2, a2 = pt.custom_zhat(xs, Z1, th, 1e-2)
    assert a2["converged"].all()
    assert int(a2["iterations"].max()) <= max(
        2, int(a1["iterations"].max()) // 5)


def test_every_loop_reads_its_flag_before_each_step(lensing16):
    """The three loops read all(done) before every step, as the JAX loops
    test: one read per outer iteration and its closing read, per trial and
    its closing read, per inner step and the closing read of each of the
    trials + 1 inner solves; a rerun is bitwise equal."""
    ops = lensing16["pt"].varpro_ops(torch.tensor([-1.0]))
    L = 2 * N * (N // 2 + 1)
    args = (ops["obs_op"], _t(lensing16["xs"][-1.0]), torch.zeros((B, N2)),
            torch.zeros((B, L)))
    kw = dict(sigma2=0.04, precond_lin=ops["precond_lin"],
              lin_sup=ops["lin_sup"], lin_ops=ops["lin_ops"])
    ref = tvp.batched_varpro(*args, **kw)
    c = tvp.batched_varpro
    before = (c.iterations, c.ls_trials, c.inner_steps, c.host_syncs)
    res = c(*args, **kw)
    for x, y in zip(res, ref):
        assert torch.equal(x, y)
    outer, trials, inner, syncs = (now - was for now, was in zip(
        (c.iterations, c.ls_trials, c.inner_steps, c.host_syncs), before))
    assert outer == int(res.iterations.max()) > 0
    assert trials >= outer
    assert syncs == (outer + 1) + (trials + outer) + (inner + trials + 1)
