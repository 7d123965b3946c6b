"""The bandpower model of the port (a vector θ, one log-amplitude per
|k|-annulus) against muse_tpu's, on the same numpy inputs.

n = 16 with 4 bands and σ_noise = 0.1, so that every band carries signal.
Tolerances:

  * the band edges are equal (both decide membership in numpy float64);
  * rtol 1e-5 (of the largest entry) for the sampler completion, the
    density, the per-band score and the MAPs; the band reduction within
    1e-5 relative of a float64 sum, and bitwise equal on a rerun;
  * rtol 1e-3 for implicit H (float32 HVPs solved by CG to 1e-6);
  * a whole fit on muse_tpu's whites: per-lane scores within 1e-4, θ̂ within
    1e-3; against the decoupled closed-form MLE: statistical bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muse_tpu.models.bandpower as jb
import muse_tpu_torch
from muse_tpu.solver.compiled import CompiledProblem as JCompiled
from muse_tpu.theta import ThetaSpec as JSpec
from muse_tpu_torch import check_self_consistency, convert
from muse_tpu_torch.models import bandpower as tb
from muse_tpu_torch.ops.cg import batched_cg
from muse_tpu_torch.solver.compiled import CompiledProblem as TCompiled
from muse_tpu_torch.theta import ThetaSpec as TSpec
from torch_parity import assert_fits_agree, fits_on_jax_whites

torch.set_num_threads(1)

CPU = "cpu"
N, NB, SIGMA = 16, 4, 0.1
L = 2 * N * (N // 2 + 1)
TH = np.array([0.1, -0.2, 0.3, 0.0], np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _pair(solver="cg"):
    pj = jb.bandpower_problem(N, NB, sigma_noise=SIGMA, solver=solver,
                              data_key=jax.random.PRNGKey(3))
    pt = tb.bandpower_problem(N, NB, sigma_noise=SIGMA, solver=solver,
                              x_obs=np.asarray(pj.x), device=CPU)
    return pj, pt


def _packed(k, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, L)).astype(np.float32)


@pytest.mark.parametrize("n,nbands", [(16, 4), (32, 8), (33, 5), (64, 12)])
def test_band_edges_equal_jax(n, nbands):
    np.testing.assert_array_equal(tb.band_edges(n, nbands),
                                  jb.band_edges(n, nbands))
    np.testing.assert_array_equal(tb._k_grid64(n), jb._k_grid64(n))


def test_too_many_bands_raise():
    with pytest.raises(ValueError, match="too few distinct"):
        tb.band_edges(4, 40)


def test_problem_attributes_and_packed_data():
    pj, pt = _pair()
    assert pt.nbands == NB
    np.testing.assert_array_equal(pt.band_edges, pj.band_edges)
    np.testing.assert_allclose(pt.x_real, pj.x_real, atol=1e-6)
    # a pixel map is packed on the host, as muse_tpu packs it
    from_map = tb.bandpower_problem(N, NB, sigma_noise=SIGMA,
                                    x_obs=pj.x_real, device=CPU)
    torch.testing.assert_close(from_map.x, pt.x, rtol=0, atol=1e-6)


def test_model_functions_match_jax():
    pj, pt = _pair()
    ut, et, xt = _packed(3)
    xj, zj = pj.x_of_white((jnp.asarray(ut), jnp.asarray(et)),
                           jnp.asarray(TH))
    x, z = pt.x_of_white((_t(ut), _t(et)), _t(TH))
    _close(x, xj)
    assert torch.equal(z, _t(ut))
    lj = float(pj.log_like(jnp.asarray(xt), jnp.asarray(ut), jnp.asarray(TH)))
    lt = float(pt.log_like(_t(xt), _t(ut), _t(TH)))
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    _close(pt.grad_theta_log_like(_t(xt), _t(ut), _t(TH)),
           pj.grad_theta_log_like(jnp.asarray(xt), jnp.asarray(ut),
                                  jnp.asarray(TH)))
    assert abs(float(pt.log_prior(_t(TH))) - float(pj.log_prior(TH))) < 1e-6
    _close(pt.suggested_h_precond(_t(xt), None, _t(TH)),
           pj.suggested_h_precond(jnp.asarray(xt), None, jnp.asarray(TH)))


def test_self_consistency():
    assert check_self_consistency(_pair()[1], TH)


def test_analytic_score_is_the_ad_score_at_the_map():
    """At the exact MAP the all-positive packed score equals ∂θ log_like."""
    _, pt = _pair("direct")
    xs = 3.0 * _t(_packed(2, seed=4))
    Z, _ = pt.custom_zhat(xs, torch.zeros_like(xs), _t(TH), 1e-3)
    for i in range(2):
        g_ad = torch.func.grad(lambda t: pt.log_like(xs[i], Z[i], t))(_t(TH))
        _close(pt.grad_theta_log_like(xs[i], Z[i], _t(TH)), g_ad, rtol=1e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_band_sum_is_exact_and_reruns_bitwise(batched):
    """The sorted-slice reduction against a float64 sum per band (relative
    error ≤ 1e-5) and against index_add_; a rerun is bitwise equal, alone
    and under vmap."""
    _, pt = _pair()
    q = _t(np.abs(_packed(5, seed=2)))
    band = np.tile(np.searchsorted(
        tb.band_edges(N, NB), tb._k_grid64(N), side="right").reshape(-1), 2)
    want = np.stack([np.bincount(band, weights=row, minlength=NB)
                     for row in q.double().numpy()])
    if batched:
        got, again = (torch.func.vmap(pt.band_sum)(q) for _ in range(2))
    else:
        got, again = (torch.stack([pt.band_sum(r) for r in q])
                      for _ in range(2))
    assert torch.equal(got, again)
    assert float(np.abs(got.double().numpy() / want - 1).max()) <= 1e-5
    ref = torch.zeros(5, NB).index_add_(1, _t(band), q)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("solver", ["cg", "direct"])
def test_map_solvers_match_jax(solver):
    pj, pt = _pair(solver)
    xs = _packed(3, seed=5)
    Zj, aj = pj.custom_zhat(jnp.asarray(xs), jnp.zeros((3, L)),
                            jnp.asarray(TH), 1e-3)
    Zt, at = pt.custom_zhat(_t(xs), torch.zeros((3, L)), _t(TH), 1e-3)
    _close(Zt, Zj)
    assert at["converged"].all() and not at["failed"].any()
    if solver == "cg":
        np.testing.assert_array_equal(at["iterations"].numpy(),
                                      np.asarray(aj["iterations"]))


def test_cg_goes_through_the_fused_operator_and_equals_direct():
    """zhat_cg takes (A p, pᵀA p) from spectrum_quadform_and_grad, one
    evaluation per CG step (one kernel launch on a card), and reaches the
    closed form."""
    xs = _t(_packed(3, seed=6))
    before = batched_cg.curvature_steps
    Zc, aux = _pair("cg")[1].custom_zhat(xs, torch.zeros((3, L)), _t(TH),
                                         1e-4)
    assert batched_cg.curvature_steps - before >= int(aux["iterations"].max())
    assert batched_cg.curvature_steps > before
    Zd, _ = _pair("direct")[1].custom_zhat(xs, torch.zeros((3, L)), _t(TH),
                                           1e-4)
    torch.testing.assert_close(Zc, Zd, rtol=0, atol=1e-5)


def test_lbfgs_solver_and_mesh():
    pt = tb.bandpower_problem(N, NB, sigma_noise=SIGMA, solver="lbfgs",
                              x_obs=_pair()[1].x.numpy(), device=CPU)
    assert pt.custom_zhat is None
    comp = TCompiled(pt, TSpec.from_example(TH), TH.astype(np.float64))
    xs = _t(_packed(2, seed=7))
    Z, aux = comp._solve_maps(xs, torch.zeros((2, L)), _t(TH), 1e-3)
    Zd, _ = _pair("direct")[1].custom_zhat(xs, torch.zeros((2, L)), _t(TH),
                                           1e-3)
    assert aux["converged"].all()
    torch.testing.assert_close(Z, Zd, rtol=0, atol=1e-3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tb.bandpower_problem(N, NB, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="solver"):
        tb.bandpower_problem(N, NB, solver="newton", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tb.bandpower_problem(N, NB)


@pytest.mark.parametrize("noise", [0.1, 0.05])
def test_bandpower_mle_matches_jax(noise):
    pj, _ = _pair()
    thj, covj = jb.bandpower_mle(pj.x_real, N, NB, sigma_noise=noise)
    tht, covt = tb.bandpower_mle(pj.x_real, N, NB, sigma_noise=noise)
    np.testing.assert_allclose(tht, thj, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(covt, covj, rtol=1e-9, atol=1e-14)


def test_fit_on_jax_whites_matches_muse_tpu():
    pj, pt = _pair()
    rj, rt = fits_on_jax_whites(pj, pt, np.zeros(NB), 16, theta_rtol=1e-4,
                                maxsteps=8)
    assert len(rt.history) == len(rj.history)
    assert_fits_agree(rj, rt)


def test_muse_matches_the_decoupled_mle_and_fisher():
    """muse(get_covariance=True) on the port alone: each θ̂_b near its exact
    MLE, diag Σ near the Fisher diagonal, small off-diagonal correlations."""
    _, pt = _pair()
    res = muse_tpu_torch.muse(pt, np.zeros(NB), nsims=100, theta_rtol=1e-3,
                              get_covariance=True, seed=1)
    mle, cov = tb.bandpower_mle(pt.x_real, N, NB, sigma_noise=SIGMA)
    sig_F = np.sqrt(np.diag(cov))
    assert (np.abs(res.theta - mle) < 3 * sig_F / np.sqrt(100) + 0.05).all()
    ratio = np.diag(res.Sigma) / np.diag(cov)
    assert ((ratio > 0.5) & (ratio < 2.0)).all(), ratio
    corr = res.Sigma / np.sqrt(np.outer(np.diag(res.Sigma),
                                        np.diag(res.Sigma)))
    assert np.abs(corr - np.eye(NB)).max() < 0.4


def test_implicit_H_matches_jax_and_chunks_agree():
    """Implicit-diff H on muse_tpu's whites (sims × nθ CG lanes), and
    get_H chunked by max_batch against one chunk."""
    pj, pt = _pair()
    jspec, tspec = JSpec.from_example(TH), TSpec.from_example(TH)
    jc = JCompiled(pj, jspec, jspec.flatten(TH))
    tc = TCompiled(pt, tspec, TH.astype(np.float64))
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    Hj, _ = jc.h_implicit_with(pj.suggested_h_precond)(
        keys, jnp.asarray(TH), jnp.float32(1e-1), 100, 1e-6, False)
    W_t = convert.whites_from_arrays(
        *(np.asarray(w) for w in jc.sample_whites(keys)), device=CPU)
    Ht, resid = tc.h_implicit_from_whites(W_t, _t(TH), 1e-1, 100, 1e-6, False,
                                          pt.suggested_h_precond)
    Hj = np.asarray(Hj)
    assert Ht.shape == Hj.shape == (3, NB, NB)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-3,
                               atol=1e-3 * np.abs(Hj).max())
    assert resid.shape == (3, NB)

    kw = dict(seed=1, nsims=5, implicit_diff=True,
              implicit_diff_precond=pt.suggested_h_precond)
    one = muse_tpu_torch.get_H(muse_tpu_torch.MuseResult(
        theta=TH.astype(np.float64)), pt, **kw)
    two = muse_tpu_torch.get_H(muse_tpu_torch.MuseResult(
        theta=TH.astype(np.float64)), pt, max_batch=2, **kw)
    np.testing.assert_allclose(two.H, one.H, rtol=1e-5, atol=1e-5)
