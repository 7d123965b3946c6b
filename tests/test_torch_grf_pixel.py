"""``grf_problem`` of the port (the whitened GRF in pixel space) against
muse_tpu's, on the same numpy inputs, and against the port's other two
representations of the same field.

n = 16 and 33 for the functions, n = 32 with σ_noise = 0.1 for whole fits
(σ_F ≈ 0.1). Tolerances:

  * rtol 1e-5 (of the largest entry) for the config's operators, the
    sampler completion, the density, the score, the MAPs and h_precond;
  * a whole fit on muse_tpu's whites: per-lane scores within 1e-4, θ̂ within
    1e-3;
  * the whitened pixel latent and the non-whitened field latent define the
    same marginal model: their θ̂ on the same data within 0.25σ_F
    (tests/test_pallas_grf.py's parameterization check).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muse_tpu.models.grf as jg
import muse_tpu_torch
from muse_tpu_torch import check_self_consistency, convert
from muse_tpu_torch.models import grf as tg
from muse_tpu_torch.ops import grf_spectrum as tp
from muse_tpu_torch.ops.cg import batched_cg
from muse_tpu_torch.solver.compiled import CompiledProblem as TCompiled
from muse_tpu_torch.theta import ThetaSpec as TSpec
from torch_parity import assert_fits_agree, fits_on_jax_whites

torch.set_num_threads(1)

CPU = "cpu"
SIGMA = 0.1


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _fields(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, n, n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(n, tilt=False, solver="cg"):
    pj = jg.grf_problem(n=n, sigma_noise=SIGMA, infer_tilt=tilt,
                        solver=solver, data_key=jax.random.PRNGKey(2))
    pt = tg.grf_problem(n=n, sigma_noise=SIGMA, infer_tilt=tilt,
                        solver=solver, x_obs=np.asarray(pj.x), device=CPU)
    return pj, pt


def _theta(tilt):
    return np.array([0.2, 0.1], np.float32) if tilt else np.float32(0.2)


@pytest.mark.parametrize("n", [16, 33])
def test_config_operators_match_jax(n):
    cj = jg.GrfConfig(n, SIGMA, infer_tilt=True)
    ct = tg.GrfConfig(n, SIGMA, infer_tilt=True, device=CPU)
    u = _fields(n, 2)
    th = np.array([0.3, -0.1], np.float32)
    _close(ct.apply_sqrtC(_t(u), th), cj.apply_sqrtC(jnp.asarray(u), th))
    _close(ct.apply_C(_t(u), th), cj.apply_C(jnp.asarray(u), th))
    _close(torch.view_as_real(ct.rfft2(_t(u))),
           np.stack([np.asarray(cj.rfft2(jnp.asarray(u))).real,
                     np.asarray(cj.rfft2(jnp.asarray(u))).imag], -1))
    torch.testing.assert_close(ct.irfft2(ct.rfft2(_t(u))), _t(u), rtol=0,
                               atol=1e-5)
    # S_θ S_θ = C_θ
    _close(ct.apply_sqrtC(ct.apply_sqrtC(_t(u), th), th),
           ct.apply_C(_t(u), th), rtol=1e-4)


@pytest.mark.parametrize("tilt", [False, True])
@pytest.mark.parametrize("n", [16, 33])
def test_model_functions_match_jax(n, tilt):
    pj, pt = _pair(n, tilt)
    u, e, x = _fields(n, 3, seed=1)
    th = _theta(tilt)
    xj, zj = pj.x_of_white((jnp.asarray(u), jnp.asarray(e)), th)
    xt, zt = pt.x_of_white((_t(u), _t(e)), _t(th))
    _close(xt, xj)
    assert torch.equal(zt, _t(u))
    lj = float(pj.log_like(jnp.asarray(x), jnp.asarray(u), th))
    lt = float(pt.log_like(_t(x), _t(u), _t(th)))
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    gj = np.asarray(pj.grad_theta_log_like(jnp.asarray(x), jnp.asarray(u),
                                           th))
    gt = pt.grad_theta_log_like(_t(x), _t(u), _t(th))
    assert gt.shape == gj.shape
    _close(gt, gj)
    w = _fields(n, 1, seed=2)[0].reshape(-1)
    th1 = np.atleast_1d(th)
    _close(pt.suggested_h_precond(_t(w), None, _t(th1)),
           pj.suggested_h_precond(jnp.asarray(w), None, jnp.asarray(th1)))


@pytest.mark.parametrize("n", [16, 33])
def test_self_consistency(n):
    assert check_self_consistency(_pair(n)[1], 0.2)
    assert check_self_consistency(_pair(n, tilt=True)[1],
                                  np.array([0.2, 0.1]))


@pytest.mark.parametrize("tilt", [False, True])
@pytest.mark.parametrize("n", [16, 33])
def test_zhat_cg_matches_direct_and_jax(n, tilt):
    """The packed-spectral PCG (entry and exit transforms around the fused
    operator) against the closed form and against muse_tpu's zhat_cg."""
    pj, pt = _pair(n, tilt)
    _, ptd = _pair(n, tilt, solver="direct")
    xs = _fields(n, 3, seed=3)
    th = np.atleast_1d(_theta(tilt))
    Z0 = 0.1 * _fields(n, 3, seed=4).reshape(3, -1)
    before = batched_cg.curvature_steps
    Zt, at = pt.custom_zhat(_t(xs), _t(Z0), _t(th), 1e-3)
    steps = batched_cg.curvature_steps - before
    Zd, _ = ptd.custom_zhat(_t(xs), _t(Z0), _t(th), 1e-3)
    Zj, aj = pj.custom_zhat(jnp.asarray(xs), jnp.asarray(Z0), jnp.asarray(th),
                            1e-3)
    assert Zt.shape == (3, n * n)
    assert at["converged"].all() and not at["failed"].any()
    _close(Zt, Zd)
    _close(Zt, Zj)
    np.testing.assert_array_equal(at["iterations"].numpy(),
                                  np.asarray(aj["iterations"]))
    # one fused-operator evaluation per CG step
    assert steps >= int(at["iterations"].max()) > 0
    # the MAP is stationary for the log-likelihood
    g = torch.func.vmap(torch.func.grad(
        lambda z, x: pt.log_like(x, z.reshape(n, n), _t(_theta(tilt)))))(
        Zt, _t(xs))
    assert float(g.abs().max()) < 1e-2


def test_theta_score_is_one_quadform_evaluation_per_batch():
    """vmap over lanes folds the per-lane analytic score into one quadform
    call (one kernel launch on a card); with the tilt, one per θ
    component."""
    for tilt, per_batch in ((False, 1), (True, 2)):
        _, pt = _pair(16, tilt)
        th0 = _theta(tilt)
        tc = TCompiled(pt, TSpec.from_example(th0),
                       np.atleast_1d(th0).astype(np.float64))
        W = tc.sample_whites([1, 2, 3, 4, 5])
        th = _t(np.atleast_1d(th0))
        before = tp.SpectrumQuadform.evaluations
        tc.muse_step_white(th, th, W, torch.zeros((5, tc.nz)),
                           torch.arange(5), 1e-2)
        assert tp.SpectrumQuadform.evaluations - before == per_batch


def test_what_is_left_out_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match="Left out on purpose"):
        tg.grf_problem(n=8, fft_mode="matmul", device=CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        tg.grf_problem(n=8, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="fft_mode"):
        tg.grf_problem(n=8, fft_mode="dct", device=CPU)
    with pytest.raises(ValueError, match="solver"):
        tg.grf_problem(n=8, solver="newton", device=CPU)
    assert tg.grf_problem(n=8, fft_mode="fft", device=CPU).custom_zhat
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tg.grf_problem(n=8)


def test_lbfgs_solver_reaches_the_direct_map():
    n = 16
    pt = tg.grf_problem(n=n, sigma_noise=SIGMA, solver="lbfgs",
                        x_obs=_pair(n)[1].x.numpy(), device=CPU)
    assert pt.custom_zhat is None
    comp = TCompiled(pt, TSpec.from_example(0.2), np.array([0.2]))
    xs = _t(_fields(n, 2, seed=5))
    th = torch.tensor([0.2])
    Z, aux = comp._solve_maps(xs, torch.zeros((2, n * n)), th, 1e-3)
    Zd, _ = _pair(n, solver="direct")[1].custom_zhat(
        xs, torch.zeros((2, n * n)), th, 1e-3)
    assert aux["converged"].all()
    torch.testing.assert_close(Z, Zd, rtol=0, atol=1e-3)


def test_convert_takes_any_number_of_whites_and_latent_dicts():
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    for k in (1, 2, 3):
        W = convert.whites_from_arrays(*([a] * k), device=CPU)
        assert len(W) == k
        assert all(w.dtype == torch.float32 and w.shape == (2, 3) for w in W)
    with pytest.raises(ValueError, match="at least one"):
        convert.whites_from_arrays(device=CPU)
    z = convert.latent({"uz": jnp.ones((2, 2)), "uphi": np.zeros((2, 2))},
                       CPU)
    assert sorted(z) == ["uphi", "uz"] and z["uz"].dtype == torch.float32
    assert convert.latent(a, CPU).shape == (2, 3)


@pytest.fixture(scope="module")
def fits32():
    """Fits at n = 32 on one data set: muse_tpu's and the port's
    grf_problem on muse_tpu's whites, and the port's own
    muse(get_covariance=True) of grf_problem and of grf_field_problem."""
    n = 32
    pj = jg.grf_problem(n=n, sigma_noise=SIGMA,
                        data_key=jax.random.PRNGKey(5))
    x = np.asarray(pj.x)
    pt = tg.grf_problem(n=n, sigma_noise=SIGMA, x_obs=x, device=CPU)
    rj, rt = fits_on_jax_whites(pj, pt, 0.5, 32, theta_rtol=1e-4, alpha=1.0,
                                maxsteps=10)
    kw = dict(nsims=64, theta_rtol=1e-4, get_covariance=True, seed=1)
    own = muse_tpu_torch.muse(pt, 0.5, **kw)
    field = muse_tpu_torch.muse(
        tg.grf_field_problem(n=n, sigma_noise=SIGMA, x_obs=x, device=CPU),
        0.5, **kw)
    mle, sig_F = tg.grf_marginal_mle(x, pt.grf_config)
    return {"rj": rj, "rt": rt, "own": own, "field": field, "mle": mle,
            "sig_F": sig_F}


def test_fit_on_jax_whites_matches_muse_tpu(fits32):
    assert len(fits32["rt"].history) == len(fits32["rj"].history)
    assert_fits_agree(fits32["rj"], fits32["rt"])


def test_muse_matches_the_marginal_mle(fits32):
    own, sig_F = fits32["own"], fits32["sig_F"]
    assert abs(float(own.theta[0]) - fits32["mle"]) < \
        3 * sig_F / np.sqrt(64) + 0.02
    assert 0.5 < float(own.sigma[0]) / sig_F < 2
    assert own.history[-1]["map_converged"].all()


def test_whitened_and_field_latents_define_the_same_marginal_model(fits32):
    """θ̂ of grf_problem against grf_field_problem's on the same field,
    within 0.25σ_F."""
    assert abs(float(fits32["own"].theta[0])
               - float(fits32["field"].theta[0])) < 0.25 * fits32["sig_F"]


@pytest.mark.parametrize("n,nz", [(16, None), (33, 33 * 33)])
def test_packed_diag_pcg_solves_the_diagonal_system(n, nz):
    """The PCG that the three packed models share: with the exact inverse as
    its preconditioner it solves A·z = b in one or two steps (float32
    rounding of the first) from any warm start, each one fused-operator
    call; ``nz`` (the pixel latent's length) only rescales the stop.
    Solution within 1e-6 of b/A."""
    rng = np.random.default_rng(n)
    grid = (n, 2 * (n // 2 + 1))
    L = grid[0] * grid[1]
    A = _t(1.0 + rng.uniform(0.0, 1e4, (1, L)).astype(np.float32))
    b = _t(rng.standard_normal((3, L)).astype(np.float32)) * A
    Z0 = _t(rng.standard_normal((3, L)).astype(np.float32))
    before = batched_cg.curvature_steps
    Z, aux = tg._packed_diag_pcg(A, b, Z0, 1e-3, 200, grid, nz=nz)
    steps = batched_cg.curvature_steps - before
    assert 1 <= steps <= 2 and steps == int(aux["iterations"].max())
    assert aux["converged"].all() and not aux["failed"].any()
    _close(Z, b / A, rtol=1e-6)
