"""The K-weight spectrum quadforms and the analytic GRF θ-scores that run
through them, against muse_tpu's functions on the same numpy inputs.

``spectrum_quadforms(z, W)`` takes every θ component's quadform of a GRF
score in one pass over z. ``grf_field_problem``'s θ-score is analytic:
∂θα log_like = ½ Σ z²·pack(w·dα/C)/n² − ½ Σ w·dα at any z (dα = ∂log C/∂θα),
one quadforms evaluation per batched score and no backward. muse_tpu's
field GRF takes ``jax.grad`` of its log-likelihood instead (its Pallas
kernel in interpret mode on the CPU), so the two packages compute the same
function two ways. The pixel and spectral GRFs take both θ components of a
tilt score from one evaluation where muse_tpu launches its quadform twice.

Tolerance: a score is the difference of two terms of size ~n², ½Q/n² and
½Σw·dα (docs/internals.md, "f32 score precision"), so a float32 score is
held to |Δg| ≤ 1e-6·(½|Q|/n² + ½Σw|dα|), a few float32 roundings of its
terms; the quadforms themselves to rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import muse_tpu.models.grf as jgrf
from muse_tpu_torch import convert
from muse_tpu_torch.models import grf as tgrf
from muse_tpu_torch.ops import grf_spectrum as tp
from muse_tpu_torch.scripts import theta_score_bench

torch.set_num_threads(1)

N, LANES, SIGMA = 16, 4, 0.1
SCORE_TOL = 1e-6


def _rng_fields(seed, k, n=N):
    return np.random.default_rng(seed).standard_normal(
        (k, n, n)).astype(np.float32)


def _theta(tilt):
    return np.array([0.3, 0.15], np.float32) if tilt else np.float32(0.3)


def _field_pair(tilt):
    """muse_tpu's and the port's grf_field_problem on the same config
    arrays and data; with ``tilt`` a config that infers the tilt."""
    jc = jgrf.GrfConfig(N, sigma_noise=SIGMA, infer_tilt=tilt)
    x_obs = _rng_fields(1, 1)[0]
    pj = jgrf.grf_field_problem(jc, x_obs=jnp.asarray(x_obs))
    tc = convert.grf_config_from_arrays(N, SIGMA, jc.gamma, jc.k0,
                                        np.asarray(jc.k),
                                        np.asarray(jc.herm_weight),
                                        infer_tilt=tilt, device="cpu")
    return pj, tgrf.grf_field_problem(tc, x_obs=x_obs)


def _score_terms64(cfg, z, th):
    """(the field GRF's scores in float64, the size of their two terms)
    per lane: (B, K) each."""
    th64 = torch.as_tensor(np.atleast_1d(th), dtype=torch.float64)
    k, w = cfg.k.double(), cfg.herm_weight.double()
    gamma = cfg.gamma + (th64[1] if cfg.infer_tilt else 0.0)
    C = torch.exp(th64[0]) * (k + cfg.k0) ** (-gamma)
    d = torch.stack([torch.ones_like(k)] +
                    ([-torch.log(k + cfg.k0)] if cfg.infer_tilt else []))
    zf = tp.pack_rfft2(torch.as_tensor(z, dtype=torch.float64))
    q = torch.einsum("bnm,knm->bk", zf * zf,
                     tp.pack_weights(w * d / C)) / cfg.n ** 2
    wd = (w * d).sum((-2, -1))
    qa = torch.einsum("bnm,knm->bk", zf * zf,
                      tp.pack_weights(w * d.abs() / C)) / cfg.n ** 2
    return 0.5 * (q - wd), 0.5 * (qa + (w * d.abs()).sum((-2, -1)))


def _as_rows(g):
    """Scores as (lanes, K) float64."""
    g = np.asarray(g, np.float64)
    return g.reshape(len(g), -1)


@pytest.mark.parametrize("K", [1, 2, 4])
def test_plain_quadforms_equal_k_single_quadforms(K):
    rng = np.random.default_rng(K)
    z = torch.tensor(rng.standard_normal((5, 8, 10)).astype(np.float32))
    W = torch.tensor(rng.uniform(-1.0, 2.0, (K, 8, 10)).astype(np.float32))
    got = tp.spectrum_quadforms_plain(z, W)
    assert got.shape == (5, K)
    want = torch.stack([tp.spectrum_quadform_plain(z, W[k])
                        for k in range(K)], -1)
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    # the Function takes the plain version on CPU tensors, bitwise
    assert torch.equal(tp.spectrum_quadforms(z, W), got)


def test_quadforms_count_one_evaluation_per_batched_call():
    rng = np.random.default_rng(3)
    z = torch.tensor(rng.standard_normal((6, 8, 10)).astype(np.float32))
    W = torch.tensor(rng.uniform(0.5, 1.5, (2, 8, 10)).astype(np.float32))
    before = tp.SpectrumQuadforms.evaluations
    launches = tp.spectrum_quadforms_cuda.launches
    got = vmap(lambda v: tp.spectrum_quadforms(v[None], W)[0])(z)
    assert tp.SpectrumQuadforms.evaluations - before == 1
    assert tp.spectrum_quadforms_cuda.launches == launches   # CPU: plain
    torch.testing.assert_close(got, tp.spectrum_quadforms_plain(z, W))
    # batched weights: one evaluation per lane
    before = tp.SpectrumQuadforms.evaluations
    vmap(lambda v, c: tp.spectrum_quadforms(v[None], c[None])[0])(z, z)
    assert tp.SpectrumQuadforms.evaluations - before == 6


def test_quadforms_have_no_vjp_and_refuse_cpu_in_the_cuda_wrapper():
    z = torch.ones((2, 4, 6), requires_grad=True)
    W = torch.ones((1, 4, 6))
    with pytest.raises(RuntimeError, match="no VJP"):
        tp.spectrum_quadforms(z, W).sum().backward()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.spectrum_quadforms_cuda(z.detach(), W)


@pytest.mark.parametrize("tilt", [False, True])
def test_field_grf_analytic_score_matches_jax_grad(tilt):
    """The port's one-evaluation analytic score against muse_tpu's
    ``vmap(grad(log_like))`` (Pallas interpret mode), the port's own
    autograd route, and float64, on the same x, z and θ."""
    pj, pt = _field_pair(tilt)
    x, z = _rng_fields(2, LANES), 0.5 * _rng_fields(3, LANES)
    th = _theta(tilt)
    g_j = jax.vmap(lambda a, b: jax.grad(
        lambda t: pj.log_like(a, b, t))(jnp.asarray(th)))(
            jnp.asarray(x), jnp.asarray(z))
    xt, zt, tht = torch.from_numpy(x), torch.from_numpy(z), torch.tensor(th)
    before = tp.SpectrumQuadforms.evaluations
    g_t = vmap(lambda a, b: pt.grad_theta_log_like(a, b, tht))(xt, zt)
    assert tp.SpectrumQuadforms.evaluations - before == 1
    assert tuple(g_t.shape) == ((LANES, 2) if tilt else (LANES,))
    g_ad = vmap(lambda a, b: grad(lambda t: pt.log_like(a, b, t))(tht))(
        xt, zt)
    g64, terms = _score_terms64(pt.grf_config, z, th)
    got = _as_rows(g_t)
    for other in (np.asarray(g_j), g_ad.numpy(), g64.numpy()):
        err = np.abs(got - _as_rows(other))
        assert (err <= SCORE_TOL * terms.numpy()).all(), (
            err / terms.numpy()).max()


@pytest.mark.parametrize("use_pallas", [True, False])
def test_field_grf_score_routes_agree(use_pallas):
    """``use_pallas=False`` scores through the plain quadforms (no
    evaluation counted), True through the Function; both agree."""
    _, pt = _field_pair(False)
    p = tgrf.grf_field_problem(pt.grf_config, x_obs=pt.x.numpy(),
                               use_pallas=use_pallas)
    x, z = _rng_fields(4, LANES), _rng_fields(5, LANES)
    tht = torch.tensor(-0.2)
    before = tp.SpectrumQuadforms.evaluations
    g = vmap(lambda a, b: p.grad_theta_log_like(a, b, tht))(
        torch.from_numpy(x), torch.from_numpy(z))
    assert tp.SpectrumQuadforms.evaluations - before == int(use_pallas)
    g64, terms = _score_terms64(p.grf_config, z, -0.2)
    err = np.abs(g.numpy()[:, None] - g64.numpy())
    assert (err <= SCORE_TOL * terms.numpy()).all()


def test_field_grf_muse_step_scores_through_one_evaluation():
    """The solver's per-lane scores take the analytic hook: one quadforms
    evaluation per batched step, and no evaluation of the log-likelihood's
    quadform."""
    from muse_tpu_torch.solver.compiled import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec
    _, pt = _field_pair(False)
    comp = CompiledProblem(pt, ThetaSpec.from_example(0.3), np.array([0.3]))
    th = torch.tensor([0.3])
    tp.reset_counts()
    out = comp.muse_step(th, th, [1, 2, 3], torch.zeros((3, comp.nz)),
                         torch.arange(3), 1e-3)
    assert tp.SpectrumQuadforms.evaluations == 1
    assert tp.SpectrumQuadform.evaluations == 0
    # the same scores by autograd of the log-likelihood at the MAPs
    Z = out["Z"].reshape(3, N, N)
    xs = torch.stack([comp._sample_flat(s, th)[0] for s in (1, 2, 3)])
    xs[0] = pt.x
    g_ad = vmap(lambda a, b: grad(lambda t: pt.log_like(a, b, t))(
        th[0]))(xs, Z)
    g64, terms = _score_terms64(pt.grf_config, Z.numpy(), 0.3)
    err = np.abs(out["g"].numpy() - g_ad.numpy()[:, None])
    assert (err <= 2 * SCORE_TOL * terms.numpy()).all()


def _pixel_pair(tilt):
    pj = jgrf.grf_problem(n=N, sigma_noise=SIGMA, infer_tilt=tilt,
                          data_key=jax.random.PRNGKey(2))
    pt = tgrf.grf_problem(n=N, sigma_noise=SIGMA, infer_tilt=tilt,
                          x_obs=np.asarray(pj.x), device="cpu")
    return pj, pt, _rng_fields(6, LANES), _rng_fields(7, LANES)


def _spectral_pair(tilt):
    kw = dict(n=N, sigma_noise=SIGMA, infer_tilt=tilt)
    x_obs = _rng_fields(8, 1)[0]
    pj = jgrf.grf_spectral_problem(x_obs=jnp.asarray(x_obs), **kw)
    pt = tgrf.grf_spectral_problem(x_obs=x_obs, device="cpu", **kw)
    L = 2 * N * (N // 2 + 1)
    rng = np.random.default_rng(9)
    xs = rng.standard_normal((LANES, L)).astype(np.float32)
    return pj, pt, xs, 0.5 * xs


@pytest.mark.parametrize("model", ["grf_problem", "grf_spectral_problem"])
@pytest.mark.parametrize("tilt", [False, True])
def test_tilt_scores_are_one_evaluation_and_match_jax(model, tilt):
    """Both θ components of the pixel and spectral GRFs' analytic scores
    from one quadforms evaluation per batched score, equal to muse_tpu's
    ``grad_theta`` (two quadform launches there with the tilt)."""
    pj, pt, xs, zs = {"grf_problem": _pixel_pair,
                      "grf_spectral_problem": _spectral_pair}[model](tilt)
    th = _theta(tilt)
    g_j = jax.vmap(lambda a, b: pj.grad_theta_log_like(a, b, th))(
        jnp.asarray(xs), jnp.asarray(zs))
    tht = torch.tensor(th)
    before = tp.SpectrumQuadforms.evaluations
    g_t = vmap(lambda a, b: pt.grad_theta_log_like(a, b, tht))(
        torch.from_numpy(xs), torch.from_numpy(zs))
    assert tp.SpectrumQuadforms.evaluations - before == 1
    want = np.asarray(g_j)
    assert g_t.shape == want.shape
    # an all-positive sum (no cancellation): rtol of the largest entry
    np.testing.assert_allclose(g_t.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_theta_score_bench_runs_every_route_on_the_cpu():
    """The script's routes on the CPU at 16²: every route's error within
    the score tolerance, no kernel launch, no time (not measured)."""
    out = theta_score_bench.run(n=N, lanes=3, sigma_noise=SIGMA,
                                device="cpu")
    assert set(out) == set(theta_score_bench.ROUTES)
    for r in out.values():
        assert r["ms"] is None and r["launches"] == 0
        assert r["rel_err"] <= SCORE_TOL
