"""Slice 2: the packed spectral GRF and its north-star pipeline against
muse_tpu, module by module and end to end.

Inputs are made with numpy from a seed, or drawn by muse_tpu and handed
over as numpy (its whites, ``comp.sample_whites(keys)``), and go through
both packages. n=32 and σ_noise=0.1, so that the field carries signal
(σ_F ≈ 0.1). Tolerances:

  * rtol 1e-5 for the sampler completion, densities, scores and MAPs:
    the same float32 elementwise arithmetic, sums taken in other orders;
  * rtol 1e-4 for muse-step scores, and Z within 1e-5·max|Z| (as in
    test_torch_grf.py);
  * rtol 1e-3 for implicit H: a float32 Hessian-vector product solved by
    CG to a relative residual 1e-6, then a difference of two O(n²) sums;
  * statistical bounds for whole fits: the packages draw different sims
    (tests/test_torch_slice.py's bounds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muse_tpu
import muse_tpu.models.grf as jgrf
from muse_tpu.solver.compiled import CompiledProblem as JCompiled
from muse_tpu.theta import ThetaSpec as JSpec
from muse_tpu.utils.keys import sim_keys
import muse_tpu_torch
from muse_tpu_torch import check_self_consistency, convert
from muse_tpu_torch.models import grf as tgrf
from muse_tpu_torch.ops import grf_spectrum as tp
from muse_tpu_torch.solver.compiled import CompiledProblem as TCompiled
from muse_tpu_torch.theta import ThetaSpec as TSpec
from muse_tpu_torch.utils.keys import lane_generator, sim_seeds

torch.set_num_threads(1)

N, B, SIGMA = 32, 9, 0.1
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _field() -> np.ndarray:
    """A real (N, N) observation drawn from the field model at θ = 0."""
    rng = np.random.default_rng(42)
    cfg = jgrf.GrfConfig(N, sigma_noise=SIGMA)
    z = np.asarray(cfg.apply_sqrtC(jnp.asarray(
        rng.standard_normal((N, N)), jnp.float32), 0.0))
    x = (z + SIGMA * rng.standard_normal((N, N))).astype(np.float32)
    x.flags.writeable = False
    return x


@pytest.fixture(scope="module")
def x_field():
    return _field()


@functools.lru_cache(maxsize=None)
def _pair(noise="marginal", tilt=False, solver="cg"):
    """(muse_tpu problem, port problem) on the same data, built once per
    configuration."""
    kw = dict(n=N, sigma_noise=SIGMA, infer_tilt=tilt, solver=solver,
              noise=noise)
    pj = jgrf.grf_spectral_problem(x_obs=jnp.asarray(_field()), **kw)
    pt = tgrf.grf_spectral_problem(x_obs=_field(), device=CPU, **kw)
    return pj, pt


def _theta(th, tilt):
    return np.array([th, 0.15], np.float32) if tilt else np.float32(th)


def _jax_whites(pj, nlanes, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), nlanes)
    w1, w2 = jax.vmap(pj.sample_white)(keys)
    return keys, np.asarray(w1), np.asarray(w2)


# ------------------------------------------------------------------ #
# (b) the hermitian white sampler
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n", [8, 9, 32])
def test_herm_white_coeffs_equal_jax(n):
    for a, b in zip(tgrf._herm_white_coeffs(n), jgrf._herm_white_coeffs(n)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n", [8, 9, 32])
def test_hermitian_white_survives_unpack_irfft2_pack(n):
    """A draw is a hermitian-consistent packed spectrum: unpack → irfft2 →
    pack returns it (to float32 rounding), and its variance per packed
    coordinate is 1 on average."""
    p = tgrf.grf_spectral_problem(n=n, sigma_noise=SIGMA, device=CPU)
    w = tgrf.hermitian_white_packed(lane_generator(3, CPU), n)
    assert w.shape == (2 * n * (n // 2 + 1),)
    back = p.pack_field(torch.tensor(p.unpack_field(w), dtype=torch.float32))
    torch.testing.assert_close(back, w, rtol=0, atol=1e-5)
    many = torch.stack([tgrf.hermitian_white_packed(lane_generator(s, CPU), n)
                        for s in range(200)])
    # pack(√w/n · rfft2(white)) is isometric: Σ over coords ≈ n² per draw
    assert abs(float((many ** 2).sum(1).mean()) / n ** 2 - 1) < 0.05


def test_draw_order_g_then_h():
    gen = lane_generator(5, CPU)
    w = tgrf.hermitian_white_packed(gen, 8)
    g2 = lane_generator(5, CPU)
    g = torch.randn((8, 5), generator=g2)
    h = torch.randn((8, 5), generator=g2)
    a, b, c, d = (torch.from_numpy(v.copy()) for v in
                  tgrf._herm_white_coeffs(8))
    flip = lambda v: torch.roll(v.flip(0), 1, dims=0)   # noqa: E731
    want = torch.cat([(a * g + b * flip(g)).reshape(-1),
                      (c * h + d * flip(h)).reshape(-1)])
    torch.testing.assert_close(w, want)


# ------------------------------------------------------------------ #
# (c) the model's functions on JAX's whites
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("theta", [-0.3, 0.5])
@pytest.mark.parametrize("tilt", [False, True])
@pytest.mark.parametrize("noise", ["marginal", "direct", "fft"])
def test_model_functions_match_jax(noise, tilt, theta):
    pj, pt = _pair(noise, tilt)
    pjd, ptd = _pair(noise, tilt, solver="direct")
    _, w1, w2 = _jax_whites(pj, B)
    th = _theta(theta, tilt)
    tht = torch.as_tensor(th)
    th_flat = np.atleast_1d(th)

    # x_of_white
    xj, zj = jax.vmap(lambda a, b: pj.x_of_white((a, b), jnp.asarray(th)))(
        jnp.asarray(w1), jnp.asarray(w2))
    xj, zj = np.asarray(xj), np.asarray(zj)
    xt, zt = zip(*(pt.x_of_white((torch.from_numpy(a), torch.from_numpy(b)),
                                 tht) for a, b in zip(w1, w2)))
    xt, zt = torch.stack(xt), torch.stack(zt)
    for got, want in ((xt, xj), (zt, zj)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())

    # log_like and the analytic θ-score, per lane, on JAX's (x, z)
    xs, zs = torch.from_numpy(xj), torch.from_numpy(zj)
    llj = jax.vmap(lambda a, b: pj.log_like(a, b, jnp.asarray(th)))(xj, zj)
    llt = torch.stack([pt.log_like(a, b, tht) for a, b in zip(xs, zs)])
    np.testing.assert_allclose(llt.numpy(), np.asarray(llj), rtol=1e-5)
    gj = jax.vmap(lambda a, b: pj.grad_theta_log_like(
        a, b, jnp.asarray(th)))(xj, zj)
    gt = torch.stack([pt.grad_theta_log_like(a, b, tht)
                      for a, b in zip(xs, zs)])
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5)

    # the PCG MAP from a zero and from a nonzero start, and the closed form
    for Z0 in (np.zeros_like(zj), 0.5 * zj):
        Zj, aj = pj.custom_zhat(jnp.asarray(xj), jnp.asarray(Z0),
                                jnp.asarray(th_flat), 1e-4)
        Zt, at = pt.custom_zhat(xs, torch.from_numpy(Z0),
                                torch.from_numpy(th_flat), 1e-4)
        Zj = np.asarray(Zj)
        np.testing.assert_allclose(Zt.numpy(), Zj, rtol=1e-5,
                                   atol=1e-6 * np.abs(Zj).max())
        np.testing.assert_array_equal(at["converged"].numpy(),
                                      np.asarray(aj["converged"]))
        np.testing.assert_array_equal(at["iterations"].numpy(),
                                      np.asarray(aj["iterations"]))
        assert at["converged"].all()
    Zdj, _ = pjd.custom_zhat(jnp.asarray(xj), None, jnp.asarray(th_flat), 0.)
    Zdt, _ = ptd.custom_zhat(xs, None, torch.from_numpy(th_flat), 0.)
    np.testing.assert_allclose(Zdt.numpy(), np.asarray(Zdj), rtol=1e-5,
                               atol=1e-6 * np.abs(np.asarray(Zdj)).max())

    # the implicit-H preconditioner
    v = w1[0]
    np.testing.assert_allclose(
        pt.suggested_h_precond(torch.from_numpy(v), None,
                               torch.from_numpy(th_flat)).numpy(),
        np.asarray(pj.suggested_h_precond(jnp.asarray(v), None,
                                          jnp.asarray(th_flat))), rtol=1e-5)


def test_packed_data_and_x_real_match_jax(x_field):
    pj, pt = _pair()
    np.testing.assert_allclose(pt.x.numpy(), np.asarray(pj.x), rtol=1e-6,
                               atol=1e-6 * float(np.abs(pj.x).max()))
    np.testing.assert_allclose(pt.x_real, pj.x_real, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pt.x_real, x_field, atol=1e-5)
    np.testing.assert_array_equal(
        convert.packed_x_obs(x_field, N, device=CPU).numpy(), pt.x.numpy())
    # an already packed vector is taken as it is
    again = tgrf.grf_spectral_problem(n=N, sigma_noise=SIGMA,
                                      x_obs=pt.x.numpy(), device=CPU)
    assert torch.equal(again.x, pt.x)


@pytest.mark.parametrize("noise", ["marginal", "direct", "fft"])
def test_white_split_self_consistency(noise):
    _, pt = _pair(noise)
    assert check_self_consistency(pt, 0.3)
    gen = lane_generator(9, CPU)
    x1, z1 = pt.sample_x_z(gen, 0.3)
    x2, z2 = pt.x_of_white(pt.sample_white(lane_generator(9, CPU)), 0.3)
    assert torch.equal(x1, x2) and torch.equal(z1, z2)


def test_x_only_skips_the_conditional_draw():
    """In marginal mode x depends on w₁ alone: x_of_white((w₁, None), θ)
    gives the same x and no z."""
    _, pt = _pair()
    assert pt.x_white_parts == (0,)
    w1, w2 = pt.sample_white(lane_generator(1, CPU))
    x, z = pt.x_of_white((w1, w2), 0.2)
    xo, zo = pt.x_of_white((w1, None), 0.2)
    assert zo is None and torch.equal(x, xo)


def test_not_ported_options_raise():
    """solver="lbfgs" builds (no custom_zhat: the generic L-BFGS MAPs); a
    mesh= that is not a SimsMesh, a bad noise or solver is an error."""
    assert tgrf.grf_spectral_problem(n=8, solver="lbfgs",
                                     device=CPU).custom_zhat is None
    with pytest.raises(ValueError, match="solver"):
        tgrf.grf_spectral_problem(n=8, solver="newton", device=CPU)
    with pytest.raises(TypeError, match="SimsMesh"):
        tgrf.grf_spectral_problem(n=8, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="noise"):
        tgrf.grf_spectral_problem(n=8, noise="pink", device=CPU)


@pytest.mark.parametrize("build", [tgrf.grf_spectral_problem,
                                   tgrf.grf_field_problem])
def test_default_device_is_the_card(build):
    """Built without a device the problem goes to the card, and raises
    where there is none; it never drops to the CPU."""
    if torch.cuda.is_available():
        assert build(n=8).x.is_cuda
        return
    with pytest.raises(RuntimeError, match="cuda"):
        build(n=8)


def test_convert_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    x = np.zeros((8, 8), np.float32)
    for call in (lambda: convert.x_obs(x),
                 lambda: convert.packed_x_obs(x, 8),
                 lambda: convert.whites_from_arrays(x, x)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# ------------------------------------------------------------------ #
# (e) the white-hoisted muse step
# ------------------------------------------------------------------ #

def _compiled(pj, pt, tilt=False):
    th0 = _theta(0.5, tilt)
    jspec, tspec = JSpec.from_example(th0), TSpec.from_example(th0)
    return (JCompiled(pj, jspec, jspec.flatten(th0)),
            TCompiled(pt, tspec, np.atleast_1d(th0).astype(np.float64)))


@pytest.mark.parametrize("tilt", [False, True])
@pytest.mark.parametrize("first_lane", [0, 3])
def test_muse_step_white_matches_jax(first_lane, tilt):
    """The same W_all (JAX's whites), θ, Z_prev and lane ids through both
    packages' muse_step_white (first_lane=0 carries the data lane)."""
    pj, pt = _pair(tilt=tilt)
    jc, tc = _compiled(pj, pt, tilt)
    keys = jax.random.split(jax.random.PRNGKey(first_lane), B)
    W_j = jc.sample_whites(keys)
    w1, w2 = (np.asarray(w) for w in W_j)
    rng = np.random.default_rng(first_lane)
    Z_prev = (0.1 * rng.standard_normal((B, jc.nz))).astype(np.float32)
    lanes = np.arange(first_lane, first_lane + B)
    th = np.atleast_1d(_theta(0.25, tilt))
    out_j = jc.muse_step_white(jnp.asarray(th), jnp.asarray(th), W_j,
                               jnp.asarray(Z_prev), jnp.asarray(lanes),
                               jnp.float32(1e-2))
    W_t = convert.whites_from_arrays(w1, w2, device=CPU)
    out_t = tc.muse_step_white(torch.from_numpy(th), torch.from_numpy(th),
                               W_t, torch.from_numpy(Z_prev),
                               torch.from_numpy(lanes), 1e-2)
    for k in ("g", "g_t"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-4)
    Zj = np.asarray(out_j["Z"])
    np.testing.assert_allclose(out_t["Z"].numpy(), Zj, rtol=0,
                               atol=1e-5 * np.abs(Zj).max())
    np.testing.assert_array_equal(out_t["converged"].numpy(),
                                  np.asarray(out_j["converged"]))
    # x only: the iteration's whites need not hold w₂
    out_x = tc.muse_step_white(torch.from_numpy(th), torch.from_numpy(th),
                               (W_t[0], None), torch.from_numpy(Z_prev),
                               torch.from_numpy(lanes), 1e-2)
    assert torch.equal(out_x["g"], out_t["g"])


@pytest.mark.parametrize("noise", ["marginal", "direct", "fft"])
def test_muse_step_white_equals_muse_step(noise):
    """The port's hoisted step on sample_whites(seeds) and its keyed step on
    the same seeds agree (rtol 1e-6), and sample_whites(x_only=True) keeps
    only what x needs."""
    pj, pt = _pair(noise)
    _, tc = _compiled(pj, pt)
    seeds = sim_seeds(4, B)
    th = torch.tensor([0.3])
    lanes = torch.arange(B)
    Z0 = torch.zeros((B, tc.nz))
    W = tc.sample_whites(seeds, x_only=True)
    if noise == "marginal":
        assert W[1] is None and W[0].shape == (B, tc.nz)
    else:
        assert all(w.shape == (B, tc.nz) for w in W)
    hoisted = tc.muse_step_white(th, th, W, Z0, lanes, 1e-2)
    keyed = tc.muse_step(th, th, seeds, Z0, lanes, 1e-2)
    for k in ("g", "Z"):
        torch.testing.assert_close(hoisted[k], keyed[k], rtol=1e-6,
                                   atol=1e-6 * float(keyed[k].abs().max()))


def test_theta_score_is_one_quadform_evaluation_per_batch():
    """vmap over lanes folds the per-lane θ-score into one quadforms call
    (one kernel launch on a card), with the tilt too: both θ components'
    weights in one pass."""
    for tilt in (False, True):
        pj, pt = _pair(tilt=tilt)
        _, tc = _compiled(pj, pt, tilt)
        W = tc.sample_whites(sim_seeds(1, B), x_only=True)
        th = torch.as_tensor(np.atleast_1d(_theta(0.3, tilt)))
        before = tp.SpectrumQuadforms.evaluations
        tc.muse_step_white(th, th, W, torch.zeros((B, tc.nz)),
                           torch.arange(B), 1e-2)
        assert tp.SpectrumQuadforms.evaluations - before == 1


# ------------------------------------------------------------------ #
# (f) implicit-differentiation H on the same whites
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("noise,tilt", [("marginal", False),
                                        ("marginal", True),
                                        ("direct", False), ("fft", False)])
def test_h_implicit_matches_jax(noise, tilt):
    pj, pt = _pair(noise, tilt)
    jc, tc = _compiled(pj, pt, tilt)
    keys, w1, w2 = _jax_whites(pj, 4, seed=7)
    th = np.atleast_1d(_theta(0.1, tilt))
    Hj, rj = jc.h_implicit_with(pj.suggested_h_precond)(
        keys, jnp.asarray(th), jnp.float32(1e-1), 100, 1e-6, False)
    Ht, rt = tc.h_implicit_from_whites(
        convert.whites_from_arrays(w1, w2, device=CPU), torch.from_numpy(th),
        1e-1, 100, 1e-6, False, pt.suggested_h_precond)
    Hj = np.asarray(Hj)
    assert Ht.shape == Hj.shape == (4, th.size, th.size)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-3,
                               atol=1e-3 * np.abs(Hj).max())
    assert rt.shape == (4, th.size) and (rt.numpy() < 1e-2).all()


def test_h_implicit_without_precond_and_h1_zero():
    """No preconditioner: CG iterates on the HVP and reaches the same H;
    h1_is_zero drops exactly the H1 term."""
    pj, pt = _pair()
    _, tc = _compiled(pj, pt)
    W = tc.sample_whites(sim_seeds(2, 3))
    th = torch.tensor([0.1])
    Hp, _ = tc.h_implicit_from_whites(W, th, 1e-1, 100, 1e-6, False,
                                      pt.suggested_h_precond)
    Hn, _ = tc.h_implicit_from_whites(W, th, 1e-1, 200, 1e-6, False, None)
    torch.testing.assert_close(Hn, Hp, rtol=1e-3, atol=1e-3)
    H0, _ = tc.h_implicit_from_whites(W, th, 1e-1, 100, 1e-6, True,
                                      pt.suggested_h_precond)
    jc, _ = _compiled(pj, pt)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    Hj0, _ = jc.h_implicit_with(pj.suggested_h_precond)(
        keys, jnp.asarray([0.1]), jnp.float32(1e-1), 100, 1e-6, True)
    Hj1, _ = jc.h_implicit_with(pj.suggested_h_precond)(
        keys, jnp.asarray([0.1]), jnp.float32(1e-1), 100, 1e-6, False)
    # H1 differs from zero in both packages by the same sign and scale
    assert float((Hp - H0).abs().max()) > 0
    assert np.sign(float((Hp - H0).mean())) == np.sign(
        float(np.mean(np.asarray(Hj1) - np.asarray(Hj0))))


def test_implicit_get_H_runs_and_needs_the_white_split():
    """get_H(implicit_diff=True) runs on the spectral problem and stores the
    CG residuals; a problem without the white split raises."""
    _, pt = _pair()
    res = muse_tpu_torch.MuseResult(theta=np.array([0.1]))
    muse_tpu_torch.get_H(res, pt, seed=1, nsims=5, implicit_diff=True,
                         implicit_diff_precond=pt.suggested_h_precond,
                         max_batch=2)
    assert len(res.Hs) == 5 and res.H.shape == (1, 1)
    assert len(res.metadata["implicit_diff_cg_resid"]) == 5
    assert np.isfinite(res.H).all() and res.H[0, 0] > 0
    field = tgrf.grf_field_problem(n=8, device=CPU)
    with pytest.raises(NotImplementedError, match="white split"):
        muse_tpu_torch.get_H(muse_tpu_torch.MuseResult(theta=np.array([0.1])),
                             field, nsims=2, implicit_diff=True)


# ------------------------------------------------------------------ #
# (g) the north-star pipeline at n=32: hoisted fit, reused J, implicit H
# ------------------------------------------------------------------ #

NSIMS = 64
FIT = dict(nsims=NSIMS, theta_rtol=1e-4, alpha=1.0, maxsteps=20)


def _pipeline_port(pt, **kw):
    res = muse_tpu_torch.muse_fit(muse_tpu_torch.MuseResult(), pt, 0.5,
                                  seed=1, **FIT, **kw)
    muse_tpu_torch.get_J(res, pt, nsims=NSIMS, warn_reuse=False)
    muse_tpu_torch.get_H(res, pt, nsims=8, implicit_diff=True,
                         implicit_diff_precond=pt.suggested_h_precond)
    return res


@pytest.fixture(scope="module")
def pipelines():
    pj, pt = _pair()
    rj = muse_tpu.MuseResult()
    muse_tpu.muse_fit(rj, pj, 0.5, key=jax.random.PRNGKey(1), **FIT)
    muse_tpu.get_J(rj, pj, nsims=NSIMS, key=jax.random.PRNGKey(1),
                   warn_reuse=False)
    muse_tpu.get_H(rj, pj, nsims=8, implicit_diff=True,
                   implicit_diff_precond=pj.suggested_h_precond,
                   key=jax.random.PRNGKey(1))
    rt = _pipeline_port(pt)
    mle, sig = tgrf.grf_marginal_mle(pt.x_real, pt.grf_config)
    return {"rj": rj, "rt": rt, "pt": pt, "mle": mle, "sig": sig}


def test_pipeline_theta_matches_marginal_mle(pipelines):
    th = float(pipelines["rt"].theta[0])
    assert abs(th - pipelines["mle"]) < \
        3 * pipelines["sig"] / np.sqrt(NSIMS) + 0.02


def test_pipeline_sigma_matches_fisher(pipelines):
    sig = float(pipelines["rt"].sigma[0])
    assert np.isfinite(sig)
    assert abs(sig - pipelines["sig"]) < 0.5 * pipelines["sig"]


def test_pipeline_theta_matches_muse_tpu(pipelines):
    assert abs(float(pipelines["rt"].theta[0])
               - float(pipelines["rj"].theta[0])) < 0.08


def test_pipeline_result_fields(pipelines):
    rt = pipelines["rt"]
    assert len(rt.gs) == NSIMS and len(rt.Hs) == 8
    assert len(rt.metadata["implicit_diff_cg_resid"]) == 8
    assert rt.history[-1]["map_converged"].all()
    # H and J both estimate the Fisher information at θ̂ here
    assert 0.5 < float(rt.H[0, 0]) / float(rt.J[0, 0]) < 2


def test_hoisted_and_keyed_fits_agree(pipelines):
    """hoist_sampling on and off: the same sims, so θ̂ within 1e-6."""
    rt = pipelines["rt"]
    keyed = muse_tpu_torch.muse_fit(muse_tpu_torch.MuseResult(),
                                    pipelines["pt"], 0.5, seed=1,
                                    hoist_sampling=False, **FIT)
    assert len(keyed.history) == len(rt.history)
    assert abs(float(keyed.theta[0]) - float(rt.theta[0])) < 1e-6
