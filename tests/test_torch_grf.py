"""The port's field GRF against muse_tpu's, module by module.

Inputs are made with numpy from a seed and handed to both packages (the
two packages' RNGs differ). The JAX side's quadform runs through its
Pallas kernel in interpret mode on the CPU. Tolerances: rtol 1e-5 for
single transforms and values (float32 rounding), rtol 1e-4 for
θ-gradients and muse-step scores (the two FFT libraries sum in different
orders, and the score is a difference of two O(n²) sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import muse_tpu.models.grf as jgrf
from muse_tpu.solver.compiled import CompiledProblem as JCompiled
from muse_tpu.theta import ThetaSpec as JSpec
from muse_tpu_torch import check_self_consistency, convert
from muse_tpu_torch.models import grf as tgrf
from muse_tpu_torch.ops.grf_spectrum import SpectrumQuadform
from muse_tpu_torch.solver.compiled import CompiledProblem as TCompiled
from muse_tpu_torch.theta import ThetaSpec as TSpec
from muse_tpu_torch.utils.keys import lane_generator

torch.set_num_threads(1)

N, B, SIGMA = 32, 5, 0.1


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(7)
    jcfg = jgrf.GrfConfig(N, sigma_noise=SIGMA)
    u = rng.standard_normal((B, N, N)).astype(np.float32)
    z = np.asarray(jax.vmap(lambda v: jcfg.apply_sqrtC(v, 0.2))(
        jnp.asarray(u)))
    x = (z + SIGMA * rng.standard_normal((B, N, N))).astype(np.float32)
    return {"u": u, "z": z, "x": x, "x_obs": x[0]}


@pytest.fixture(scope="module")
def problems(arrays):
    x_obs = arrays["x_obs"]
    pj = jgrf.grf_field_problem(n=N, sigma_noise=SIGMA,
                                x_obs=jnp.asarray(x_obs))
    jc = pj.grf_config
    cfg = convert.grf_config_from_arrays(N, SIGMA, jc.gamma, jc.k0,
                                         np.asarray(jc.k),
                                         np.asarray(jc.herm_weight),
                                         device="cpu")
    pt = tgrf.grf_field_problem(cfg, x_obs=convert.x_obs(x_obs,
                                                         device="cpu"))
    return pj, pt


def test_grf_config_arrays_match_jax():
    jc = jgrf.GrfConfig(N)
    tc = tgrf.GrfConfig(N, device="cpu")
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.herm_weight.numpy(),
                                  np.asarray(jc.herm_weight))


@pytest.mark.parametrize("theta", [-0.7, 0.0, 0.3])
def test_converted_config_matches_jax(arrays, theta):
    jc = jgrf.GrfConfig(N, sigma_noise=SIGMA)
    tc = convert.grf_config_from_arrays(N, SIGMA, jc.gamma, jc.k0,
                                        np.asarray(jc.k),
                                        np.asarray(jc.herm_weight),
                                        device="cpu")
    np.testing.assert_array_equal(tc.herm_weight.numpy(),
                                  np.asarray(jc.herm_weight))
    np.testing.assert_allclose(tc.spectrum(theta).numpy(),
                               np.asarray(jc.spectrum(theta)), rtol=1e-5)
    u = arrays["u"][0]
    want = np.asarray(jc.apply_sqrtC(jnp.asarray(u), theta))
    got = tc.apply_sqrtC(torch.from_numpy(u), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_log_like_and_per_lane_theta_grads(arrays, problems):
    """(x, z, θ) lanes at n=32, B=5: values and per-lane θ-gradients, and
    one batched quadform evaluation per batched call."""
    pj, pt = problems
    x, z = arrays["x"], arrays["z"]
    th = 0.3
    ll_j = jax.vmap(lambda a, b: pj.log_like(a, b, th))(jnp.asarray(x),
                                                        jnp.asarray(z))
    g_j = jax.vmap(lambda a, b: jax.grad(
        lambda t: pj.log_like(a, b, t))(jnp.float32(th)))(jnp.asarray(x),
                                                          jnp.asarray(z))
    xt, zt = torch.from_numpy(x), torch.from_numpy(z)
    tht = torch.tensor(th)
    before = SpectrumQuadform.evaluations
    ll_t = vmap(lambda a, b: pt.log_like(a, b, tht))(xt, zt)
    assert SpectrumQuadform.evaluations - before == 1
    g_t = vmap(lambda a, b: grad(lambda t: pt.log_like(a, b, t))(tht))(xt, zt)
    assert SpectrumQuadform.evaluations - before == 2
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4)
    # the per-lane loop gives the same gradients
    loop = torch.stack([grad(lambda t: pt.log_like(a, b, t))(tht)
                        for a, b in zip(xt, zt)])
    torch.testing.assert_close(g_t, loop, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("first_lane", [0, 3])
def test_one_step_parity(arrays, problems, first_lane):
    """The same xs_all, θ, Z_prev and lane ids through both packages'
    ``CompiledProblem._step_from_xs`` (first_lane=0 carries the data
    lane, 3 does not)."""
    pj, pt = problems
    xs_all = arrays["x"][::-1].copy()
    Z_prev = arrays["z"].reshape(B, -1)
    lanes = np.arange(first_lane, first_lane + B)
    th = np.array([0.25], np.float32)

    jspec = JSpec.from_example(0.5)
    jc = JCompiled(pj, jspec, jspec.flatten(0.5))
    out_j = jc._step_from_xs(jnp.asarray(xs_all), jnp.asarray(th),
                             jnp.asarray(th), jnp.asarray(Z_prev),
                             jnp.asarray(lanes), jnp.float32(1e-2))
    tspec = TSpec.from_example(0.5)
    tc = TCompiled(pt, tspec, np.array([0.5]))
    out_t = tc._step_from_xs(torch.from_numpy(xs_all), torch.from_numpy(th),
                             torch.from_numpy(th), torch.from_numpy(Z_prev),
                             torch.from_numpy(lanes), 1e-2)
    for k in ("g", "g_t"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-4)
    Zj = np.asarray(out_j["Z"])
    np.testing.assert_allclose(out_t["Z"].numpy(), Zj, rtol=0,
                               atol=1e-5 * np.abs(Zj).max())
    assert out_t["converged"].all() and not out_t["failed"].any()


def test_marginal_mle_matches_jax(arrays, problems):
    pj, pt = problems
    x = arrays["x_obs"]
    mj, sj = jgrf.grf_marginal_mle(x, pj.grf_config)
    mt, st = tgrf.grf_marginal_mle(pt.x, pt.grf_config)
    assert mt == pytest.approx(mj, rel=1e-9, abs=1e-12)
    assert st == pytest.approx(sj, rel=1e-9)


def test_sampler_draw_order_and_crn():
    """u first, then the noise, from the lane's own generator; the same
    seed gives the same whites at every θ."""
    p = tgrf.grf_field_problem(n=16, sigma_noise=SIGMA, device="cpu")
    cfg = p.grf_config
    x1, z1 = p.sample_x_z(lane_generator(5, "cpu"), 0.1)
    g = lane_generator(5, "cpu")
    u = torch.randn((16, 16), generator=g)
    e = torch.randn((16, 16), generator=g)
    torch.testing.assert_close(z1, cfg.apply_sqrtC(u, 0.1))
    torch.testing.assert_close(x1, z1 + SIGMA * e)
    x2, z2 = p.sample_x_z(lane_generator(5, "cpu"), -0.4)
    torch.testing.assert_close(x2 - z2, x1 - z1)


def test_field_model_self_consistency(problems):
    _, pt = problems
    assert check_self_consistency(pt, 0.5)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_matches_jax(arrays, use_pallas):
    """``grf_field_problem(use_pallas=)`` both ways, in both packages: the
    same batched log-likelihood and θ-score on the same inputs. With False
    the port's quadform is the plain einsum and is never counted as a
    kernel evaluation."""
    x_obs, x, z = arrays["x_obs"], arrays["x"], arrays["z"]
    pj = jgrf.grf_field_problem(n=N, sigma_noise=SIGMA,
                                x_obs=jnp.asarray(x_obs),
                                use_pallas=use_pallas)
    jc = pj.grf_config
    cfg = convert.grf_config_from_arrays(N, SIGMA, jc.gamma, jc.k0,
                                         np.asarray(jc.k),
                                         np.asarray(jc.herm_weight),
                                         device="cpu")
    pt = tgrf.grf_field_problem(cfg, x_obs=convert.x_obs(x_obs, device="cpu"),
                                use_pallas=use_pallas)
    th = -0.4
    ll_j = jax.vmap(lambda a, b: pj.log_like(a, b, th))(jnp.asarray(x),
                                                        jnp.asarray(z))
    g_j = jax.vmap(lambda a, b: jax.grad(
        lambda t: pj.log_like(a, b, t))(jnp.float32(th)))(jnp.asarray(x),
                                                          jnp.asarray(z))
    xt, zt, tht = torch.from_numpy(x), torch.from_numpy(z), torch.tensor(th)
    before = SpectrumQuadform.evaluations
    ll_t = vmap(lambda a, b: pt.log_like(a, b, tht))(xt, zt)
    g_t = vmap(lambda a, b: grad(lambda t: pt.log_like(a, b, t))(tht))(xt, zt)
    assert SpectrumQuadform.evaluations - before == (2 if use_pallas else 0)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4)
