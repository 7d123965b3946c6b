"""The noisy-funnel family on the port (``muse_tpu_torch/models/funnel.py``)
against ``muse_tpu.models.funnel`` and the closed forms.

The same x_obs and the same whites (JAX's ``comp.sample_whites(keys)``)
go through both packages' ``muse_step_white``, whose latent MAPs are each
package's batched L-BFGS. Tolerances: at ``grad_z_atol = 1e-4`` both MAPs
sit within ~1e-4 of the Wiener filter, so Z agrees to 1e-3 (absolute) and
the per-lane scores to 1e-3 relative; the iteration counts within ±2.
Then the port's fits against the exact marginal MLE and the analytic H,
with Monte-Carlo tolerances as in tests/test_muse_funnel.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

import muse_tpu
from muse_tpu.models import funnel as jfun
from muse_tpu.solver.compiled import CompiledProblem as JCompiled
from muse_tpu.theta import ThetaSpec as JSpec
import muse_tpu_torch
from muse_tpu_torch import SimpleMuseProblem, check_self_consistency, convert
from muse_tpu_torch.models import funnel as tfun
from muse_tpu_torch.solver.compiled import CompiledProblem as TCompiled
from muse_tpu_torch.theta import ThetaSpec as TSpec

torch.set_num_threads(1)

DIM, BLOCKS, B = 64, 4, 6
CPU = "cpu"


@functools.lru_cache(maxsize=None)
def _pair(vector: bool):
    """(muse_tpu problem, port problem) on the JAX problem's own data."""
    if vector:
        pj = jfun.vector_funnel_problem(DIM, BLOCKS)
        pt = tfun.vector_funnel_problem(DIM, BLOCKS, device=CPU,
                                        x_obs=convert.x_obs(pj.x, CPU))
    else:
        pj = jfun.funnel_problem(DIM)
        pt = tfun.funnel_problem(DIM, device=CPU,
                                 x_obs=convert.x_obs(pj.x, CPU))
    return pj, pt


def _theta(vector, value):
    return (np.full(BLOCKS, value, np.float32) if vector
            else np.float32(value))


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("first_lane", [0, 2])
def test_muse_step_white_matches_jax(vector, first_lane):
    pj, pt = _pair(vector)
    th0 = _theta(vector, 0.5)
    jspec, tspec = JSpec.from_example(th0), TSpec.from_example(th0)
    jc = JCompiled(pj, jspec, jspec.flatten(th0))
    tc = TCompiled(pt, tspec, np.atleast_1d(th0).astype(np.float64))
    keys = jax.random.split(jax.random.PRNGKey(first_lane), B)
    W_j = jc.sample_whites(keys)
    W_t = tuple(torch.tensor(np.asarray(w)) for w in W_j)
    rng = np.random.default_rng(first_lane)
    Z_prev = (0.3 * rng.standard_normal((B, DIM))).astype(np.float32)
    lanes = np.arange(first_lane, first_lane + B)
    th = np.atleast_1d(_theta(vector, 0.2)).astype(np.float32)
    th_t = convert.theta(th, CPU)
    out_j = jc.muse_step_white(jnp.asarray(th), jnp.asarray(th), W_j,
                               jnp.asarray(Z_prev), jnp.asarray(lanes),
                               jnp.float32(1e-4))
    out_t = tc.muse_step_white(th_t, th_t, W_t, torch.from_numpy(Z_prev),
                               torch.from_numpy(lanes), 1e-4)
    np.testing.assert_allclose(out_t["Z"].numpy(), np.asarray(out_j["Z"]),
                               atol=1e-3)
    for k in ("g", "g_t"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=1e-3, atol=1e-3)
    for k in ("converged", "failed"):
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))
    assert out_t["converged"].all()
    di = np.abs(out_t["iterations"].numpy().astype(int)
                - np.asarray(out_j["iterations"]).astype(int))
    assert di.max() <= 2
    # the MAP is the Wiener filter ẑ = x·a/(1+a), a = e^θ per block
    a = np.exp(np.repeat(th, DIM // th.size))
    x_lanes = np.where((lanes == 0)[:, None], np.asarray(pj.x)[None],
                       np.asarray(W_j[0]) * np.sqrt(a) + np.asarray(W_j[1]))
    np.testing.assert_allclose(out_t["Z"].numpy(), x_lanes * a / (1 + a),
                               atol=1e-3)


@pytest.mark.parametrize("vector", [False, True])
def test_model_functions_match_jax(vector):
    """log_like, its θ- and z-gradients and the white completion on the
    same values."""
    pj, pt = _pair(vector)
    rng = np.random.default_rng(1)
    w1, w2, z = (rng.standard_normal(DIM).astype(np.float32)
                 for _ in range(3))
    th = _theta(vector, 0.3)
    xj, zj = pj.x_of_white((jnp.asarray(w1), jnp.asarray(w2)),
                           jnp.asarray(th))
    xt, zt = pt.x_of_white((torch.tensor(w1), torch.tensor(w2)),
                           torch.tensor(th))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-6)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-6)
    x = np.asarray(pj.x)
    lj = jax.value_and_grad(pj.log_like, argnums=(1, 2))(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(th))
    tt, zz = torch.tensor(th), torch.tensor(z)
    lt = pt.log_like(torch.tensor(x), zz, tt)
    gz, gt = grad(pt.log_like, argnums=(1, 2))(torch.tensor(x), zz, tt)
    np.testing.assert_allclose(float(lt), float(lj[0]), rtol=1e-6)
    np.testing.assert_allclose(gz.numpy(), np.asarray(lj[1][0]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(gt.numpy(), np.asarray(lj[1][1]), rtol=1e-5)
    np.testing.assert_allclose(float(pt.log_prior(tt)),
                               float(pj.log_prior(jnp.asarray(th))),
                               rtol=1e-6)


@pytest.mark.parametrize("vector", [False, True])
def test_self_consistency(vector):
    _, pt = _pair(vector)
    assert check_self_consistency(pt, _theta(vector, 0.4))


def _exact_mle(x) -> float:
    x = np.asarray(x, np.float64)
    return float(np.log(np.sum(x ** 2) / x.size - 1))


@pytest.fixture(scope="module")
def fitted():
    _, pt = _pair(False)
    return pt, muse_tpu_torch.muse(pt, 1.0, nsims=32, maxsteps=20,
                                   theta_rtol=1e-3, get_covariance=True,
                                   seed=1)


def _mc_bound(res, nsims):
    """MUSE θ̂ differs from the MLE by Monte-Carlo noise ~σ/√nsims."""
    return 3 * float(res.sigma[0]) / np.sqrt(nsims) + 0.02


def test_fit_theta_matches_exact_mle(fitted):
    pt, res = fitted
    assert abs(float(res.theta[0]) - _exact_mle(pt.x)) < _mc_bound(res, 32)
    z = abs(float(res.theta[0])) / float(res.sigma[0])
    assert z < 2.0                          # the reference's oracle


def test_fit_H_matches_analytic(fitted):
    _, res = fitted
    th = float(res.theta[0])
    expected = tfun.funnel_analytic_H(th, DIM)
    per_sim_std = np.std([h[0, 0] for h in res.Hs], ddof=1)
    tol = 4 * per_sim_std / np.sqrt(len(res.Hs)) + 0.05 * expected
    assert abs(float(res.H[0, 0]) - expected) < tol
    assert res.history[-1]["map_converged"].all()
    assert max(int(h["map_iterations"].max()) for h in res.history) > 0


def test_vector_funnel_fit():
    _, pt = _pair(True)
    res = muse_tpu_torch.muse(pt, np.zeros(BLOCKS), nsims=24, maxsteps=15,
                              theta_rtol=1e-2, get_covariance=True, seed=2)
    assert res.theta.shape == (BLOCKS,) and np.isfinite(res.theta).all()
    assert (np.diag(res.H) > 0).all() and np.isfinite(res.sigma).all()
    # per-block exact MLEs (independent blocks) within 3σ
    x = np.asarray(pt.x, np.float64).reshape(BLOCKS, -1)
    mle = np.log(np.sum(x ** 2, axis=1) / x.shape[1] - 1)
    assert (np.abs(res.theta - mle) < 3 * res.sigma).all()


def test_simple_problem_without_custom_zhat_runs():
    """The SimpleMuseProblem docstring's funnel, at D=64: no custom_zhat,
    so the MAPs are the batched L-BFGS."""
    D = 64

    def sample_x_z(gen, theta):
        z = torch.exp(theta / 2) * torch.randn(D, generator=gen)
        return z + torch.randn(D, generator=gen), z

    def log_like(x, z, theta):
        return -0.5 * (((x - z) ** 2).sum() + (z ** 2).sum() / torch.exp(theta)
                       + D * theta)

    x, _ = sample_x_z(torch.Generator().manual_seed(42), torch.tensor(0.0))
    prob = SimpleMuseProblem(x, sample_x_z, log_like, lambda t: -t ** 2 / 18)
    res = muse_tpu_torch.muse(prob, 1.0, nsims=24, theta_rtol=1e-3,
                              get_covariance=True, seed=4)
    assert abs(float(res.theta[0]) - _exact_mle(x)) < _mc_bound(res, 24)
    assert res.history[-1]["map_iterations"].max() > 0


def test_adaptive_fd_steps_match_jax():
    """fd_order="adaptive" from a 100×-too-large step: both packages
    rebalance the step by the same clipped factors (the draws differ, the
    clip does not), and the port's H lands near the analytic value where
    fd_order=4 at the bad step does not."""
    pj, pt = _pair(False)
    bad_step = 5.0
    rj = muse_tpu.MuseResult()
    muse_tpu.get_H(rj, pj, 0.0, key=jax.random.PRNGKey(13), nsims=4,
                   step=bad_step, fd_order="adaptive", grad_z_atol=1e-3)
    rt, r4 = muse_tpu_torch.MuseResult(), muse_tpu_torch.MuseResult()
    muse_tpu_torch.get_H(rt, pt, 0.0, seed=13, nsims=4, step=bad_step,
                         fd_order="adaptive", grad_z_atol=1e-3)
    muse_tpu_torch.get_H(r4, pt, 0.0, seed=13, nsims=4, step=bad_step,
                         fd_order=4, grad_z_atol=1e-3)
    mj, mt = rj.metadata["fd_adaptive"], rt.metadata["fd_adaptive"]
    assert len(mt) == len(mj) >= 2
    for a, b in zip(mt, mj):
        np.testing.assert_allclose(a["step"], b["step"], rtol=1e-12)
        assert a["roundoff"].shape == a["trunc"].shape == (1,)
    assert mt[-1]["step"][0] < bad_step
    expected = tfun.funnel_analytic_H(0.0, DIM)
    err_a = abs(float(rt.H[0, 0]) - expected) / expected
    err_4 = abs(float(r4.H[0, 0]) - expected) / expected
    assert err_a < 0.15 and err_a < err_4
    assert len(rt.Hs) == 4
