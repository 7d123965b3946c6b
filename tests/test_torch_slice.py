"""Slice 1 end to end: the port's full MUSE pipeline on the field GRF
against the exact marginal MLE and against muse_tpu on the same data.

n=32, nsims=40, σ_noise=0.1 (σ_F ≈ 0.1; at the default σ_noise=1 the
field is so faint at n=32 that σ_F ≈ 0.8-2 and the marginal MLE of many
draws runs to θ → −∞). The two packages draw different sims, so their
agreement is statistical: the MC scatter of each θ̂ about the MLE is
≈ σ_F/√nsims ≈ 0.016, and 0.08 is ~3.5 times the scatter of the
difference (tests/test_pallas_grf.py:81 pattern).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muse_tpu
import muse_tpu.models.grf as jgrf
import muse_tpu_torch
from muse_tpu_torch import convert
from muse_tpu_torch.models import grf as tgrf

torch.set_num_threads(1)

N, NSIMS, SIGMA = 32, 40, 0.1
FIT = dict(nsims=NSIMS, maxsteps=20, theta_rtol=1e-3, get_covariance=True)


@pytest.fixture(scope="module")
def x_obs():
    rng = np.random.default_rng(42)
    cfg = jgrf.GrfConfig(N, sigma_noise=SIGMA)
    z = np.asarray(cfg.apply_sqrtC(jnp.asarray(
        rng.standard_normal((N, N)), jnp.float32), 0.0))
    return (z + SIGMA * rng.standard_normal((N, N))).astype(np.float32)


@pytest.fixture(scope="module")
def fits(x_obs):
    pj = jgrf.grf_field_problem(n=N, sigma_noise=SIGMA,
                                x_obs=jnp.asarray(x_obs))
    pt = tgrf.grf_field_problem(n=N, sigma_noise=SIGMA, x_obs=x_obs,
                                device="cpu")
    rj = muse_tpu.muse(pj, 0.5, key=jax.random.PRNGKey(1), **FIT)
    rt = muse_tpu_torch.muse(pt, 0.5, seed=1, **FIT)
    mle, sig = tgrf.grf_marginal_mle(x_obs, pt.grf_config)
    return {"pj": pj, "pt": pt, "rj": rj, "rt": rt, "mle": mle, "sig": sig}


def test_port_theta_matches_marginal_mle(fits):
    th = float(fits["rt"].theta[0])
    assert abs(th - fits["mle"]) < 3 * fits["sig"] / np.sqrt(NSIMS) + 0.02


def test_port_sigma_matches_fisher(fits):
    sig = float(fits["rt"].sigma[0])
    assert np.isfinite(sig)
    assert abs(sig - fits["sig"]) < 0.5 * fits["sig"]


def test_port_theta_matches_muse_tpu(fits):
    assert abs(float(fits["rt"].theta[0]) - float(fits["rj"].theta[0])) < 0.08


def test_port_result_fields(fits):
    rt = fits["rt"]
    assert len(rt.gs) == NSIMS and len(rt.Hs) == NSIMS // 10
    assert rt.J.shape == rt.H.shape == rt.Sigma.shape == (1, 1)
    assert rt.dist.mean == pytest.approx(float(rt.theta[0]))
    assert rt.history[-1]["map_converged"].all()
    assert rt.key == 1


def test_resume_from_a_muse_tpu_result(fits, tmp_path):
    """A muse_tpu pickle carries θ, gs and Hs across: the port's get_J on
    it reuses the 40 JAX scores (no new sims) and reproduces J."""
    f = tmp_path / "jax_result.pkl"
    fits["rj"].save(str(f))
    res = convert.result_from_muse_tpu(str(f))
    assert res.key is None
    np.testing.assert_array_equal(res.theta, np.asarray(fits["rj"].theta))
    muse_tpu_torch.get_J(res, fits["pt"], nsims=NSIMS, warn_reuse=False)
    np.testing.assert_allclose(res.J, fits["rj"].J, rtol=1e-12)
    np.testing.assert_allclose(res.Sigma, fits["rj"].Sigma, rtol=1e-10)


def test_get_H_fd_order_4_agrees_with_order_2(fits):
    """For this Gaussian model the score is smooth in θ_sim: the 5-point
    stencil and central differences agree to O(ε²)."""
    rt = fits["rt"]
    r4 = muse_tpu_torch.MuseResult(theta=rt.theta.copy(), gs=list(rt.gs))
    muse_tpu_torch.get_H(r4, fits["pt"], seed=1, nsims=NSIMS // 10,
                         fd_order=4)
    np.testing.assert_allclose(r4.H, rt.H, rtol=1e-2)


def test_max_batch_chunks_give_the_same_fit():
    p = tgrf.grf_field_problem(n=16, sigma_noise=SIGMA, data_seed=3,
                               device="cpu")
    kw = dict(nsims=12, maxsteps=4, theta_rtol=0.0, seed=2)
    a = muse_tpu_torch.muse(p, 0.5, **kw)
    b = muse_tpu_torch.muse(p, 0.5, max_batch=5, **kw)
    for ha, hb in zip(a.history, b.history):
        np.testing.assert_allclose(hb["g_like_sims_t"], ha["g_like_sims_t"],
                                   rtol=1e-5)
    np.testing.assert_allclose(b.theta, a.theta, rtol=1e-5)


def test_checkpoint_resume_continues_the_fit(tmp_path):
    p = tgrf.grf_field_problem(n=16, sigma_noise=SIGMA, data_seed=3,
                               device="cpu")
    kw = dict(nsims=12, theta_rtol=0.0, seed=2)
    full = muse_tpu_torch.muse(p, 0.5, maxsteps=4, **kw)
    f = str(tmp_path / "ckpt.pkl")
    muse_tpu_torch.muse(p, 0.5, maxsteps=2, checkpoint_file=f, **kw)
    res = muse_tpu_torch.load_result(f)
    assert len(res.history) == 2
    muse_tpu_torch.muse_fit(res, p, maxsteps=4, **kw)
    np.testing.assert_allclose(res.theta, full.theta, rtol=1e-5)
