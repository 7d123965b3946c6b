"""The port's lensing model against the benchmark's plain float64 reference
(``benchmark/reference/lensing.py``), on the CPU at 16² and 32² with seeded
whites: the forward x_of_white, the log-density, its latent gradient and
the analytic θ-score at random latents, implicit H at a solved MAP, and the
θ loop of a fit replayed from the fit's own scores.

Each tolerance is float32's: the port computes in float32 and the
reference in float64 from the same inputs, so a gap is the port's rounding
(ε₃₂ ≈ 1.2e-7) grown by the transforms and sums, bounded with room as
stated at each comparison."""

import warnings

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import lensing as ref
from muse_tpu_torch import MuseResult, ThetaSpec, muse_fit
from muse_tpu_torch.models import lensing_problem
from muse_tpu_torch.solver import CompiledProblem
from muse_tpu_torch.utils.keys import lane_generator

CFG = run.cell_spec("lensing_1024.sims64")["config"]


def _pair(n):
    cfg = dict(CFG, n=n)
    prob = lensing_problem(n=n, sigma_noise=cfg["sigma_noise"],
                           gamma_z=cfg["gamma_z"], gamma_phi=cfg["gamma_phi"],
                           defl_scale=cfg["defl_scale"], device="cpu")
    return cfg, prob, ref.Lensing(cfg, "cpu")


def _latent(prob, n, seed, theta):
    """A lane's whites, its x at θ, and a latent near its truth."""
    W = prob.sample_white(lane_generator(seed, "cpu"))
    x, z = prob.x_of_white(W, torch.tensor(theta))
    g = torch.Generator().manual_seed(seed + 1)
    U = torch.cat([z["uphi"].reshape(-1), z["uz"].reshape(-1)]) \
        + 0.1 * torch.randn(2 * n * n, generator=g)
    u = {"uphi": U[:n * n].reshape(n, n), "uz": U[n * n:].reshape(n, n)}
    return W, x, U, u


@pytest.mark.parametrize("n", [16, 32])
def test_x_and_log_density_match_the_reference(n):
    cfg, prob, m = _pair(n)
    for seed, theta in ((3, 0.3), (4, -0.2), (5, 0.6)):
        W, x, U, u = _latent(prob, n, seed, theta)
        xr = m.x_of_white(*(w.double() for w in W), theta)
        # float32 forward: four transforms and the Taylor sums, each
        # rounding at ε₃₂ relative to |x|; 1e-5 of max|x| is ~80 ε₃₂
        assert float((x.double() - xr).abs().max()) <= 1e-5 * float(
            xr.abs().max())
        lp = float(prob.log_like(x, u, torch.tensor(theta)))
        lpr = float(m.log_p(x.double(), U.double(), theta))
        # a float32 sum of 3n² squares: relative rounding ≲ n²·ε₃₂ worst
        # case, ~√(n²)·ε₃₂ in practice; 1e-6 relative
        assert abs(lp / lpr - 1.0) <= 1e-6


@pytest.mark.parametrize("n", [16, 32])
def test_latent_gradient_and_theta_score_match_the_reference(n):
    cfg, prob, m = _pair(n)
    for seed, theta in ((6, 0.3), (7, 0.0)):
        W, x, U, u = _latent(prob, n, seed, theta)
        th = torch.tensor(theta)
        _, g = prob.value_and_grad(x[None], th.reshape(1))(U[None])
        gr = m.grad_u(x.double(), U.double(), theta)
        # the port's gradient of −log P; entries of up to ~(x − F)/σ²
        # through two transform pairs: 2e-5 of the largest entry
        assert float((g[0].double() + gr).abs().max()) <= 2e-5 * float(
            gr.abs().max())
        s = float(prob.grad_theta_log_like(x, u, th))
        uz, uphi = m.split(U.double())
        F, lin, quad = m.parts(uz, uphi, theta)
        terms = (x.double() - F) * (lin + quad) / (2 * m.s2)
        sr = float(m.score(x.double(), U.double(), theta))
        assert abs(sr - float(terms.sum())) <= 1e-9 * float(terms.abs().sum())
        # the score is a sum of n² terms of both signs that cancel: its
        # float32 error is bounded by ε₃₂ times the sum of their magnitudes
        # (times the depth of the sum); 1e-5 of Σ|terms| is ~80 ε₃₂
        assert abs(s - sr) <= 1e-5 * float(terms.abs().sum())


def test_implicit_H_at_a_solved_map_matches_the_reference():
    """H₁ + H₂ of two sims at the port's own fiducial MAPs, the port's
    HVP CG run near float32's floor (1e-8 relative, 300 steps; its
    residual stalls at ~1e-4 of ‖b‖): the reference's float64 H at the
    same MAPs within 2e-5 relative (read: ≤ 2e-6). At the port's default
    CG (1e-6, 100 steps) the residual stays at ~1e-2 and the gap reads up
    to ~2e-4, which the benchmark's H_gap sees."""
    n = 16
    cfg, prob, m = _pair(n)
    spec = ThetaSpec.from_example(0.0)
    comp = CompiledProblem(prob, spec, spec.flatten(0.0))
    W = comp.sample_whites([11, 12])
    th = torch.tensor([0.0])
    kept = {}
    solve = comp._solve_maps

    def keep(xs, Z0, t, atol):
        kept["Z"], kept["aux"] = solve(xs, Z0, t, atol)
        return kept["Z"], kept["aux"]
    comp._solve_maps = keep
    Hs, _ = comp.h_implicit_from_whites(W, th, 1e-3, 300, 1e-8, False,
                                        prob.suggested_h_precond)
    assert bool(kept["aux"]["converged"].all())
    Hr = m.h_sims(tuple(w.double() for w in W), kept["Z"].double(),
                  float(th[0]), 1e-10, 200)
    rel = (Hs.flatten().double() / Hr - 1.0).abs()
    assert float(rel.max()) <= 2e-5, (Hs.flatten(), Hr)
    # the MAPs are stationary in float64 to the fit's tolerance
    xs = m.x_of_white(*(w.double() for w in W), float(th[0]))
    sup = m.grad_u(xs, kept["Z"].double(), float(th[0])).abs().amax(-1)
    assert float(sup.max()) < 1e-3 * 1.01


def test_theta_loop_replays_the_fit():
    """A 16² fit with the example's flagship θ loop (Broyden H⁻¹, α 0.3,
    the ±0.3 clamp): the reference's float64 replay from the fit's own
    scores reaches every θ the fit ran at and θ̂ within 1e-6 of σ-scale
    (float32 θ on the card, float64 on the host), and stops where it
    stopped."""
    n, nsims = 16, 6
    cfg, prob, m = _pair(n)
    cfg = dict(cfg, fit=dict(CFG["fit"], maxsteps=6, theta_rtol=3e-2))
    prev = {"th": np.zeros(1)}

    def clamp(th_t):
        th_t = np.clip(th_t, prev["th"] - 0.3, prev["th"] + 0.3)
        prev["th"] = np.asarray(th_t)
        return th_t

    res = MuseResult()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        muse_fit(res, prob, 0.0, nsims=nsims, z0=prob.suggested_z0,
                 alpha=0.3, Hinv_update="broyden", regularize=clamp,
                 grad_z_atol=3e-3, theta_rtol=cfg["fit"]["theta_rtol"],
                 maxsteps=cfg["fit"]["maxsteps"], seed=3)
    h = res.history
    out = {"theta_ts": [float(x["theta_t"][0]) for x in h],
           "g_dat": [float(x["g_like_dat_t"][0]) for x in h],
           "g_sims": [np.asarray(x["g_like_sims_t"])[:, 0] for x in h],
           "theta_hat": float(res.theta[0])}
    assert len(h) >= 3
    assert ref.theta_gap(cfg, out) <= 1e-6
    # one step fewer is a loop that stops elsewhere
    short = {k: (v[:-1] if isinstance(v, list) else v)
             for k, v in out.items()}
    assert ref.theta_gap(cfg, short) == float("inf")
