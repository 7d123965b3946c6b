"""The port's field GRF against the benchmark's plain float64 reference
(``benchmark/reference/grf_field.py``), on the CPU at 16² and 32² with
seeded data and lane seeds: the keyed per-lane draws, the forward, the
log-density, the Wiener MAP, the analytic θ-score (and the reference's
against autograd of its own log-density), ``get_H``'s finite-difference H
against the reference's and against its analytic H, and the θ loop of a fit
replayed from the fit's own state.

Each tolerance is float32's: the port computes in float32 and the
reference in float64 from the same inputs, so a gap is the port's rounding
(ε₃₂ ≈ 1.2e-7) grown by the transforms and sums, bounded with room as
stated at each comparison; the same comparison with the port's input
rounded to bfloat16 (ε ≈ 3.9e-3) fails it."""

import warnings

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import grf_field as ref
from muse_tpu_torch import MuseResult, ThetaSpec, get_H, get_J, muse_fit
from muse_tpu_torch.models import grf_field_problem
from muse_tpu_torch.solver import CompiledProblem

CFG = run.cell_spec("grf_field_1024.sims100")["config"]
SEEDS = [5, 6, 7]
#: the forward's gap in units of max|x|: an rfft2, a multiply and an irfft2
#: of n² values, each rounding at ε₃₂ relative to |x|; ~8 ε₃₂ (read:
#: ≤ 1.7e-7)
FWD_TOL = 1e-6
#: the log-density's gap in units of the sum of its terms' magnitudes
#: (Σ(x−z)²/σ², the quadform, Σw|log C|): float32 sums of n² terms, ~8 ε₃₂
#: (read: ≤ 2.1e-8)
LOGP_TOL = 1e-6
#: the Wiener MAP's relative L2 gap: a transform pair and one multiply
#: (read: ≤ 1.9e-7)
MAP_TOL = 1e-6
#: the θ-score's gap in units of Σ|terms| (½Σw|ẑ|²/C/n² and ½Σw): a
#: transform, the quadform's sum and the subtraction (read: ≤ 2.0e-7)
SCORE_TOL = 1e-6


def _pair(n):
    cfg = dict(CFG, n=n)
    prob = grf_field_problem(n=n, sigma_noise=cfg["sigma_noise"],
                             gamma=cfg["gamma"], k0=cfg["k0"],
                             prior_std=cfg["prior_std"], device="cpu")
    return cfg, prob, ref.Field(cfg, "cpu")


def _lanes(prob, theta):
    """The keyed route's lanes of ``SEEDS`` at θ, and the reference's
    draws of the same lanes."""
    spec = ThetaSpec.from_example(0.0)
    comp = CompiledProblem(prob, spec, spec.flatten(theta))
    th = torch.tensor([theta])
    xs, Zs = comp._sample_batch(SEEDS, [th] * len(SEEDS))
    u, e = ref.lane_draws(SEEDS, prob.grf_config.n, "cpu")
    return xs, Zs, u, e, spec.unflatten(th)


def _fwd_gap(x, xr):
    return float((x.double() - xr).abs().max() / xr.abs().max())


def _logp_gap(prob, m, x, z, theta, t0, dtype=torch.float32):
    """The port's log-density on x and z in ``dtype`` (bfloat16: rounded,
    then computed in float32) against the reference's on the exact ones,
    in units of the sum of its terms' sizes."""
    lp = float(prob.log_like(x.to(dtype).float(), z.to(dtype).float(), t0))
    x64, z64 = x.double(), z.double()
    lr = float(m.log_p(x64, z64, theta))
    C = m.C(theta)
    zf = torch.fft.rfft2(z64)
    size = float(((x64 - z64) ** 2).sum() / m.s2
                 + (m.w * zf.abs() ** 2 / C).sum() / m.n ** 2
                 + (m.w * torch.log(C).abs()).sum())
    return abs(lp - lr) / size


def _map_gap(Z, zr):
    return float(((Z.double() - zr).flatten(1).norm(dim=1)
                  / zr.flatten(1).norm(dim=1)).max())


def _score_gap(prob, m, x, z64, theta, t0, dtype=torch.float32):
    """The port's score on the latent in ``dtype`` (bfloat16: rounded, then
    computed in float32) against the reference's on the exact latent, in
    units of Σ|terms|."""
    s = float(prob.grad_theta_log_like(x, z64.to(dtype).float(), t0))
    zf = torch.fft.rfft2(z64)
    size = float((0.5 * m.w * zf.abs() ** 2 / m.C(theta)).sum() / m.n ** 2
                 + 0.5 * m.wsum)
    return abs(s - float(m.score(z64, theta))) / size


def _near(Z, n, seed):
    g = torch.Generator().manual_seed(seed)
    Z = Z.reshape(-1, n, n)
    return Z + 0.1 * Z.std() * torch.randn(Z.shape, generator=g)


@pytest.mark.parametrize("n", [16, 32])
def test_keyed_draws_and_forward_match_the_reference(n):
    """The keyed route draws each lane bitwise as the reference does (the
    port's own forward on the reference's draws gives its x and z bit for
    bit), and the float64 forward is within float32's rounding."""
    cfg, prob, m = _pair(n)
    gc = prob.grf_config
    for theta in (0.3, -0.4):
        xs, Zs, u, e, t0 = _lanes(prob, theta)
        z = torch.stack([gc.apply_sqrtC(v, t0) for v in u])
        assert torch.equal(Zs.reshape(-1, n, n), z)
        assert torch.equal(xs, z + gc.sigma_noise * e)
        xr = m.x_of(u.double(), e.double(), theta)
        assert _fwd_gap(xs, xr) <= FWD_TOL
        # a bfloat16 white field fails it
        zb = torch.stack([gc.apply_sqrtC(v, t0)
                          for v in u.bfloat16().float()])
        assert _fwd_gap(zb + gc.sigma_noise * e, xr) > FWD_TOL


@pytest.mark.parametrize("n", [16, 32])
def test_log_density_and_map_match_the_reference(n):
    cfg, prob, m = _pair(n)
    for theta in (0.3, -0.4):
        xs, Zs, u, e, t0 = _lanes(prob, theta)
        z = _near(Zs, n, 1)
        for i in range(len(SEEDS)):
            assert _logp_gap(prob, m, xs[i], z[i], theta, t0) <= LOGP_TOL
        assert max(_logp_gap(prob, m, xs[i], z[i], theta, t0,
                             torch.bfloat16)
                   for i in range(len(SEEDS))) > LOGP_TOL
        th = torch.tensor([theta])
        zr = m.wiener(xs.double(), theta)
        Z, aux = prob.custom_zhat(xs, None, th, 1e-2)
        assert bool(aux["converged"].all())
        assert _map_gap(Z.reshape(-1, n, n), zr) <= MAP_TOL
        Zb, _ = prob.custom_zhat(xs.bfloat16().float(), None, th, 1e-2)
        assert _map_gap(Zb.reshape(-1, n, n), zr) > MAP_TOL


@pytest.mark.parametrize("n", [16, 32])
def test_theta_score_matches_the_reference_and_its_autograd(n):
    """The port's analytic score at the MAP and at a latent off it; the
    reference's closed form against autograd of its own log-density in
    float64 (≤ 1e-12 of Σ|terms|; read ≤ 6e-17)."""
    cfg, prob, m = _pair(n)
    for theta in (0.3, -0.4):
        xs, Zs, u, e, t0 = _lanes(prob, theta)
        zr = m.wiener(xs.double(), theta)
        off = _near(Zs, n, 2).double()
        worst_bf16 = 0.0
        for i in range(len(SEEDS)):
            for z64 in (zr[i], off[i]):
                assert _score_gap(prob, m, xs[i], z64, theta, t0) \
                    <= SCORE_TOL
                worst_bf16 = max(worst_bf16, _score_gap(
                    prob, m, xs[i], z64, theta, t0, torch.bfloat16))
                tt = torch.tensor(ref.f32(theta), dtype=torch.float64,
                                  requires_grad=True)
                ga, = torch.autograd.grad(m.log_p(xs[i].double(), z64, tt),
                                          tt)
                zf = torch.fft.rfft2(z64)
                size = float((0.5 * m.w * zf.abs() ** 2 / m.C(theta)).sum()
                             / n ** 2 + 0.5 * m.wsum)
                assert abs(float(ga) - float(m.score(z64, theta))) \
                    <= 1e-12 * size
        assert worst_bf16 > SCORE_TOL


def _fit(n, nsims=16, nh=4, seed=3):
    """A fit with the cell's θ loop, J from its scores and FD H, and its
    output in the benchmark's form."""
    cfg, prob, m = _pair(n)
    fit = CFG["fit"]
    res = MuseResult()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        muse_fit(res, prob, cfg["theta0"], nsims=nsims,
                 theta_rtol=fit["theta_rtol"], maxsteps=fit["maxsteps"],
                 alpha=fit["alpha"], Hinv_update=fit["Hinv_update"],
                 seed=seed)
        get_J(res, prob, nsims=nsims, seed=seed, warn_reuse=False)
        get_H(res, prob, nsims=nh, fd_order=2, seed=seed)
    h = res.history
    out = {"thetas": [float(x["theta"][0]) for x in h],
           "theta_ts": [float(x["theta_t"][0]) for x in h],
           "g_dat": [float(x["g_like_dat_t"][0]) for x in h],
           "g_sims": [np.asarray(x["g_like_sims"])[:, 0] for x in h],
           "theta_hat": float(res.theta[0]), "sigma": float(res.sigma[0]),
           "J": float(res.J[0, 0]), "Hs": [float(x[0, 0]) for x in res.Hs]}
    cfg = dict(cfg, h=dict(CFG["h"], nsims=nh))
    return cfg, prob, out, ref.reference(cfg, prob.x, seed, nsims, out, [])


@pytest.mark.parametrize("n", [16, 32])
def test_fd_H_matches_the_reference_and_the_analytic_H(n):
    """``get_H``'s per-sim H at its default step and stencil against the
    reference's float64 FD H at the same θ̂ ± ε (≤ 2e-4 relative; read
    ≤ 2.1e-5: Δg = 2εH is ~1e-2 of the score's Σ|terms| at ε = 0.1/sd, so
    float32's ~1e-6 of Σ|terms| in each g is ~1e-4 of H), and the
    reference's FD H against its analytic dg/dθ_sim: central differences
    err by ε²/6·g'''/g', and g''' ≈ g' for this score (its θ_sim
    dependence is e^θ_sim and e^{θ_sim/2}), so within ε²/3 (read ε²/6)."""
    cfg, prob, out, r = _fit(n)
    rel = np.abs(np.asarray(out["Hs"]) / r["Hs"] - 1.0)
    assert rel.max() <= 2e-4, rel
    fd = np.abs(r["Hs"] / r["Hs_analytic"] - 1.0)
    assert fd.max() <= r["step"] ** 2 / 3, (fd, r["step"])
    nums = ref.judge(cfg, out, r)
    for k in ("score_gap", "J_gap", "H_gap", "sigma_gap", "theta_gap"):
        assert nums[k] <= cfg["limits"][k], nums


def test_theta_loop_replays_the_fit():
    """A 32² fit with the cell's θ loop (sims-variance H⁻¹, α 0.7,
    θ_rtol 1e-5, 20 steps): the float64 replay from the fit's own scores
    reaches every θ the fit ran at and θ̂ within 1e-9 (the prior's float32
    gradient is the only difference), and stops where it stopped."""
    cfg, prob, out, r = _fit(32)
    assert len(out["thetas"]) >= 3
    assert ref.theta_gap(cfg, out) <= 1e-9
    short = {k: (v[:-1] if isinstance(v, list) else v)
             for k, v in out.items()}
    assert ref.theta_gap(cfg, short) == float("inf")
