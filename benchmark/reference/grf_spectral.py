"""Plain reference of the packed spectral GRF pipeline, and its control.

It imports nothing of the port. Frozen copies, from ``muse_tpu_torch`` at
commit f22a353:

* ``models/grf.py``: ``GrfConfig``'s rfft grid |k| and the spectrum
  C_k(θ) = e^θ (|k| + k₀)^(−γ); ``_herm_white_coeffs`` and
  ``_herm_white_draw`` (the packed hermitian white noise, drawn as two
  (n, n//2+1) normals, g then h); ``grf_spectral_problem``'s
  ``noise="marginal"`` completion x̃ = √(C+σ²)·w₁ and its analytic θ-score
  ½ Σ x̃²·C/(C+σ²)² (a sum over the L = 2·n·(n//2+1) packed coordinates,
  where C is tiled over re|im);
* ``utils/keys.py``: the seed rule (``keys.py`` here);
* ``solver/muse.py``: the θ loop with the sims-variance H⁻¹ and the
  θ_rtol stop (only the control runs it);
* ``solver/compiled.py``'s implicit-differentiation H, worked out for this
  model: with a = √C, D = C + σ², A = D/σ² and the MAP ẑ = a x̃/D, the
  per-sim H₁ + H₂ of ``h_implicit_from_whites`` is Σ C² x̃²/(2 D³), which is
  Σ C² w₁²/(2 D²) for x̃ = √D w₁.

The reference works in float64 from the same data and the same white
draws (each lane's ``torch.Generator`` seeded as the port seeds it): the
score of every lane at every θ the program reports, J at the last
iteration's θ, each sim's H and σ at θ̂, and the latent gradient
∇ũ log P(x̃, ũ | θ) = √C·x̃/σ² − (1 + C/σ²)·ũ at the MAPs that the fit's
PCG returned for a few lanes at every iteration. ``judge`` compares a
program's output with it; ``control_pipeline`` is the same mathematics put
in the program's place and computed in bfloat16, which ``judge`` has to
refuse.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import keys


@functools.lru_cache(maxsize=None)
def herm_coeffs(n: int):
    """(a, b, c, d), each (n, n//2+1) float32: re = a·g + b·flip(g),
    im = c·h + d·flip(h) with flip the row map r → (n − r) mod n."""
    nr = n // 2 + 1
    a = np.ones((n, nr), np.float32)
    b = np.zeros((n, nr), np.float32)
    c = np.ones((n, nr), np.float32)
    d = np.zeros((n, nr), np.float32)
    self_rows = [0] + ([n // 2] if n % 2 == 0 else [])
    spec_cols = [0] + ([nr - 1] if n % 2 == 0 else [])
    for col in spec_cols:
        for r in range(n):
            if r in self_rows:
                a[r, col], c[r, col] = 1.0, 0.0
            elif r < n - r:
                a[r, col] = c[r, col] = 1.0 / np.sqrt(2.0)
            else:
                a[r, col] = c[r, col] = 0.0
                b[r, col] = 1.0 / np.sqrt(2.0)
                d[r, col] = -1.0 / np.sqrt(2.0)
    return a, b, c, d


def herm_white(g: torch.Tensor, h: torch.Tensor, coeffs) -> torch.Tensor:
    """(…, n, n//2+1) normals g and h → (…, L) packed hermitian white noise
    in the dtype of ``coeffs``."""
    a, b, c, d = coeffs
    g, h = g.to(a.dtype), h.to(a.dtype)

    def flip(v):
        return torch.roll(v.flip(-2), 1, dims=-2)

    re = a * g + b * flip(g)
    im = c * h + d * flip(h)
    return torch.cat([re.flatten(-2), im.flatten(-2)], -1)


def coeff_tensors(n: int, device, dtype=torch.float64):
    return tuple(torch.tensor(v, dtype=dtype, device=device)
                 for v in herm_coeffs(n))


def lane_white(seed: int, n: int, coeffs) -> torch.Tensor:
    """A lane's w₁, the first of its two white draws, from its generator."""
    dev = coeffs[0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    shape = (n, n // 2 + 1)
    g = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    h = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return herm_white(g, h, coeffs)


def spectrum_base(cfg: dict, device) -> torch.Tensor:
    """(|k| + k₀)^(−γ) per packed coordinate (re|im tiled), float64."""
    n = cfg["n"]
    ky = np.fft.fftfreq(n) * n
    kx = np.fft.rfftfreq(n) * n
    k = np.hypot(ky[:, None], kx[None, :])
    C0 = (k + cfg["k0"]) ** (-cfg["gamma"])
    return torch.tensor(np.tile(C0.reshape(-1), 2), dtype=torch.float64,
                        device=device)


def f32(v: float) -> float:
    """θ as the program evaluates it: rounded to float32."""
    return float(np.float32(v))


def white_blocks(seeds, n, coeffs, block: int):
    """The lanes' w₁ in blocks of at most ``block`` rows."""
    for i in range(0, len(seeds), block):
        yield torch.stack([lane_white(s, n, coeffs)
                           for s in seeds[i:i + block]])


def map_grad(cfg: dict, x_obs: torch.Tensor, seed: int, thetas, lanes,
             maps) -> float:
    """The widest float64 ‖∇ũ log P(x̃, ũ | θ)‖₂ at the kept MAPs ``maps``
    ((lane, θ, ũ) from every step of the fit), in units of the tolerance
    that the configuration states, grad_z_atol·√L (``_packed_diag_pcg``'s
    stop). Infinite unless every lane of ``lanes`` has one MAP at each θ
    of ``thetas``, in order."""
    want = [f32(t) for t in thetas]
    got = {j: [th for lane, th, _ in maps if lane == j] for j in lanes}
    if any(got[j] != want for j in lanes) or len(maps) != len(lanes) * len(
            want):
        return math.inf
    dev = x_obs.device
    n, s2 = cfg["n"], cfg["sigma_noise"] ** 2
    C0 = spectrum_base(cfg, dev)
    coeffs = coeff_tensors(n, dev)
    tol = cfg["fit"]["grad_z_atol"] * math.sqrt(C0.numel())
    whites = {j: lane_white(keys.lane_seed(seed, j), n, coeffs)
              for j in lanes if j}
    worst = 0.0
    for lane, th, Z in maps:
        C2 = math.exp(th) * C0
        xt = (x_obs.to(torch.float64) if lane == 0
              else torch.sqrt(C2 + s2) * whites[lane])
        g = torch.sqrt(C2) * xt / s2 - (1.0 + C2 / s2) * Z.to(
            dev, torch.float64)
        worst = max(worst, float(torch.linalg.vector_norm(g)) / tol)
    return worst if math.isfinite(worst) else math.inf


def reference(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
              nsims_h: int, out: dict, lanes, block: int = 64) -> dict:
    """The float64 reference at the θs of a program's output ``out``, whose
    ``bulk`` holds the MAPs the fit returned for ``lanes``."""
    dev = x_obs.device
    n, s2 = cfg["n"], cfg["sigma_noise"] ** 2
    C0 = spectrum_base(cfg, dev)
    coeffs = coeff_tensors(n, dev)
    x2 = x_obs.to(torch.float64) ** 2
    thetas = torch.tensor([f32(t) for t in out["thetas"]],
                          dtype=torch.float64, device=dev)
    C2 = torch.exp(thetas)[:, None] * C0[None]              # (iters, L)
    D = C2 + s2
    g_dat = 0.5 * (x2[None] * C2 / D ** 2).sum(-1)
    F_sims = 0.5 * C2 / D                                   # x̃² = D·w₁²
    del C2, D
    seeds = keys.sim_seeds(seed, nsims)
    g_sims = []
    for W in white_blocks(seeds, n, coeffs, block):
        W2 = W * W
        g_sims.append(W2 @ F_sims.T)
        del W, W2
    g_sims = torch.cat(g_sims)                              # (nsims, iters)
    del F_sims
    ps2 = cfg["prior_std"] ** 2
    J = float(torch.var(g_sims[:, -1], correction=1))
    C2h = math.exp(f32(out["theta_hat"])) * C0
    Fh = 0.5 * C2h ** 2 / (C2h + s2) ** 2
    Hs = torch.cat([(W * W) @ Fh for W in white_blocks(
        keys.sim_seeds(seed, nsims_h, salt=1), n, coeffs, block)])
    H = float(Hs.mean())
    sigma = 1.0 / math.sqrt(H * H / J + 1.0 / ps2)
    mg = map_grad(cfg, x_obs, seed, out["thetas"], lanes,
                  out.get("bulk", {}).get("maps", []))
    return {"g_dat": g_dat.cpu().numpy(), "g_sims": g_sims.cpu().numpy(),
            "J": J, "Hs": Hs.cpu().numpy(), "H": H, "sigma": sigma,
            "map_grad": mg}


def judge(cfg: dict, out: dict, ref: dict) -> dict:
    """The numbers compared, each a gap of the program from the reference:

    * ``score_gap``: the widest gap of a lane's θ-score (the data lane's and
      every sim's) at any iteration, in units of that iteration's spread of
      the sims' scores;
    * ``theta_gap``: the θ loop followed step by step from the program's
      own state: θ₀ against the configuration's, then every θ the loop
      reaches (θ̂ last) against the damped Newton step from the θ before it
      with the reference's scores and sims-variance H⁻¹, in units of the
      reference's σ;
    * ``J_gap``, ``sigma_gap``: relative gaps; ``H_gap``: the widest
      relative gap of a sim's H;
    * ``map_grad``: the widest latent gradient at the fit's kept MAPs, in
      units of the stated tolerance (:func:`map_grad`)."""
    inf = float("inf")
    g_sims = np.asarray(out["g_sims"], np.float64)          # (iters, nsims)
    g_dat = np.asarray(out["g_dat"], np.float64)
    rs, rd = ref["g_sims"].T, ref["g_dat"]
    score_gap = theta_gap = inf
    if g_sims.shape == rs.shape and g_dat.shape == rd.shape:
        sd = rs.std(axis=1, ddof=1)
        gaps = np.concatenate([np.abs(g_sims - rs),
                               np.abs(g_dat - rd)[:, None]], 1) / sd[:, None]
        score_gap = float(np.max(gaps))
        ps2 = cfg["prior_std"] ** 2
        th = np.asarray(out["thetas"], np.float64)
        g_post = rd - rs.mean(1) - np.float32(th).astype(np.float64) / ps2
        Hinv_post = 1.0 / (-rs.var(axis=1, ddof=1) - 1.0 / ps2)
        nxt = th - cfg["fit"]["alpha"] * Hinv_post * g_post
        got = np.append(th[1:], float(out["theta_hat"]))
        theta_gap = max(abs(th[0] - cfg["theta0"]),
                        float(np.max(np.abs(got - nxt)))) / ref["sigma"]
    Hs = np.asarray(out["Hs"], np.float64)
    H_gap = (float(np.max(np.abs(Hs / ref["Hs"] - 1.0)))
             if Hs.shape == ref["Hs"].shape else inf)

    def rel(a, b):
        return abs(float(a) / b - 1.0)

    nums = {"score_gap": score_gap, "theta_gap": theta_gap,
            "J_gap": rel(out["J"], ref["J"]), "H_gap": H_gap,
            "sigma_gap": rel(out["sigma"], ref["sigma"]),
            "map_grad": ref["map_grad"]}
    return {k: (v if math.isfinite(v) else inf) for k, v in nums.items()}


def _converged(hist, rtol):
    """The port's θ_rtol test (solver/muse.py ``_theta_converged``)."""
    def metric(h0, h1):
        d = h1["theta"] - h0["theta"]
        return math.sqrt(abs(-d * h1["Hinv_post"] * d))
    if metric(hist[-2], hist[-1]) >= rtol or len(hist) < 3:
        return False
    return metric(hist[-3], hist[-2]) < rtol


def control_pipeline(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
                     nsims_h: int, lanes, dtype=torch.bfloat16,
                     block: int = 64) -> dict:
    """The reference put in the program's place, its device arithmetic in
    ``dtype``: draws, x̃, the scores, the MAPs ũ = √C·x̃/(C+σ²) of
    ``lanes`` and H in ``dtype`` (sums accumulated as torch does and
    returned in ``dtype``), the θ loop on the host in float64 as the
    program runs it. Returns output in the program's form."""
    dev = x_obs.device
    n, s2 = cfg["n"], cfg["sigma_noise"] ** 2
    fit = cfg["fit"]
    ps2 = cfg["prior_std"] ** 2
    C0 = spectrum_base(cfg, dev)
    coeffs = coeff_tensors(n, dev, torch.float32)
    W = torch.cat([w.to(dtype) for w in white_blocks(
        keys.sim_seeds(seed, nsims), n, coeffs, block)])
    xo = x_obs.to(dtype)

    def weights(th):
        C2 = (math.exp(f32(th)) * C0).to(dtype)
        D = C2 + s2
        return C2, D

    def scores(th):
        C2, D = weights(th)
        wq = C2 / (D * D)
        sqD = torch.sqrt(D)
        gs = []
        for i in range(0, nsims, block):
            xs = sqD * W[i:i + block]
            gs.append(0.5 * (xs * xs * wq).sum(-1))
        g_dat = 0.5 * (xo * xo * wq).sum()
        return float(g_dat), torch.cat(gs).double().cpu().numpy()

    def maps(th):
        C2, D = weights(th)
        return [(j, f32(th), (torch.sqrt(C2) / D * (
            xo if j == 0 else torch.sqrt(D) * W[j - 1])).float().cpu())
            for j in lanes]

    th, hist, kept = float(cfg["theta0"]), [], []
    for i in range(1, fit["maxsteps"] + 1):
        if i > 2 and _converged(hist, fit["theta_rtol"]):
            break
        kept += maps(th)
        g_dat, g_sims = scores(th)
        g_post = g_dat - g_sims.mean() - th / ps2
        Hinv_post = 1.0 / (-g_sims.var(ddof=1) - 1.0 / ps2)
        hist.append({"theta": th, "Hinv_post": Hinv_post, "g_dat": g_dat,
                     "g_sims": g_sims})
        th = th - fit["alpha"] * Hinv_post * g_post
    del W
    J = float(np.var(hist[-1]["g_sims"], ddof=1))
    C2, D = weights(th)
    Hs = []
    for Wh in white_blocks(keys.sim_seeds(seed, nsims_h, salt=1), n, coeffs,
                           block):
        xs = torch.sqrt(D) * Wh.to(dtype)
        Hs.append(0.5 * (C2 * C2 * xs * xs / (D * D * D)).sum(-1))
    Hs = torch.cat(Hs).double().cpu().numpy()
    H = float(Hs.mean())
    sigma = 1.0 / math.sqrt(H * H / J + 1.0 / ps2)
    return {"thetas": [h["theta"] for h in hist], "Hs": Hs,
            "g_dat": [h["g_dat"] for h in hist],
            "g_sims": [h["g_sims"] for h in hist],
            "theta_hat": th, "J": J, "H": H, "sigma": sigma,
            "bulk": {"maps": kept}}
