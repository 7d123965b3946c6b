"""Plain reference of the field GRF pipeline, and its control.

It imports nothing of the port. Frozen copies, from ``muse_tpu_torch`` at
commit cc9e58c:

* ``models/grf.py``: ``GrfConfig``'s rfft grid |k|, its hermitian weights
  w (1 in the columns 0 and n/2, 2 elsewhere) and the spectrum
  C_k(θ) = e^θ (|k| + k₀)^(−γ); ``grf_field_problem``'s sampler (a lane's
  generator draws the white field u, then the noise ε, each an (n, n)
  float32 normal; x = F⁻¹(√C·F u) + σ·ε), its log-density
  −½ [Σ(x − z)²/σ² + Σ_k w|ẑ_k|²/C_k/n² + Σ_k w log C_k], its Wiener MAP
  ẑ = C·x̂/(C + σ²) and its analytic θ-score ½ Σ w|ẑ|²/C/n² − ½ Σ w;
* ``utils/keys.py``: the seed rule (``keys.py`` here);
* ``solver/muse.py``: the θ loop with the sims-variance H⁻¹, a constant
  α, the doubly guarded θ_rtol stop and ``maxsteps``;
* ``solver/jacobians.py``: ``get_H``'s finite differences at
  ``fd_order=2``: the step ε = 0.1/sd of the sims' scores the fit left
  (the last step's, which ``get_J`` reuses), each H sim redrawn with its
  own seed at θ̂ ± ε (θ rounded to float32 as the program perturbs it),
  its Wiener MAP at θ̂ and its score at θ̂, and H = (g₊ − g₋)/(2ε).

The reference works in float64 (plain torch, TF32 off) from the same data
and the same draws: each lane's ``torch.Generator`` on the data's device,
seeded as the port seeds it. In Fourier space a lane
is three planes, |û|², Re(û·ε̂*) and |ε̂|², from which |x̂(θ)|² at any θ
follows, so every lane's score at every θ the program reports, J, each H
sim's finite-difference H and its analytic dg/dθ_sim come without an
inverse transform. The MAP is closed-form and unique, so the kept MAPs are
recomputed lane by lane and compared whole (``map_gap``), and their
float64 stationarity is read besides (``map_grad``). ``judge`` compares a
program's output with it; ``control_pipeline`` is the same mathematics put
in the program's place with every stored array rounded to bfloat16, which
``judge`` has to refuse.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import keys

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def f32(v: float) -> float:
    """θ as the program evaluates it: rounded to float32."""
    return float(np.float32(v))


class Field:
    """The field GRF of one configuration on ``device``, in ``dtype``
    (float64 for the reference)."""

    def __init__(self, cfg: dict, device, dtype=torch.float64):
        n = cfg["n"]
        self.n, self.dev, self.real = n, torch.device(device), dtype
        self.sigma = cfg["sigma_noise"]
        self.s2 = self.sigma ** 2
        ky = np.fft.fftfreq(n) * n
        kx = np.fft.rfftfreq(n) * n
        k = np.hypot(ky[:, None], kx[None, :])
        w = np.full((n, n // 2 + 1), 2.0)
        w[:, 0] = 1.0
        if n % 2 == 0:
            w[:, -1] = 1.0
        self.C0 = torch.tensor((k + cfg["k0"]) ** (-cfg["gamma"]),
                               dtype=dtype, device=self.dev)
        self.w = torch.tensor(w, dtype=dtype, device=self.dev)
        self.wsum = float(w.sum())

    def C(self, th):
        """C(θ) on the rfft grid; a float θ is taken as float32 rounds it."""
        if isinstance(th, torch.Tensor):
            return torch.exp(th) * self.C0
        return math.exp(f32(th)) * self.C0

    def rfft2(self, v):
        return torch.fft.rfft2(v, dim=(-2, -1))

    def irfft2(self, v):
        return torch.fft.irfft2(v, s=(self.n, self.n), dim=(-2, -1))

    def x_of(self, u, e, th):
        """x = F⁻¹(√C(θ)·F u) + σ·ε, lane by lane."""
        return self.irfft2(torch.sqrt(self.C(th)) * self.rfft2(u)) \
            + self.sigma * e

    def log_p(self, x, z, th):
        """log P(x, z | θ) of each lane, up to its constant."""
        C = self.C(th)
        zf = self.rfft2(z)
        quad = (self.w * (zf.real ** 2 + zf.imag ** 2) / C).sum((-2, -1)) \
            / self.n ** 2
        logdet = (self.w * torch.log(C)).sum()
        return -0.5 * (((x - z) ** 2).sum((-2, -1)) / self.s2 + quad
                       + logdet)

    def score(self, z, th):
        """∂θ log P(x, z | θ) at any z: ½ Σ w|ẑ|²/C/n² − ½ Σ w."""
        zf = self.rfft2(z)
        return 0.5 * (self.w * (zf.real ** 2 + zf.imag ** 2)
                      / self.C(th)).sum((-2, -1)) / self.n ** 2 \
            - 0.5 * self.wsum

    def wiener(self, x, th):
        """The MAP ẑ = F⁻¹(C·x̂/(C + σ²)) of each lane."""
        C = self.C(th)
        return self.irfft2(C / (C + self.s2) * self.rfft2(x))

    def grad_z(self, x, z, th):
        """∇z log P(x, z | θ) = (x − z)/σ² − F⁻¹(ẑ/C)."""
        return (x - z) / self.s2 - self.irfft2(self.rfft2(z) / self.C(th))

    # -- the closed forms at the MAP, from a lane's spectral planes ------ #

    def planes(self, u, e):
        """(|û|², Re(û·ε̂*), |ε̂|²) of each lane, each (…, n, n//2+1)."""
        U, E = self.rfft2(u.to(self.real)), self.rfft2(e.to(self.real))
        return (U.real ** 2 + U.imag ** 2, U.real * E.real + U.imag * E.imag,
                E.real ** 2 + E.imag ** 2)

    def power_weights(self, th_sim):
        """(a, b, c) with |x̂(θ_sim)|² = a·|û|² + b·Re(û·ε̂*) + c·|ε̂|²."""
        Cs = self.C(th_sim)
        return Cs, 2.0 * self.sigma * torch.sqrt(Cs), \
            torch.full_like(Cs, self.s2)

    def score_weight(self, th):
        """q with the MAP score at θ = Σ q·|x̂|² − ½ Σ w:
        q = ½ w·C/(C + σ²)²/n², since |ẑ|²/C = C|x̂|²/(C + σ²)²."""
        C = self.C(th)
        return 0.5 * self.w * C / (C + self.s2) ** 2 / self.n ** 2


def lane_draws(seeds, n: int, device) -> tuple:
    """Each lane's (u, ε), its generator's two (n, n) float32 normals in
    the port's order, stacked."""
    us, es = [], []
    for s in seeds:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(s))
        us.append(torch.randn((n, n), generator=gen, device=device,
                              dtype=torch.float32))
        es.append(torch.randn((n, n), generator=gen, device=device,
                              dtype=torch.float32))
    return torch.stack(us), torch.stack(es)


def _blocks(idx, size: int):
    for i in range(0, len(idx), size):
        yield idx[i:i + size]


def make_data(cfg: dict, seed: int, count: int, device,
              block: int = 16) -> torch.Tensor:
    """``count`` observed maps (count, n, n), float32, drawn at
    ``theta_true``: one generator on ``device`` draws every map's u and ε
    a block at a time, and the forward runs in float64."""
    n = cfg["n"]
    m = Field(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = []
    for b in _blocks(list(range(count)), block):
        shape = (len(b), n, n)
        u = torch.randn(shape, generator=gen, device=device)
        e = torch.randn(shape, generator=gen, device=device)
        out.append(m.x_of(u.double(), e.double(),
                          cfg["theta_true"]).float())
    return torch.cat(out).contiguous()


# ---------------------------------------------------------------------- #
# the θ loop


class ThetaLoop:
    """``muse_fit``'s host loop for a scalar θ without a bijector, with
    ``Hinv_update="sims"`` and a constant α, in float64."""

    def __init__(self, cfg: dict):
        fit = cfg["fit"]
        self.alpha, self.rtol = fit["alpha"], fit["theta_rtol"]
        self.maxsteps = fit["maxsteps"]
        self.ps2 = cfg["prior_std"] ** 2
        self.th = float(cfg["theta0"])          # θ the next step runs at
        self.hist = []

    def done(self) -> bool:
        """Whether the loop stops before its next step."""
        i = len(self.hist) + 1
        return i > self.maxsteps or (i > 2 and self._converged())

    def _metric(self, h0, h1) -> float:
        d = h1["theta"] - h0["theta"]
        return math.sqrt(abs(-d * h1["Hinv_post"] * d))

    def _converged(self) -> bool:
        h = self.hist
        if self._metric(h[-2], h[-1]) >= self.rtol or len(h) < 3:
            return False
        return self._metric(h[-3], h[-2]) < self.rtol

    def step(self, g_dat: float, g_sims) -> float:
        """Take the step from the scores at ``self.th``; returns θ after
        it, where the loop goes on from."""
        g_sims = np.asarray(g_sims, np.float64)
        th = self.th
        g_post = g_dat - g_sims.mean() - f32(th) / self.ps2
        Hinv_post = 1.0 / (-g_sims.var(ddof=1) - 1.0 / self.ps2)
        self.hist.append({"theta": th, "Hinv_post": Hinv_post})
        self.th = th - self.alpha * Hinv_post * g_post
        return self.th


def theta_gap(cfg: dict, out: dict) -> float:
    """The widest gap, in θ units, of the program's θ loop from its float64
    replay on the program's own scores, step by step from the program's
    own state (each step taken from the θ the program ran it at); infinite
    where the replay stops at another step."""
    loop = ThetaLoop(cfg)
    th = list(out["theta_ts"])
    gap, nxt = 0.0, None
    for i in range(len(th)):
        if loop.done():
            return math.inf
        gap = max(gap, abs(th[i] - loop.th))
        loop.th = th[i]
        nxt = loop.step(out["g_dat"][i], out["g_sims"][i])
    if nxt is None or not loop.done():
        return math.inf
    return max(gap, abs(out["theta_hat"] - f32(nxt)))


def fd_step(g_sims_last) -> float:
    """``get_H``'s default step: 0.1 over the sd of the scores it is left."""
    return float(0.1 / np.std(np.asarray(g_sims_last, np.float64), ddof=1))


def stencil(theta_hat: float, step: float) -> tuple:
    """θ̂ ± ε as the program forms them: float32 θ̂ plus float32 ±ε, the
    sum rounded to float32."""
    t, e = np.float32(theta_hat), np.float32(step)
    return float(np.float32(t + e)), float(np.float32(t - e))


# ---------------------------------------------------------------------- #
# the reference at a program's output


def reference(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
              out: dict, lanes, block: int = 16) -> dict:
    """The float64 reference at the θs of a program's output ``out``: the
    score of every lane at every θ of its history, J at the last one, each
    H sim's finite-difference H at the program's θ̂ and step and its
    analytic H, σ, and the kept MAPs of ``out["bulk"]`` against their own
    Wiener filter (``lanes`` is the lanes the program kept)."""
    dev = x_obs.device
    n = cfg["n"]
    m = Field(cfg, dev)
    thetas = [f32(t) for t in out["thetas"]]
    # the score weights and the sims' |x̂|² weights at every θ, stacked
    q = torch.stack([m.score_weight(t) for t in thetas])         # (T, n, r)
    pw = [torch.stack(v) for v in zip(*(m.power_weights(t)
                                        for t in thetas))]
    xo = x_obs.to(torch.float64)
    Xo = m.rfft2(xo)
    g_dat = torch.einsum("tkl,kl->t", q, Xo.real ** 2 + Xo.imag ** 2) \
        - 0.5 * m.wsum
    seeds = keys.sim_seeds(seed, nsims)
    g_sims = []
    for b in _blocks(seeds, block):
        P = m.planes(*lane_draws(b, n, dev))
        g_sims.append(sum(torch.einsum("tkl,bkl->bt", q * a, p)
                          for a, p in zip(pw, P)) - 0.5 * m.wsum)
        del P
    g_sims = torch.cat(g_sims)                                   # (S, T)
    ps2 = cfg["prior_std"] ** 2
    J = float(torch.var(g_sims[:, -1], correction=1))
    # finite-difference H at the program's θ̂ and step, analytic beside it
    nh = cfg["h"]["nsims"]
    th_hat = f32(out["theta_hat"])
    step = fd_step(out["g_sims"][-1]) if out["g_sims"] else math.nan
    Hs, Hs_an = [], []
    if math.isfinite(step):
        qh = m.score_weight(th_hat)
        ups, dns = stencil(th_hat, step)
        wp, wm = m.power_weights(ups), m.power_weights(dns)
        Ch = m.C(th_hat)
        wa = (Ch, m.sigma * torch.sqrt(Ch))          # dg/dθ_sim at θ̂
        for b in _blocks(keys.sim_seeds(seed, nh, salt=1), block):
            P = m.planes(*lane_draws(b, n, dev))

            def g_at(wts):
                return sum(torch.einsum("kl,bkl->b", qh * a, p)
                           for a, p in zip(wts, P)) - 0.5 * m.wsum
            Hs.append((0.5 * g_at(wp) - 0.5 * g_at(wm)) / step)
            Hs_an.append(sum(torch.einsum("kl,bkl->b", qh * a, p)
                             for a, p in zip(wa, P[:2])))
            del P
    Hs = torch.cat(Hs) if Hs else torch.zeros(0, dtype=torch.float64)
    Hs_an = torch.cat(Hs_an) if Hs_an else Hs
    H = float(Hs.mean()) if len(Hs) else math.nan
    sigma = 1.0 / math.sqrt(H * H / J + 1.0 / ps2) if len(Hs) else math.nan
    gap, grad = _judge_maps(cfg, m, xo, seed, thetas, lanes,
                            out.get("bulk", {}).get("maps", []))
    return {"g_dat": g_dat.cpu().numpy(), "g_sims": g_sims.cpu().numpy(),
            "J": J, "Hs": Hs.cpu().numpy(), "Hs_analytic": Hs_an.cpu().numpy(),
            "H": H, "sigma": sigma, "step": step, "map_gap": gap,
            "map_grad": grad}


def _judge_maps(cfg, m, xo, seed, thetas, lanes, maps) -> tuple:
    """(the widest relative L2 gap of a kept MAP from the float64 Wiener
    filter of the same lane at the same θ, the widest float64
    ‖∇z log P‖₂ at a kept MAP in units of grad_z_atol·n); both infinite
    unless every lane of ``lanes`` has one MAP at each θ of ``thetas``,
    in order."""
    L = len(lanes)
    if len(maps) != L * len(thetas) or any(
            [j for j, _, _ in maps[i * L:(i + 1) * L]] != list(lanes)
            or any(f32(t) != th for _, t, _ in maps[i * L:(i + 1) * L])
            for i, th in enumerate(thetas)):
        return math.inf, math.inf
    dev, n = xo.device, m.n
    draws = {}
    for j in lanes:
        if j:
            u, e = lane_draws([keys.lane_seed(seed, j)], n, dev)
            draws[j] = (u[0].double(), e[0].double())
    tol = cfg["fit"]["grad_z_atol"] * n
    gap = grad = 0.0
    for lane, th, Z in maps:
        x = xo if lane == 0 else m.x_of(*draws[lane], th)
        z = Z.to(dev, torch.float64).reshape(n, n)
        zr = m.wiener(x, th)
        gap = max(gap, float(torch.linalg.vector_norm(z - zr)
                             / torch.linalg.vector_norm(zr)))
        grad = max(grad, float(torch.linalg.vector_norm(
            m.grad_z(x, z, th))) / tol)
    return ((gap if math.isfinite(gap) else math.inf),
            (grad if math.isfinite(grad) else math.inf))


def judge(cfg: dict, out: dict, ref: dict) -> dict:
    """The numbers compared, each a gap of the program from the reference:

    * ``score_gap``: the widest gap of a lane's θ-score (the data lane's and
      every sim's) at any iteration, in units of that iteration's sd of the
      reference's sims' scores;
    * ``theta_gap``: the θ loop followed step by step in float64 from the
      program's own state and scores (:func:`theta_gap`): each θ it runs at
      and θ̂, in units of the reference's σ; infinite where the replay stops
      at another step;
    * ``J_gap``, ``sigma_gap``: relative gaps; ``H_gap``: the widest
      relative gap of an H sim's finite-difference H;
    * ``map_gap``: the widest relative L2 gap of a kept MAP from the float64
      Wiener filter of its lane; ``map_grad``: the widest float64 latent
      gradient at a kept MAP, in units of grad_z_atol·n. Both infinite
      where a kept MAP is missing."""
    inf = math.inf
    nums = dict.fromkeys(("score_gap", "theta_gap", "J_gap", "H_gap",
                          "sigma_gap"), inf)
    nums["map_gap"], nums["map_grad"] = ref["map_gap"], ref["map_grad"]
    g_sims = np.asarray(out["g_sims"], np.float64)           # (T, S)
    g_dat = np.asarray(out["g_dat"], np.float64)
    rs, rd = ref["g_sims"].T, ref["g_dat"]
    with np.errstate(all="ignore"):
        if g_sims.shape == rs.shape and g_dat.shape == rd.shape and \
                len(g_dat):
            sd = rs.std(axis=1, ddof=1)
            gaps = np.concatenate([np.abs(g_sims - rs),
                                   np.abs(g_dat - rd)[:, None]], 1)
            nums["score_gap"] = np.max(gaps / sd[:, None])
            nums["J_gap"] = abs(np.float64(out["J"]) / ref["J"] - 1.0)
        Hs = np.asarray(out["Hs"], np.float64)
        if Hs.shape == ref["Hs"].shape and len(Hs):
            nums["H_gap"] = np.max(np.abs(Hs / ref["Hs"] - 1.0))
            nums["sigma_gap"] = abs(np.float64(out["sigma"]) / ref["sigma"]
                                    - 1.0)
            nums["theta_gap"] = theta_gap(cfg, out) / ref["sigma"]
    return {k: (float(v) if np.isfinite(v) else inf)
            for k, v in nums.items()}


# ---------------------------------------------------------------------- #
# the control


def control_pipeline(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
                     lanes, dtype=torch.bfloat16, block: int = 16) -> dict:
    """The reference put in the program's place with every stored array in
    ``dtype``: the draws, x, the MAPs, the spectral products and the scores
    (transforms in float32 between roundings: torch has no bfloat16 FFT;
    sums accumulated as torch does and returned in ``dtype``); the θ loop,
    J, the finite-difference step and σ on the host in float64 as the
    program runs them. Returns output in the program's form."""
    dev = x_obs.device
    n = cfg["n"]
    m = Field(cfg, dev, torch.float32)
    w = m.w.to(dtype)
    half_w = torch.tensor(0.5 * m.wsum, device=dev).to(dtype)
    sigma = torch.tensor(m.sigma, device=dev).to(dtype)

    def r(t):
        return t.to(dtype)

    def maps_scores(u, e, th_sim, th, data=None):
        """The MAPs at θ of a block of lanes drawn at θ_sim, and their
        scores at θ."""
        x = r(m.irfft2(r(torch.sqrt(m.C(th_sim))) * m.rfft2(u.float()))) \
            + sigma * e
        if data is not None:
            x = torch.cat([data[None], x[1:]])
        C = m.C(th)
        Z = r(m.irfft2(r(C / (C + m.s2)) * m.rfft2(x.float())))
        zf = m.rfft2(Z.float())
        q = r(w * r(zf.real ** 2 + zf.imag ** 2) * r(1.0 / C / n ** 2))
        return Z, r(0.5 * q.sum((-2, -1))) - half_w

    seeds = [keys.lane_seed(seed, j) for j in range(nsims + 1)]
    U, E = (r(v) for v in lane_draws(seeds, n, dev))
    xo = r(x_obs)
    loop = ThetaLoop(cfg)
    hist, kept = [], []
    nxt = loop.th
    while not loop.done() and math.isfinite(loop.th):
        th = loop.th
        gs, Zk = [], {}
        for b in _blocks(list(range(nsims + 1)), block):
            Z, g = maps_scores(U[b], E[b], th, th, xo if b[0] == 0 else None)
            gs.append(g.double().cpu())
            Zk.update({j: Z[j - b[0]] for j in lanes if j in b})
        g = torch.cat(gs).numpy()
        kept += [(j, f32(th), Zk[j].float().cpu()) for j in lanes]
        hist.append({"theta_t": th, "g_dat": float(g[0]), "g_sims": g[1:]})
        nxt = loop.step(float(g[0]), g[1:])
    del U, E
    J = float(np.var(hist[-1]["g_sims"], ddof=1))
    th_hat = f32(nxt)
    step = fd_step(hist[-1]["g_sims"])
    Uh, Eh = (r(v) for v in lane_draws(
        keys.sim_seeds(seed, cfg["h"]["nsims"], salt=1), n, dev))
    g_pm = [maps_scores(Uh, Eh, t, th_hat)[1].double().cpu().numpy()
            for t in stencil(th_hat, step)]
    Hs = (0.5 * g_pm[0] - 0.5 * g_pm[1]) / step
    H = float(np.mean(Hs))
    ps2 = cfg["prior_std"] ** 2
    return {"thetas": [f32(h["theta_t"]) for h in hist],
            "theta_ts": [h["theta_t"] for h in hist],
            "g_dat": [h["g_dat"] for h in hist],
            "g_sims": [h["g_sims"] for h in hist],
            "theta_hat": th_hat,
            "sigma": 1.0 / math.sqrt(H * H / J + 1.0 / ps2),
            "J": J, "H": H, "Hs": list(Hs), "iterations": len(hist),
            "bulk": {"maps": kept}}
