"""Plain reference of the lensing pipeline, and its control.

It imports nothing of the port and keeps TF32 off. Frozen copies, from
``muse_tpu_torch`` at commit 388f963:

* ``models/grf.py``: ``GrfConfig``'s rfft grid |k| (integer wave numbers),
  the spectrum C(θ = 0) = (|k| + 1)^(−γ) and the hermitian weights of the
  rfft2 half-grid;
* ``models/lensing.py``: the whitened model. A lane draws three pixel
  whites (u_z, u_φ, e) with three ``randn`` of (n, n) from its generator;
  z = S_z u_z, the potential's spectrum normalised so that rms|∇φ| is
  ``defl_scale`` pixels at θ = 0, the deflection d = ∇φ·e^{θ/2}, the six
  Fourier-derivative planes (1, ∂x, ∂y, ∂xx, ∂yy, ∂xy) of z with the
  hermitian projection of their diagonals, the 2nd-order Taylor lens
  F = z + d·∇z + ½ dᵀ(∇∇z)d and x = F + σe; log P(x, u | θ) =
  −½(‖x − F‖²/σ² + ‖u_z‖² + ‖u_φ‖²), its analytic θ-score
  Σ (x − F)·(d·∇z + dᵀ∇∇z d)/(2σ²), the flat latent [u_φ; u_z] a lane
  (sorted keys), the Wiener warm start of u_z, the Fourier-diagonal
  preconditioner of implicit H;
* ``solver/compiled.py``'s implicit-differentiation H = H₁ + H₂ at given
  MAPs, with its own float64 CG on exact HVPs;
* ``solver/muse.py``'s θ loop: Broyden replay of H⁻¹ from the first
  step's sims variance, the damped Newton step, the caller's ±0.3 clamp
  of the example (``examples/lensing_demo.py``) and the doubly guarded
  θ_rtol stop.

Departures from the port's equations: everything is float64 (the port
float32), θ enters as the float32 value the program used; the
spectra are computed in float64 from float64 |k| (the port rounds |k|
and C to float32 first); the latent gradient, the HVPs and H's Jacobians
are autograd (``torch.func``) of the float64 log-density, where the port
uses VarPro's explicit operator pair and its own autograd in float32;
the CG of H and the control's MAP solve (Newton-CG on exact HVPs, fixed
step) are the reference's own.

``judge`` compares a program's output with the reference recomputed at
the MAPs the program kept; ``control_pipeline`` is this model put in the
program's place with every stored array rounded to bfloat16, which
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


def _herm_sym(zf: np.ndarray) -> np.ndarray:
    """The hermitian projection of the rfft2 half-grid's self-conjugate
    columns (0 and, for even n, the last), as ``models/lensing.py``'s
    ``_herm_sym``."""
    n, nr = zf.shape[-2:]
    out = zf.copy()
    cols = [0] + ([nr - 1] if n % 2 == 0 else [])
    for c in cols:
        col = zf[..., c]
        mirror = np.conj(np.roll(col[..., ::-1], 1, -1))
        out[..., c] = 0.5 * (col + mirror)
    return out


class Lensing:
    """The whitened lensing model at one precision: float64, or every
    stored array rounded to ``dtype`` (bfloat16 for the control; the
    transforms and the arithmetic run in float32 between roundings, since
    torch has no bfloat16 FFT and no complex bfloat16)."""

    def __init__(self, cfg: dict, device, dtype=torch.float64):
        n = cfg["n"]
        self.n, self.cfg = n, cfg
        self.device = torch.device(device)
        self.low = None if dtype == torch.float64 else dtype
        self.real = torch.float64 if self.low is None else torch.float32
        self.cplx = (torch.complex128 if self.low is None
                     else torch.complex64)
        self.s2 = cfg["sigma_noise"] ** 2
        nr = n // 2 + 1
        ky = np.fft.fftfreq(n) * n
        kx = np.fft.rfftfreq(n) * n
        k = np.hypot(ky[:, None], kx[None, :])
        Cz0 = (k + 1.0) ** (-cfg["gamma_z"])
        Cp0 = (k + 1.0) ** (-cfg["gamma_phi"])
        w = np.full((n, nr), 2.0)
        w[:, 0] = 1.0
        if n % 2 == 0:
            w[:, -1] = 1.0
        kyr = np.fft.fftfreq(n)[:, None] * 2 * np.pi
        kxr = np.fft.rfftfreq(n)[None, :] * 2 * np.pi
        k2 = kyr ** 2 + kxr ** 2
        rms0 = math.sqrt(float(np.sum(w * k2 * Cp0)) / n ** 2)
        self.phi_norm = cfg["defl_scale"] / max(rms0, 1e-12)
        one = np.ones((n, nr))
        K6 = _herm_sym(np.stack([one + 0j, 1j * kxr * one, 1j * kyr * one,
                                 -(kxr ** 2) * one + 0j,
                                 -(kyr ** 2) * one + 0j,
                                 -(kxr * kyr) * one + 0j]))
        self.Cz0 = Cz0
        self.K6 = self.c(torch.tensor(K6, dtype=torch.complex128,
                                      device=self.device).to(self.cplx))
        self.sqCz = self._t(np.sqrt(Cz0))
        self.sqCp = self._t(np.sqrt(Cp0))
        # implicit H's Fourier-diagonal preconditioner (u_φ block, u_z block)
        gz2 = float(np.sum(w * k2 * Cz0)) / n ** 2
        self._Mz = 1.0 + Cz0 / self.s2
        self._Mp0 = self.phi_norm ** 2 * k2 * Cp0 * gz2 / self.s2

    def _t(self, a):
        return self.r(torch.tensor(a, dtype=torch.float64,
                                   device=self.device).to(self.real))

    # -- rounding: identity in float64 ---------------------------------- #

    def r(self, t):
        return t if self.low is None else t.to(self.low).to(self.real)

    def c(self, t):
        if self.low is None:
            return t
        return torch.complex(self.r(t.real), self.r(t.imag))

    def rfft2(self, v):
        return self.c(torch.fft.rfft2(v))

    def irfft2(self, v):
        return self.r(torch.fft.irfft2(v, s=(self.n, self.n)))

    def theta(self, th):
        """θ as a 0-d tensor of the working dtype (the float32 value the
        program ran at)."""
        if isinstance(th, torch.Tensor):
            return th
        return torch.tensor(f32(th), dtype=self.real, device=self.device)

    # -- the model ----------------------------------------------------- #

    def parts(self, uz, uphi, th):
        """(F, lin, quad) of (…, n, n) latents at θ: the lens F and its
        first- and second-order parts d·∇z and dᵀ∇∇z d."""
        r = self.r
        a = r(torch.exp(0.5 * self.theta(th)))
        zf = self.c(self.rfft2(uz) * self.sqCz)
        z, zx, zy, zxx, zyy, zxy = self.irfft2(
            self.c(zf[..., None, :, :] * self.K6)).unbind(-3)
        pf = self.c(self.rfft2(uphi) * r(self.phi_norm * a * self.sqCp))
        dx, dy = self.irfft2(self.c(pf[..., None, :, :]
                                    * self.K6[1:3])).unbind(-3)
        lin = r(r(dx * zx) + r(dy * zy))
        quad = r(r(r(r(dx * dx) * zxx) + r(r(2 * r(dx * dy)) * zxy))
                 + r(r(dy * dy) * zyy))
        return r(r(z + lin) + r(0.5 * quad)), lin, quad

    def x_of_white(self, uz, uphi, e, th):
        return self.r(self.parts(uz, uphi, th)[0]
                      + self.r(self.cfg["sigma_noise"] * e))

    def split(self, U):
        """Flat (…, 2n²) latents [u_φ; u_z] → (u_z, u_φ) fields."""
        u = U.reshape(U.shape[:-1] + (2, self.n, self.n))
        return u[..., 1, :, :], u[..., 0, :, :]

    def log_p(self, x, U, th):
        """log P(x, u | θ) of every lane: (…,)."""
        uz, uphi = self.split(U)
        res = self.r(x - self.parts(uz, uphi, th)[0])
        return self.r(-0.5 * (self.r(torch.sum(res * res, (-2, -1))
                                     / self.s2)
                              + self.r(torch.sum(U * U, -1))))

    def score(self, x, U, th):
        """The analytic θ-score Σ (x − F)·(lin + quad)/(2σ²) a lane."""
        uz, uphi = self.split(U)
        F, lin, quad = self.parts(uz, uphi, th)
        res = self.r(x - F)
        return self.r(torch.sum(res * self.r(lin + quad), (-2, -1))
                      / (2 * self.s2))

    def grad_u(self, x, U, th):
        """∇_u log P(x, u | θ) of every lane, (…, 2n²)."""
        return self.r(torch.func.grad(
            lambda V: self.log_p(x, V, th).sum())(U))

    def hvp(self, x, U, th, V):
        """(−∇²_u log P)·V, lane by lane."""
        return self.r(-torch.func.jvp(lambda W: self.grad_u(x, W, th),
                                      (U,), (V,))[1])

    def precond(self, th):
        """The Fourier-diagonal approximation of (−∇²_u log P)⁻¹ on flat
        lanes (``h_precond``/``_precond2`` of the port)."""
        a2 = math.exp(self.theta(th).item())
        M = torch.tensor(np.stack([1.0 + a2 * self._Mp0, self._Mz]),
                         dtype=self.real, device=self.device)
        n = self.n

        def apply(R):
            Rf = R.reshape(R.shape[:-1] + (2, n, n))
            return self.irfft2(self.c(self.rfft2(Rf) / M)).reshape(R.shape)
        return apply

    def wiener_uz(self, x):
        """The port's warm start of u_z: the data treated as unlensed."""
        Cz = self.Cz0
        xf = np.fft.rfft2(x.detach().double().cpu().numpy())
        uz0 = np.fft.irfft2(np.sqrt(Cz) * xf / (Cz + self.s2),
                            s=(self.n, self.n))
        return self.r(torch.tensor(uz0, dtype=self.real,
                                   device=self.device))

    # -- solves --------------------------------------------------------- #

    def cg(self, A, b, M, tol: float, maxiter: int):
        """PCG on every lane of A y = b, a lane stopped at ‖r‖ ≤ tol·‖b‖
        or where A shows a direction of no positive curvature (Steihaug's
        rule: the iterate so far is then the step)."""
        r = self.r
        y = torch.zeros_like(b)
        res = b.clone()
        z = M(res)
        p = z
        rz = r((res * z).sum(-1))
        bn = torch.linalg.vector_norm(b, dim=-1)
        done = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
        for _ in range(maxiter):
            done = done | (torch.linalg.vector_norm(res, dim=-1) <= tol * bn)
            if bool(done.all()):
                break
            Ap = A(p)
            pAp = r((p * Ap).sum(-1))
            done = done | ~(pAp > 0)
            alpha = torch.where(done, 0.0, r(rz / torch.where(
                pAp > 0, pAp, 1.0)))[:, None]
            y = r(y + r(alpha * p))
            res = r(res - r(alpha * Ap))
            z = M(res)
            rz1 = r((res * z).sum(-1))
            beta = r(rz1 / torch.where(rz != 0, rz, 1.0))[:, None]
            p = torch.where(done[:, None], p, r(z + r(beta * p)))
            rz = torch.where(done, rz, rz1)
        return y

    def _solve_uz(self, x, uphi, uz0, th, iters: int):
        """The MAP of u_z at a fixed u_φ: the lens is linear in u_z, so
        PCG on (I + GᵀG/σ²) u_z = Gᵀx/σ², preconditioned by the exact
        diagonal of the unlensed part, warm-started at ``uz0``."""
        n, B = self.n, x.shape[0]

        def G(v):
            return self.parts(v.reshape(B, n, n), uphi, th)[0]
        Gt = torch.func.vjp(G, uz0.reshape(B, -1))[1]

        def A(v):
            return self.r(v + self.r(Gt(G(v))[0] / self.s2))
        Mz = torch.tensor(self._Mz, dtype=self.real, device=self.device)

        def M(v):
            return self.irfft2(self.c(self.rfft2(v.reshape(B, n, n)) / Mz)
                               ).reshape(B, -1)
        v0 = uz0.reshape(B, -1)
        b = self.r(self.r(Gt(x)[0] / self.s2) - A(v0))
        return self.r(v0 + self.cg(A, b, M, 1e-12, iters)).reshape(B, n, n)

    def map_solve(self, x, U0, th, outer: int, inner: int, m: int = 5):
        """The joint MAP by variable projection, the reference's own: u_z
        eliminated at each u_φ (:meth:`_solve_uz`, ``inner`` PCG
        iterations), L-BFGS on u_φ over the reduced objective with the
        Fourier-diagonal preconditioner as its initial inverse Hessian and
        a backtracking search; ``outer`` iterations."""
        n, B = self.n, x.shape[0]
        r = self.r
        a2 = math.exp(self.theta(th).item())
        Mp = torch.tensor(1.0 + a2 * self._Mp0, dtype=self.real,
                          device=self.device)

        def Hp(v):
            return self.irfft2(self.c(self.rfft2(v.reshape(B, n, n)) / Mp)
                               ).reshape(B, -1)
        uz, uphi = self.split(U0)
        uphi = uphi.reshape(B, -1)

        def joint(up, uz_):
            return torch.cat([up, uz_.reshape(B, -1)], -1)

        def solved(up, uz_start):
            uz_ = self._solve_uz(x, up.reshape(B, n, n), uz_start, th, inner)
            U = joint(up, uz_)
            return uz_, U, self.log_p(x, U, th), self.grad_u(x, U, th)

        uz, U, f, g = solved(uphi, uz)
        S, Y = [], []
        for _ in range(outer):
            gp = g[:, :n * n]                 # ascent direction of log P
            q = gp.clone()
            alphas = []
            for s_, y_ in reversed(list(zip(S, Y))):
                rho = 1.0 / torch.where((y_ * s_).sum(-1) != 0,
                                        (y_ * s_).sum(-1), 1.0)
                a_ = rho * (s_ * q).sum(-1)
                q = r(q - a_[:, None] * y_)
                alphas.append((rho, a_))
            d = Hp(q)
            for (s_, y_), (rho, a_) in zip(zip(S, Y), reversed(alphas)):
                b_ = rho * (y_ * d).sum(-1)
                d = r(d + (a_ - b_)[:, None] * s_)
            d = torch.where((d * gp).sum(-1, keepdim=True) > 0, d, Hp(gp))
            step = torch.ones_like(f)
            for _ in range(12):
                uz1, U1, f1, g1 = solved(r(uphi + r(step[:, None] * d)), uz)
                bad = ~(f1 >= f)
                if not bool(bad.any()):
                    break
                step = torch.where(bad, 0.5 * step, step)
            take = (f1 >= f)[:, None]
            up1 = torch.where(take, r(uphi + r(step[:, None] * d)), uphi)
            uz1 = torch.where(take[..., None], uz1, uz)
            g1p = torch.where(take, g1[:, :n * n], gp)
            S.append(up1 - uphi)
            Y.append(gp - g1p)                # curvature of −log P
            S, Y = S[-m:], Y[-m:]
            uphi = up1
            uz, U, f, g = solved(uphi, uz1)
        return U

    def h_sims(self, W, Z, th, tol: float = 1e-12, maxiter: int = 400):
        """Implicit H₁ + H₂ of each sim with whites W = (u_z, u_φ, e), each
        (S, n, n), at its MAP Z (S, 2n²) and θ."""
        uz, uphi, e = W
        t0 = self.theta(th)
        one = torch.ones_like(t0)

        def x_at(t):
            return self.x_of_white(uz, uphi, e, t)

        x = x_at(t0)
        # H₁ = ∂θsim of the θ-score at ẑ, through x(θsim)
        H1 = torch.func.jvp(lambda ts: self.score(x_at(ts), Z, t0), (t0,),
                            (one,))[1]

        def grad_z(xx, U, t):
            return self.grad_u(xx, U, t)

        dF = torch.func.jvp(lambda t: grad_z(x, Z, t), (t0,), (one,))[1]
        dF1 = torch.func.jvp(lambda ts: grad_z(x_at(ts), Z, t0), (t0,),
                             (one,))[1]
        # solve the exact HVP system to a tolerance far below float32's
        Y = self.cg(lambda V: self.hvp(x, Z, t0, V), -dF1,
                    self.precond(t0), tol, maxiter)
        H2 = -(dF * Y).sum(-1)
        return self.r(H1 + H2)


# ---------------------------------------------------------------------- #
# lanes and whites


def lane_whites(seed: int, n: int, device) -> tuple:
    """A lane's (u_z, u_φ, e) from its generator, float32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return tuple(torch.randn((n, n), generator=gen, device=device)
                 for _ in range(3))


def whites(seeds, n: int, device) -> tuple:
    """The lanes' whites stacked: three (S, n, n) tensors."""
    ws = [lane_whites(s, n, device) for s in seeds]
    return tuple(torch.stack(p) for p in zip(*ws))


def make_data(cfg: dict, gen_seed: int, count: int, device) -> torch.Tensor:
    """``count`` observed maps (count, n, n), float32, drawn at
    ``theta_true`` from one generator on ``device``."""
    n = cfg["n"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(gen_seed))
    W = torch.randn((3, count, n, n), generator=gen, device=device,
                    dtype=torch.float64)
    m = Lensing(cfg, device)
    return m.x_of_white(W[0], W[1], W[2], cfg["theta_true"]).float()


# ---------------------------------------------------------------------- #
# the θ loop


class ThetaLoop:
    """``muse_fit``'s host loop for a scalar θ without a bijector, with
    ``Hinv_update="broyden"``, a constant α and the example's clamp of each
    step to ±``clamp`` about the θ it came from, in float64."""

    def __init__(self, cfg: dict):
        fit = cfg["fit"]
        self.alpha, self.clamp = fit["alpha"], fit["clamp"]
        self.rtol, self.maxsteps = fit["theta_rtol"], fit["maxsteps"]
        self.ps2 = cfg["prior_std"] ** 2
        self.th = float(cfg["theta0"])          # θ_t the next step runs at
        self.hist = []

    def done(self) -> bool:
        """Whether the loop stops before its next step."""
        i = len(self.hist) + 1
        return i > self.maxsteps or (i > 2 and self._converged())

    def _metric(self, h0, h1) -> float:
        d = h1["theta"] - h0["theta"]
        m = -d * h1["Hinv_post"] * d
        return math.sqrt(abs(m))

    def _converged(self) -> bool:
        h = self.hist
        if self._metric(h[-2], h[-1]) >= self.rtol or len(h) < 3:
            return False
        return self._metric(h[-3], h[-2]) < self.rtol

    def step(self, g_dat: float, g_sims) -> float:
        """Take the step from the scores at ``self.th`` (the loop goes on
        from the clamped θ); returns the unclamped step."""
        g_sims = np.asarray(g_sims, np.float64)
        i = len(self.hist) + 1
        th = self.th
        g_like = g_dat - g_sims.mean()
        g_post = g_like - f32(th) / self.ps2
        H_sims = -1.0 / g_sims.var(ddof=1)
        if i == 1:
            H_like = H_sims
        elif i == 2:
            H_like = self.hist[0]["Hinv_sims"]
        else:
            H_like = self.hist[0]["Hinv_sims"]
            for j in range(2, i):
                hj, hjm1 = self.hist[j - 1], self.hist[j - 2]
                dth = hj["theta"] - hjm1["theta"]
                dg = hj["g_like"] - hjm1["g_like"]
                Hdg = H_like * dg
                H_like = H_like + (dth - Hdg) / (dth * Hdg) * dth * H_like
        Hinv_post = 1.0 / (1.0 / H_like - 1.0 / self.ps2)
        self.hist.append({"theta": th, "g_like": g_like,
                          "Hinv_sims": H_sims, "Hinv_post": Hinv_post})
        unreg = th - self.alpha * Hinv_post * g_post
        self.th = float(np.clip(unreg, th - self.clamp, th + self.clamp))
        return unreg


# ---------------------------------------------------------------------- #
# the reference at a program's output


def _blocks(idx, size: int):
    for i in range(0, len(idx), size):
        yield idx[i:i + size]


def reference(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
              out: dict, lanes, block: int = 8) -> dict:
    """The float64 reference at the MAPs a program's output ``out`` kept
    (its ``bulk``): the scores and latent gradients of the kept lanes at
    every step, of every lane at the last step and of the H sims; J; H at
    the kept fiducial MAPs of the sampled H sims; σ."""
    dev = x_obs.device
    n = cfg["n"]
    m = Lensing(cfg, dev)
    bulk = out.get("bulk", {})
    atol, h_atol = cfg["fit"]["grad_z_atol"], cfg["h"]["fit_atol"]
    xo = x_obs.to(torch.float64)

    def xs_of(lane_list, th):
        """x of the given global lanes at θ, stacked."""
        sims = [j for j in lane_list if j]
        xs = {}
        if sims:
            uz, uphi, e = (w.double() for w in whites(
                [keys.lane_seed(seed, j) for j in sims], n, dev))
            xsim = m.x_of_white(uz, uphi, e, th)
            xs = {j: xsim[k] for k, j in enumerate(sims)}
        return torch.stack([xo if j == 0 else xs[j] for j in lane_list])

    def judge_maps(lane_list, th, Z):
        """Scores and the sup-norm of the latent gradient, lane by lane."""
        g, sup = [], []
        for b in _blocks(list(range(len(lane_list))), block):
            x = xs_of([lane_list[k] for k in b], th)
            U = Z[b].to(dev, torch.float64)
            g.append(m.score(x, U, th))
            sup.append(m.grad_u(x, U, th).abs().amax(-1))
        return (torch.cat(g).cpu().numpy(), torch.cat(sup).cpu().numpy())

    worst = 0.0
    thetas = [f32(t) for t in out["thetas"]]
    conv = [np.asarray(c, bool) for c in out["converged"]]

    def widest(sup, flags):
        """The widest of the lanes the program flagged converged (a frozen
        lane is counted in ``frozen_lanes`` instead)."""
        sup = np.where(np.asarray(flags, bool), sup, 0.0)
        return float(sup.max()) if sup.size else 0.0
    # the kept lanes at every step, in the order of the steps
    maps = bulk.get("maps", [])
    L = len(lanes)
    kept = []
    if len(maps) != L * len(thetas) or any(
            [j for j, _, _ in maps[i * L:(i + 1) * L]] != list(lanes)
            or any(f32(t) != th for _, t, _ in maps[i * L:(i + 1) * L])
            for i, th in enumerate(thetas)):
        worst = math.inf
    else:
        for i, th in enumerate(thetas):
            rows = maps[i * L:(i + 1) * L]
            g, sup = judge_maps(list(lanes), th,
                                torch.stack([Z for _, _, Z in rows]))
            kept.append(dict(zip(lanes, g)))
            worst = max(worst, widest(sup, conv[i][list(lanes)]) / atol)
    # every lane at the last step
    last = bulk.get("last")
    g_last = None
    if last is None or not thetas or f32(last[0]) != thetas[-1] or \
            last[1].shape[0] != nsims + 1:
        worst = math.inf
    else:
        g_last, sup = judge_maps(list(range(nsims + 1)), last[0], last[1])
        worst = max(worst, widest(sup, conv[-1]) / atol)
    # J from the sims' scores at the last step, dropping what get_J dropped
    J = math.nan
    if g_last is not None:
        keep = np.asarray(out["gs_kept"], bool)
        J = float(np.var(g_last[1:][keep], ddof=1))
    # the fiducial MAPs of every H sim, and H at a sample of them
    h = bulk.get("h")
    nh = cfg["h"]["nsims"]
    Hs = {}
    if h is None or h[1].shape[0] != nh:
        worst = math.inf
    else:
        th_h, Zh = f32(h[0]), h[1]
        hseeds = keys.sim_seeds(seed, nh, salt=1)
        checked = h_lanes(seed, cfg)
        for b in _blocks(list(range(nh)), block):
            W = tuple(w.double() for w in whites([hseeds[k] for k in b], n,
                                                  dev))
            Z = Zh[b].to(dev, torch.float64)
            x = m.x_of_white(*W, th_h)
            sup = m.grad_u(x, Z, th_h).abs().amax(-1).cpu().numpy()
            flags = np.asarray(out["h_converged"], bool)[b]
            worst = max(worst, widest(sup, flags) / h_atol)
            sel = [i for i, k in enumerate(b) if k in checked]
            if sel:
                H = m.h_sims(tuple(w[sel] for w in W), Z[sel], th_h)
                for i, v in zip(sel, H.cpu().numpy()):
                    Hs[b[i]] = float(v)
    return {"kept": kept, "g_last": g_last, "J": J, "Hs": Hs,
            "map_grad": worst}


def h_lanes(seed: int, cfg: dict) -> list:
    """The H sims whose H the reference recomputes, drawn from the
    pipeline's seed."""
    nh, k = cfg["h"]["nsims"], cfg["h"]["checked"]
    rng = np.random.default_rng(keys.derive(seed, (7,)))
    return sorted(int(j) for j in rng.choice(nh, size=min(k, nh),
                                             replace=False))


def judge(cfg: dict, out: dict, ref: dict) -> dict:
    """The numbers compared, each a gap of the program from the reference:

    * ``score_gap``: the widest gap of a θ-score at a kept MAP (the kept
      lanes at every step, every lane at the last step), in units of the
      spread of the reference's sims' scores at the last step;
    * ``theta_gap``: the θ loop followed step by step in float64 from the
      program's own state and scores (:class:`ThetaLoop`): θ₀, each θ it
      runs at, θ̂ and where it stops, in units of the reference's σ
      (infinite where the replay stops elsewhere);
    * ``J_gap``, ``sigma_gap``: relative gaps; ``H_gap``: the widest
      relative gap of a checked H sim's H;
    * ``map_grad``: the widest float64 sup|∇_u log P| at a kept MAP that
      the program flagged converged, in units of the tolerance it was
      solved to (grad_z_atol for the fit's, the H fit's tolerance for the
      fiducial MAPs); infinite where a kept MAP is missing;
    * ``frozen_lanes``: the MAPs the program returned unconverged, by its
      own flags, over the fit's steps and H's fiducial solve: the lanes
      ``map_grad`` leaves out, bounded so that a fault cannot hide lanes
      by flagging them."""
    inf = math.inf
    nums = dict.fromkeys(("score_gap", "theta_gap", "J_gap", "H_gap",
                          "sigma_gap"), inf)
    nums["map_grad"] = ref["map_grad"]
    nums["frozen_lanes"] = float(out["frozen"])
    g_last = ref["g_last"]
    nsims = len(out["g_sims"][-1]) if out["g_sims"] else 0
    if g_last is None or len(g_last) != nsims + 1:
        return nums
    sd = np.float64(np.std(g_last[1:], ddof=1))
    gaps = [abs(out["g_dat"][-1] - g_last[0])] + list(
        np.abs(np.asarray(out["g_sims"][-1], np.float64) - g_last[1:]))
    if len(ref["kept"]) != len(out["thetas"]):
        return nums
    for i, row in enumerate(ref["kept"]):
        for j, g in row.items():
            got = out["g_dat"][i] if j == 0 else out["g_sims"][i][j - 1]
            gaps.append(abs(got - g))
    # numpy scalars: a zero or non-finite reading gives inf or nan, which
    # fails its limit, where Python's division would raise
    with np.errstate(all="ignore"):
        nums["score_gap"] = np.float64(max(gaps)) / sd
        J = np.float64(ref["J"])
        nums["J_gap"] = abs(out["J"] / J - 1.0)
        Hs = np.asarray(out["Hs"], np.float64)
        if len(Hs) == cfg["h"]["nsims"] and ref["Hs"]:
            nums["H_gap"] = max(abs(Hs[k] / v - 1.0)
                                for k, v in ref["Hs"].items())
            # σ from the reference's J and its H: the checked sims' own,
            # the others the program's (the reference recomputes a sample)
            H = np.mean([ref["Hs"].get(k, Hs[k]) for k in range(len(Hs))])
            sigma = 1.0 / np.sqrt(H * H / J + 1.0 / cfg["prior_std"] ** 2)
            nums["sigma_gap"] = abs(out["sigma"] / sigma - 1.0)
            nums["theta_gap"] = theta_gap(cfg, out) / sigma
    return {k: (float(v) if np.isfinite(v) else inf)
            for k, v in nums.items()}


def theta_gap(cfg: dict, out: dict) -> float:
    """The widest gap, in θ units, of the program's θ loop from its
    float64 replay on the program's own scores, step by step from the
    program's own state (each step taken from the θ the program ran it
    at, so that rounding does not compound through the Broyden history);
    infinite where the replay stops at another step."""
    loop = ThetaLoop(cfg)
    th_t = list(out["theta_ts"])
    gap, unreg = 0.0, None
    for i in range(len(th_t)):
        if loop.done():
            return math.inf
        gap = max(gap, abs(th_t[i] - loop.th))
        loop.th = th_t[i]
        unreg = loop.step(out["g_dat"][i], out["g_sims"][i])
    if not loop.done():
        return math.inf
    return max(gap, abs(out["theta_hat"] - f32(unreg)))


# ---------------------------------------------------------------------- #
# the control


def control_pipeline(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
                     lanes, dtype=torch.bfloat16, block: int = 16) -> dict:
    """The reference put in the program's place: x, the MAPs (its own
    :meth:`Lensing.map_solve`, warm-started as the program is, with the
    configuration's ``control`` budget of outer and inner iterations a θ
    step), the θ-scores and H in ``dtype``; the θ loop and σ on the host
    in float64. Returns output in the program's form."""
    dev = x_obs.device
    n = cfg["n"]
    m = Lensing(cfg, dev, dtype)
    outer, inner = cfg["control"]["varpro"]
    seeds = [keys.lane_seed(seed, j) for j in range(nsims + 1)]
    W = tuple(m.r(w.to(m.real)) for w in whites(seeds, n, dev))
    xo = m.r(x_obs.to(m.real))
    U = torch.cat([torch.zeros((n * n,), dtype=m.real, device=dev),
                   m.wiener_uz(x_obs).reshape(-1)]).expand(
        nsims + 1, 2 * n * n).clone()
    loop = ThetaLoop(cfg)
    hist, kept = [], []
    unreg = loop.th
    while not loop.done() and math.isfinite(loop.th):
        th = loop.th
        g = []
        for b in _blocks(list(range(nsims + 1)), block):
            x = m.x_of_white(*(w[b] for w in W), th)
            if b[0] == 0:
                x = torch.cat([xo[None], x[1:]])
            U[b] = m.map_solve(x, U[b], th, outer, inner)
            g.append(m.score(x, U[b], th))
        g = torch.cat(g).double().cpu().numpy()
        kept += [(j, f32(th), U[j].float().cpu()) for j in lanes]
        hist.append({"theta_t": th, "g_dat": float(g[0]), "g_sims": g[1:]})
        unreg = loop.step(float(g[0]), g[1:])
    last = (f32(hist[-1]["theta_t"]), U.float().cpu())
    del W, U
    J = float(np.var(hist[-1]["g_sims"], ddof=1))
    th_hat = f32(unreg)
    nh = cfg["h"]["nsims"]
    Wh = tuple(m.r(w.to(m.real)) for w in whites(
        keys.sim_seeds(seed, nh, salt=1), n, dev))
    xh = m.x_of_white(*Wh, th_hat)
    Zh = m.map_solve(xh, torch.zeros((nh, 2 * n * n), dtype=m.real,
                                     device=dev), th_hat, 2 * outer, inner)
    Hs = m.h_sims(Wh, Zh, th_hat, tol=1e-12, maxiter=10 * inner) \
        .double().cpu().numpy()
    H = float(Hs.mean())
    ps2 = cfg["prior_std"] ** 2
    sigma = 1.0 / math.sqrt(H * H / J + 1.0 / ps2)
    return {"thetas": [f32(h["theta_t"]) for h in hist],
            "theta_ts": [h["theta_t"] for h in hist],
            "g_dat": [h["g_dat"] for h in hist],
            "g_sims": [h["g_sims"] for h in hist],
            "theta_hat": th_hat, "sigma": sigma, "J": J, "H": H,
            "Hs": list(Hs), "gs_kept": [True] * nsims, "frozen": 0,
            "converged": [np.ones(nsims + 1, bool)] * len(hist),
            "h_converged": np.ones(nh, bool),
            "iterations": len(hist),
            "bulk": {"maps": kept, "last": last,
                     "h": (th_hat, Zh.float().cpu())}}
