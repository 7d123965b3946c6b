"""CMB-lensing-style model: the nonlinear large-field problem family.

Counterpart of ``muse_tpu/models/lensing.py``, the family the MUSE paper
was built for (arXiv:2112.09354 §5): infer the lensing-potential amplitude
A_φ from an observed lensed map, marginalizing over BOTH the unlensed field
and the potential, a 2n²-dimensional latent with a nonlinear observation
(coordinate remapping), so the latent MAP is real nonlinear work through
FFTs.

Model (whitened latents, periodic sky):
  u_z, u_φ ~ N(0, I_{n²})                      (white)
  z = S_z u_z,  φ = A_φ^{1/2}·S_φ u_φ          (GRF spectra via FFT)
  d = ∇φ                                        (Fourier ik)
  x = Lens(z, d) + σ n,   Lens = 2nd-order Taylor remap p ↦ p + d(p)
  θ = log A_φ (optionally + log A_z)

The Taylor remap is a sum of products of Fourier derivatives, smooth in
the field and in the deflection. (A bilinear gather warp is provided too,
but its displacement gradient jumps at pixel boundaries, which stalls
quasi-Newton MAP solvers.) The latents stay whitened, so the MAP Hessian is
I + O(signal²/σ²).

Every function here takes leading batch axes: the transforms run over the
last two axes and the derivative planes are stacked on the axis before
them, so one ``torch.fft`` call serves all lanes. The forward from
(u_z, u_φ) is four such calls: ``rfft2`` of each latent, one ``irfft2`` of
the six z-planes (z, z_x, z_y, z_xx, z_yy, z_xy) and one of the two
deflection planes. The explicit operator pair of the VarPro inner solve is
one ``irfft2`` of six planes for G and one ``rfft2`` of six planes for Gᵀ,
with the deflection's two calls paid once per inner solve; every
elementwise step around them is one of ``ops/lens_planes.py``'s passes
(hand-written kernels on a card), and VarPro's reduced gradient and its
certificate are explicit adjoints built from the same passes. (The JAX
package splits the planes 3 + 3 and pads the deflection stack with a zero
plane for a TPU FFT rule and for ``jax.linear_transpose``; neither applies
here.)
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..adapters.simple import SimpleMuseProblem
from ..ops.lens_planes import (derivative_diagonals, herm_sym, k_grids,
                               lens_combine, lens_contract, lens_expand,
                               lens_residual, lens_spread)
from ..utils import trace
from ..utils.keys import lane_generator
from .grf import GrfConfig, _host, _pack_spectrum, _unpack_spectrum

__all__ = ["lensing_problem", "bilinear_warp", "gradient_field",
           "taylor_lens", "zhat_varpro_counts"]

#: VarPro's two-phase MAP (``zhat_varpro``) over every lensing problem of
#: the process: the calls that entered the Newton-CG polish, the lanes
#: handed to it, and the lanes returned with ``converged`` false (frozen
#: at their budget, or failed)
zhat_varpro_counts = trace.declare(SimpleNamespace(), "polish_entries",
                                   "polished_lanes", "frozen_lanes",
                                   site="zhat_varpro")


def bilinear_warp(field: torch.Tensor, dx: torch.Tensor,
                  dy: torch.Tensor) -> torch.Tensor:
    """Sample ``field`` at (i+dy, j+dx) with periodic wrap (bilinear).

    Differentiable in the field (a linear gather) and in the displacements
    (piecewise-linear blend weights)."""
    n, m = field.shape
    ii = torch.arange(n, device=field.device)[:, None] + dy
    jj = torch.arange(m, device=field.device)[None, :] + dx
    i0 = torch.floor(ii)
    j0 = torch.floor(jj)
    fi = ii - i0
    fj = jj - j0
    i0 = i0.long() % n
    j0 = j0.long() % m
    i1 = (i0 + 1) % n
    j1 = (j0 + 1) % m
    return ((1 - fi) * (1 - fj) * field[i0, j0] + (1 - fi) * fj * field[i0, j1]
            + fi * (1 - fj) * field[i1, j0] + fi * fj * field[i1, j1])


def gradient_field(phi: torch.Tensor) -> tuple:
    """(∂φ/∂x, ∂φ/∂y) via Fourier ik on the periodic grid."""
    n = phi.shape[-1]
    K = derivative_diagonals(n, phi.device)[1:3]
    pf = torch.fft.rfft2(phi)
    return torch.fft.irfft2(pf[..., None, :, :] * K, s=(n, n)).unbind(-3)


def taylor_lens(z: torch.Tensor, dx: torch.Tensor,
                dy: torch.Tensor) -> torch.Tensor:
    """2nd-order Taylor remap z(p + d) ≈ z + d·∇z + ½ dᵀ(∇∇z)d, the
    standard small-deflection expansion in CMB lensing; every derivative is
    a Fourier ik product."""
    n = z.shape[-1]
    K = derivative_diagonals(n, z.device)[1:]
    zf = torch.fft.rfft2(z)
    zx, zy, zxx, zyy, zxy = torch.fft.irfft2(zf[..., None, :, :] * K,
                                             s=(n, n)).unbind(-3)
    return (z + dx * zx + dy * zy
            + 0.5 * (dx * dx * zxx + 2 * dx * dy * zxy + dy * dy * zyy))


def lensing_problem(n: int = 64, *, sigma_noise: float = 0.2,
                    gamma_z: float = 1.5, gamma_phi: float = 3.0,
                    defl_scale: float = 0.7, infer_z_amp: bool = False,
                    theta_true=None, data_seed: int = 42, x_obs=None,
                    prior_std: float = 3.0,
                    solver: str = "auto",
                    gn_cg_maxiter: Optional[int] = None,
                    gn_max_outer: Optional[int] = None,
                    varpro_m: Optional[int] = None,
                    varpro_explicit_adjoint: bool = True,
                    device="cuda") -> SimpleMuseProblem:
    """Build the lensing-style MUSE problem (see the module docstring).

    θ (a scalar, or a 2-vector with ``infer_z_amp``) is the log-amplitude
    of the lensing-potential (and optionally the unlensed-field) spectrum.
    ``defl_scale`` sets the rms deflection in pixels at θ = 0. ``x_obs``
    (an (n, n) array or tensor) is the data; without it the data are drawn
    at ``theta_true`` from ``data_seed``.

    ``solver`` picks the latent MAP algorithm:
      * ``"auto"`` (default) and ``"varpro"``: batched variable projection
        (``ops/varpro.py``). The observation is linear in the unlensed
        field given the potential, so the field is eliminated by a
        Fourier-preconditioned PCG in packed-Fourier coordinates and a
        reduced L-BFGS runs over the potential alone; lanes it leaves
        above the tolerance finish with a warm-started Newton-CG polish.
        (The JAX package's ``"auto"`` also means VarPro, guarded by a
        batch-width value certifier against a TPU compiler fault; the
        certifier is not ported.)
      * ``"newton"`` / ``"gn"``: batched trust-region Newton-CG over the
        joint latent (``ops/newton_cg.py``), exact HVPs;
      * ``"lbfgs"``: the generic batched L-BFGS path (the reference's only
        solver, src/interface.jl:162-166).

    MAP iteration budgets depend on n: ``gn_max_outer`` defaults to 100
    below 128², 40 from 128² and 25 from 512² (the polish 130 → 30 → 20
    over the same tiers), bounding the lockstep time one stalled lane can
    impose on a large-field batch. Lanes that spend the budget FREEZE with
    a warning and feed the score unconverged (the reference's
    non-convergence semantics, src/interface.jl:168-171); the warm-started
    next outer iteration normally recovers them. VarPro's inner
    elimination-CG budget (``varpro_inner_cg_maxiter`` in
    ``prob.solver_budgets``) drops from 50 to 35 from 512² on, and its
    line search from 15 trials to 6; budgets passed explicitly are always
    respected.
    """
    from ..ops.newton_cg import batched_newton_cg
    from ..ops.varpro import batched_varpro

    solvers = ("auto", "varpro", "newton", "gn", "lbfgs")
    if solver not in solvers:
        raise ValueError(f"solver must be one of {solvers}, got {solver!r}")
    cfg_z = GrfConfig(n, sigma_noise, gamma_z, 1.0, False, device=device)
    cfg_p = GrfConfig(n, sigma_noise, gamma_phi, 1.0, False, device=device)
    dev = cfg_z.device
    s2 = sigma_noise ** 2
    nr = n // 2 + 1
    n2 = n * n

    # Iteration budgets scale DOWN with the field size: a lane whose
    # objective sits at the float32 resolution floor (typical when the
    # outer Newton loop overshoots θ) would otherwise burn the full budget
    # in lockstep for every lane. Frozen-with-warning is the designed
    # behaviour for such lanes; the muse loop's warm starts recover them
    # at the next, better damped θ.
    if gn_max_outer is None:
        gn_max_outer = 100 if n < 128 else (40 if n < 512 else 25)
    # the small-n polish budget covers a worst-case VarPro handoff: a full
    # trust-region grind, one tr_refresh period and a ~20-iteration escape
    polish_max_outer = 130 if n < 128 else (30 if n < 512 else 20)
    # the Armijo loop re-solves the inner problem per trial, so it sets the
    # worst-case length of a solve
    varpro_max_ls = 15 if n < 512 else 6
    explicit_cg = gn_cg_maxiter is not None
    if not explicit_cg:
        gn_cg_maxiter = 50             # Newton-CG inner budget default
    inner_cg_eff = gn_cg_maxiter if (explicit_cg or n < 512) else 35

    # normalize the φ spectrum so that rms|∇φ| = defl_scale pixels at θ=0:
    # E[|∇φ|²] = (1/n²) Σ_modes (kx²+ky²) C_φ(k), exact, on the host in
    # float64
    ky64 = np.fft.fftfreq(n)[:, None] * 2 * np.pi
    kx64 = np.fft.rfftfreq(n)[None, :] * 2 * np.pi
    C0 = np.asarray(_host(cfg_p.spectrum(0.0)), np.float64)
    w64 = np.asarray(_host(cfg_p.herm_weight), np.float64)
    rms0 = float(np.sqrt(np.sum(w64 * (kx64 ** 2 + ky64 ** 2) * C0) / n ** 2))
    phi_norm = defl_scale / max(rms0, 1e-12)

    ky, kx = k_grids(n, dev)
    # the spectral diagonals of (z, z_x, z_y, z_xx, z_yy, z_xy)
    K6 = derivative_diagonals(n, dev)
    Cz0 = cfg_z.spectrum(0.0)
    Cp0 = cfg_p.spectrum(0.0)
    sqCz = torch.sqrt(Cz0)
    sqCp = torch.sqrt(Cp0)
    wh = cfg_z.herm_weight
    k2_grid = ky ** 2 + kx ** 2                # (n, nr)

    def _amps(theta):
        th = torch.atleast_1d(cfg_z.theta_tensor(theta))
        a_phi = torch.exp(0.5 * th[0])
        a_z = torch.exp(0.5 * th[1]) if infer_z_amp else 1.0
        return a_phi, a_z

    def _irfft2(spec):
        return torch.fft.irfft2(spec, s=(n, n), dim=(-2, -1))

    def _rfft2(field):
        return torch.fft.rfft2(field, dim=(-2, -1))

    def _deflection(uphi, a_phi):
        """The (…, 2, n, n) stack (dx, dy) of the potential S_φ u_φ: one
        rfft2, one irfft2 of the two planes."""
        pf = (phi_norm * a_phi * sqCp) * _rfft2(uphi)
        return _irfft2(pf[..., None, :, :] * K6[1:3])

    def _lens_parts_zf(zf_u, uphi, theta):
        # entered from the z-spectrum: the VarPro linear block lives in
        # packed-Fourier coordinates, so its obs_op skips the leading rfft2
        a_phi, a_z = _amps(theta)
        zf = (a_z * sqCz) * zf_u
        z, zx, zy, zxx, zyy, zxy = _irfft2(zf[..., None, :, :] * K6
                                           ).unbind(-3)
        dx, dy = _deflection(uphi, a_phi).unbind(-3)
        lin = dx * zx + dy * zy
        quad = dx * dx * zxx + 2 * dx * dy * zxy + dy * dy * zyy
        return z + lin + 0.5 * quad, lin, quad

    def _lens_parts(uz, uphi, theta):
        return _lens_parts_zf(_rfft2(uz), uphi, theta)

    def _forward(uz, uphi, theta):
        return _lens_parts(uz, uphi, theta)[0]

    def grad_theta(x, u, theta):
        """Analytic ∂θ log_like (exact; the ∇θ_logLike override).

        d ∝ a_φ = e^{θ₀/2} ⇒ ∂F/∂θ₀ = ½(d·∇z) + ½(dᵀ∇∇z d); every term of
        F carries one factor of z ∝ a_z = e^{θ₁/2} ⇒ ∂F/∂θ₁ = F/2. One
        forward pass in place of AD's forward and reverse sweeps."""
        F, lin, quad = _lens_parts(u["uz"], u["uphi"], theta)
        r = x - F
        g0 = torch.sum(r * (lin + quad)) / (2 * s2)
        if not infer_z_amp:
            scalar = (theta.dim() if isinstance(theta, torch.Tensor)
                      else np.ndim(theta)) == 0
            return g0 if scalar else g0.reshape(1)
        return torch.stack([g0, torch.sum(r * F) / (2 * s2)])

    # CRN white split (problem.py): the latents ARE whitened fields, so
    # every draw is θ-independent; x depends on all three parts, and only
    # the θ-dependent lens forward re-runs per iteration
    def sample_white(gen):
        return tuple(torch.randn((n, n), generator=gen, device=dev)
                     for _ in range(3))

    def x_of_white(W, theta):
        uz, uphi, e = W
        x = _forward(uz, uphi, theta) + sigma_noise * e
        return x, {"uphi": uphi, "uz": uz}

    def sample_x_z(gen, theta):
        return x_of_white(sample_white(gen), theta)

    def log_like(x, u, theta):
        r = x - _forward(u["uz"], u["uphi"], theta)
        return -0.5 * (torch.sum(r * r) / s2
                       + torch.sum(u["uz"] ** 2) + torch.sum(u["uphi"] ** 2))

    def log_prior(theta):
        th = torch.atleast_1d(cfg_z.theta_tensor(theta))
        return -torch.sum(th ** 2) / (2 * prior_std ** 2)

    # ---- batched MAP solvers (custom_zhat) ---------------------------- #
    # flat latent layout: dict keys in sorted order → [uphi; uz]

    def _vg_full(xs, th_flat):
        """Batched value and gradient of −logLike over flat [uφ; uz] lanes:
        the lanes are independent, so the gradient of their sum is each
        lane's gradient."""
        def fsum(U):
            u = U.reshape(-1, 2, n, n)
            r = xs - _forward(u[:, 1], u[:, 0], th_flat)
            f = 0.5 * (torch.sum(r * r, (-2, -1)) / s2
                       + torch.sum(u * u, (1, 2, 3)))
            return f.sum(), f

        def fn(U):
            g, f = torch.func.grad(fsum, has_aux=True)(U)
            return f, g
        return fn

    def _precond_diagonals(th_flat):
        """The Fourier diagonals (M_φ, M_z) of I + JᵀJ/σ², per block:
          z-block: the remap is near-unitary ⇒ JᵀJ ≈ a_z²C_z
          φ-block: F ≈ z + d·∇z with d = φ_norm a_φ ∇S_φ u_φ ⇒ per mode
                   |J|² ≈ (φ_norm a_φ)² k² C_φ · E|∇z|²"""
        a_phi, a_z = _amps(th_flat)
        gz2 = (a_z ** 2) * torch.sum(wh * k2_grid * Cz0) / n ** 2  # E|∇z|²
        Mz = 1.0 + (a_z ** 2) * Cz0 / s2
        Mp = 1.0 + (phi_norm * a_phi) ** 2 * k2_grid * Cp0 * gz2 / s2
        return torch.stack([Mp, Mz])

    def _precond2(th_flat):
        """Fourier-diagonal approximation of (I + JᵀJ/σ²)⁻¹ on flat
        [uφ; uz] lanes: one rfft2 and one irfft2 of both blocks."""
        M = _precond_diagonals(th_flat)

        def precond(Rflat):
            R = Rflat.reshape(-1, 2, n, n)
            return _irfft2(_rfft2(R) / M).reshape(Rflat.shape)
        return precond

    def _newton(xs, Z0, th_flat, atol, field, max_outer):
        """``batched_newton_cg`` on the joint latent: on whole lanes, or
        with ``field`` (a FieldColumns of the gathered route) on this
        rank's columns, the objective, its HVP and the preconditioner
        evaluated on the gathered latent."""
        vg = _vg_full(xs, th_flat)
        kw = dict(g_atol=atol, max_outer=max_outer, cg_maxiter=gn_cg_maxiter)
        if field is None or field.mesh is None:
            return batched_newton_cg(vg, Z0, precond=_precond2(th_flat), **kw)
        return batched_newton_cg(
            field.value_and_grad(vg), Z0,
            precond=field.on_columns(_precond2(th_flat)),
            reduce=field.reduce, reduce_max=field.reduce_max,
            hvp_at=field.hvp_at(vg), **kw)

    def zhat_newton(xs, Z0, th_flat, atol, field=None):
        res = _newton(xs, Z0, th_flat, atol, field, gn_max_outer)
        aux = {"converged": res.converged, "failed": res.failed,
               "iterations": res.iterations,
               "cg_iterations": res.cg_iterations,
               "g_norm": res.g_norm, "neg_logp": res.f}
        return res.z, aux

    sqw_n = torch.sqrt(wh) / n            # (n, nr) isometric pack scale

    def _pack(zf):                        # (…, n, nr) complex → (…, 2·n·nr)
        return _pack_spectrum(zf, sqw_n)

    def _unpack(zt):                      # inverse of _pack ∘ projection
        return herm_sym(_unpack_spectrum(zt, sqw_n))

    def varpro_ops(th_flat):
        """The pieces ``batched_varpro`` runs on at θ: ``obs_op``,
        the explicit ``lin_ops``, ``precond_lin`` and ``lin_sup``, with the
        packing (``pack``, ``unpack``) of the linear block; from the same
        passes, the reduced objective ``value_and_grad(xs)`` (its
        ``f_and_g``) and the joint objective's ``certificate``; and what
        the passes are handed, the potential's ``deflection`` (dx, dy) and
        the spectral ``scale`` c.

        The linear (unlensed-field) block is handed to the solver in
        PACKED-FOURIER coordinates z̃ = pack(√w/n · rfft2(u_z)), an isometry
        (Parseval with hermitian weights), so ½‖z̃‖² is exactly the whitened
        prior and the objective is unchanged. Per inner-CG iteration the
        obs_op skips the leading rfft2 (and its transpose the trailing
        one), and the Fourier-diagonal preconditioner is a pointwise
        multiply.

        The lens map at a fixed potential is Σ_j D_j·irfft2(S_j·c·unpack(z̃))
        with pixel diagonals D_j ∈ {1, dx, dy, ½dx², ½dy², dx·dy} and
        spectral diagonals S_j ∈ {1, ikx, iky, −kx², −ky², −kx·ky}, so its
        exact adjoint in packed coordinates is
        pack(herm_sym(Σ_j conj(S_j)·c·rfft2(D_j·w))): the packing is an
        isometry, which makes the adjoint of irfft2 pack∘rfft2. Every
        elementwise step of both is one of ``ops/lens_planes.py``'s four
        passes (kernels on a card); only the deflection (dx, dy) is kept
        between them. The deflection is a real convolution of u_φ, so the
        adjoint of its multiplier c_φ·K_a is the conjugate multiplier: the
        gradients are explicit, with no autograd tape."""
        a_phi, a_z = _amps(th_flat)
        czs = a_z * sqCz                  # (n, nr) real spectral scale
        cphi = phi_norm * a_phi * sqCp    # (n, nr) the potential's scale

        def obs_op(Up, Zt):
            return _lens_parts_zf(_unpack(Zt),
                                  Up.reshape(Up.shape[:-1] + (n, n)),
                                  th_flat)[0]

        def defl(Up):
            return _deflection(Up.reshape(Up.shape[:-1] + (n, n)), a_phi)

        def lin_ops(Up):
            """Explicit (G, Gᵀ) of the lens operator at a fixed potential:
            G = combine(irfft2(expand(z̃))), Gᵀ = contract(rfft2(spread(w))).
            The deflections are computed once per inner solve."""
            d = defl(Up)

            def G(Zt):
                return lens_combine(_irfft2(lens_expand(Zt, czs)), d)

            def Gt(W):
                return lens_contract(_rfft2(lens_spread(W, d)), czs)
            return G, Gt

        def residual(xs, d, Zt, keep_r=True):
            """(r = x − G z̃ or None, Σr² a lane, the (B, 2, n, n)
            cotangents r·∂F/∂(dx, dy))."""
            return lens_residual(_irfft2(lens_expand(Zt, czs)), d, xs, keep_r)

        def grad_uphi(Up, A):
            """∂/∂u_φ of ½‖x − F‖²/σ² + ½‖u_φ‖² from the cotangents A."""
            back = _irfft2(cphi * (_rfft2(A) * K6[1:3].conj()).sum(-3))
            return Up - back.reshape(Up.shape) / s2

        def value_and_grad(xs):
            """``(U, z̃) -> (f, ∂f/∂u_φ)``: the reduced objective
            ½‖x − G z̃‖²/σ² + ½‖U‖² + ½‖z̃‖² a lane and its envelope gradient
            at the fixed z̃."""
            def f_and_g(Up, Zt):
                _, rr, A = residual(xs, defl(Up), Zt, keep_r=False)
                f = 0.5 * (rr / s2 + (Up * Up).sum(-1) + (Zt * Zt).sum(-1))
                return f, grad_uphi(Up, A)
            return f_and_g

        def certificate(xs, Up, Zt, uz):
            """(f, ∇f) of the joint objective −log_like over flat
            [u_φ; u_z] at u_z = ``uz`` (B, n²) = irfft2(unpack(z̃)), from the
            same passes: ∂/∂u_z = u_z − irfft2(unpack(Gᵀr))/σ², the adjoint
            of the isometric packing being its inverse."""
            d = defl(Up)
            r, rr, A = residual(xs, d, Zt)
            g_phi = grad_uphi(Up, A)
            del A
            back = _irfft2(_unpack(lens_contract(_rfft2(lens_spread(r, d)),
                                                 czs)))
            del r, d
            g_z = uz - back.reshape(uz.shape) / s2
            f = 0.5 * (rr / s2 + (Up * Up).sum(-1) + (uz * uz).sum(-1))
            return f, torch.cat([g_phi, g_z], -1)

        # the exact Fourier-diagonal preconditioner, a pointwise multiply
        Mz_packed = (1.0 / (1.0 + (a_z ** 2) * Cz0 / s2)).reshape(-1).repeat(2)

        def precond_lin(R):
            return R * Mz_packed

        # z-block residual measure: the EXACT pixel-space sup-norm. The
        # packing is an isometry, so the pixel gradient is
        # irfft2(unpack(r)): one irfft2 per CG stopping check. (The raw
        # spectral max-abs is ~√N too strict for smooth residuals, and an
        # RMS proxy under-certifies structured ones.)
        def lin_sup(R):
            return _irfft2(_unpack(R)).abs().amax((-2, -1))

        return {"obs_op": obs_op, "lin_ops": lin_ops,
                "precond_lin": precond_lin, "precond_diag": Mz_packed,
                "lin_sup": lin_sup, "pack": _pack, "unpack": _unpack,
                "value_and_grad": value_and_grad,
                "certificate": certificate, "deflection": defl,
                "scale": czs}

    def _varpro_on_columns(ops, xs, Z0w, atol, field):
        """``batched_varpro`` on the gathered route: u_nl and the packed
        z̃ kept as this rank's columns of each (from the gathered warm
        start ``Z0w``), the explicit pair G (columns → the whole
        observation) and Gᵀ (whole → columns) and the reduced objective on
        the gathered blocks, the residual's pixel sup-norm on the gathered
        z̃. Returns the result with its blocks gathered whole."""
        from ..parallel.mesh import FieldColumns
        B = Z0w.shape[0]
        uc = FieldColumns(field.mesh, n2)
        zc = FieldColumns(field.mesh, 2 * n * nr)

        def lin_ops(Uc):
            G, Gt = ops["lin_ops"](uc.gather(Uc))
            return (lambda Zc: G(zc.gather(Zc))), (lambda W: zc.keep(Gt(W)))

        vg = ops["value_and_grad"](xs)

        def f_and_g(Uc, Zc):
            f, g = vg(uc.gather(Uc), zc.gather(Zc))
            return f, uc.keep(g)

        Mz = zc.keep(ops["precond_diag"])

        res = batched_varpro(
            ops["obs_op"], xs, uc.keep(Z0w[:, :n2]),
            zc.keep(_pack(_rfft2(Z0w[:, n2:].reshape(B, n, n)))),
            sigma2=s2, g_atol=atol, max_outer=gn_max_outer,
            inner_maxiter=inner_cg_eff, max_ls=varpro_max_ls, m=m_eff,
            precond_lin=lambda R: R * Mz,
            lin_sup=lambda R: ops["lin_sup"](zc.gather(R)), lin_ops=lin_ops,
            reduce=field.reduce, reduce_max=field.reduce_max,
            f_and_g=f_and_g)
        return res._replace(u_nl=uc.gather(res.u_nl),
                            z_lin=zc.gather(res.z_lin))

    # m bounds the outer L-BFGS history (2·m·B·n² floats): the full history
    # at small n (one hard lane at strong lensing gains from it), a short
    # one at field sizes where memory binds (the reduced problem converges
    # in tens of iterations)
    m_eff = varpro_m if varpro_m is not None else (10 if n < 512 else 5)
    counts = zhat_varpro_counts

    def zhat_varpro(xs, Z0, th_flat, atol, field=None):
        """Two-phase MAP: VarPro for the bulk, a Newton-CG polish for the
        tail. VarPro converges most lanes in tens of reduced iterations;
        the few that stall in the reduced φ-landscape at strong lensing
        finish with warm-started trust-region Newton-CG, whose local
        quadratic convergence is what an iterate near the solution needs
        (converged lanes freeze at polish entry). The polish runs only
        when a lane is left: one host read decides. The VarPro phase runs
        in the span ``muse.varpro.solve`` and the polish in
        ``muse.varpro.polish``; :data:`zhat_varpro_counts` counts the
        polished and the frozen lanes (a polish adds one read for the
        latter).

        ``field``: on the gathered route of a field axis, Z0 and the
        result are this rank's columns of the joint latent, and both
        solvers keep their vectors as columns (their ``reduce`` hooks);
        the certificate runs on the gathered MAP."""
        B = Z0.shape[0]
        xs = xs.contiguous()              # the passes take whole planes
        ops = varpro_ops(th_flat)
        on_cols = field is not None and field.mesh is not None
        with trace.span("muse.varpro.solve"):
            if on_cols:
                res = _varpro_on_columns(ops, xs, field.gather(Z0), atol,
                                         field)
            else:
                Zt0 = _pack(_rfft2(Z0[:, n2:].reshape(B, n, n)))
                res = batched_varpro(
                    ops["obs_op"], xs, Z0[:, :n2], Zt0, sigma2=s2,
                    g_atol=atol, max_outer=gn_max_outer,
                    inner_maxiter=inner_cg_eff, max_ls=varpro_max_ls,
                    m=m_eff, precond_lin=ops["precond_lin"],
                    lin_sup=ops["lin_sup"],
                    lin_ops=(ops["lin_ops"] if varpro_explicit_adjoint
                             else None),
                    f_and_g=ops["value_and_grad"](xs))
            uz_hat = _irfft2(_unpack(res.z_lin)).reshape(B, -1)

            # Exact certificate: one value and gradient of the joint
            # objective gives the TRUE sup-norm. It decides polish entry
            # and is what aux reports, so downstream consumers
            # (implicit-diff get_H stationarity, non-convergence warnings)
            # see real gradients.
            f_true, g_true = ops["certificate"](xs, res.u_nl, res.z_lin,
                                                uz_hat)
            Z = torch.cat([res.u_nl, uz_hat], -1)
            del uz_hat
            sup_true = g_true.abs().amax(-1)
            del g_true
            conv_true = sup_true < torch.as_tensor(
                atol, dtype=sup_true.dtype, device=sup_true.device)
            aux = {"converged": conv_true, "failed": res.failed,
                   "iterations": res.iterations,
                   "cg_iterations": res.inner_iterations,
                   "g_norm": sup_true, "neg_logp": f_true}
            # one read gives the lanes left for the polish and, where none
            # is, the lanes returned unconverged (the failed ones)
            left, unconv = torch.stack([
                (~(conv_true | res.failed)).sum(),
                (~conv_true).sum()]).tolist()
        if not left:
            counts.frozen_lanes += unconv
            return (field.keep(Z) if on_cols else Z), aux
        counts.polish_entries += 1
        counts.polished_lanes += left
        with trace.span("muse.varpro.polish"):
            pol = _newton(xs, field.keep(Z) if on_cols else Z, th_flat,
                          atol, field, polish_max_outer)
            aux = {"converged": pol.converged,
                   "failed": res.failed & pol.failed,
                   "iterations": res.iterations + pol.iterations,
                   "cg_iterations": res.inner_iterations + pol.cg_iterations,
                   "g_norm": pol.g_norm, "neg_logp": pol.f}
            counts.frozen_lanes += int((~pol.converged).sum())
        return pol.z, aux

    if solver == "auto":
        solver = "varpro"
    custom = {"gn": zhat_newton, "newton": zhat_newton,
              "varpro": zhat_varpro, "lbfgs": None}[solver]

    if theta_true is None:
        theta_true = torch.zeros(2, device=dev) if infer_z_amp else 0.0
    if x_obs is None:
        x_obs, _ = sample_x_z(lane_generator(data_seed, dev), theta_true)
    else:
        x_obs = torch.tensor(np.asarray(_host(x_obs), np.float32),
                             device=dev)

    prob = SimpleMuseProblem(x_obs, sample_x_z, log_like, log_prior,
                             custom_zhat=custom,
                             grad_theta_log_like=grad_theta, device=dev,
                             sample_white=sample_white,
                             x_of_white=x_of_white)
    prob.name = "lensing_problem"
    prob.lensing_n = n
    # the resolved budgets, open to inspection (the n-dependent defaults
    # are policy; explicit keyword arguments pass through)
    prob.solver_budgets = {
        "solver": solver, "gn_max_outer": gn_max_outer,
        "polish_max_outer": polish_max_outer,
        # gn_cg_maxiter is what Newton-CG and the VarPro polish run with;
        # VarPro's inner elimination-CG has its own (scaled) budget
        "gn_cg_maxiter": gn_cg_maxiter,
        "varpro_inner_cg_maxiter": inner_cg_eff,
        "varpro_max_ls": varpro_max_ls}
    prob.varpro_ops = varpro_ops
    prob.zhat_varpro = zhat_varpro
    prob.value_and_grad = _vg_full
    prob.precond = _precond2

    def h_precond(w, x, th_flat):
        """Ready-made CG preconditioner for implicit-diff get_H (the Pl
        hook, src/muse.jl:312): the single-sim Fourier-diagonal
        approximation of (−∇z² logLike)⁻¹. Pass as ``get_H(...,
        implicit_diff=True, implicit_diff_precond=
        prob.suggested_h_precond)``."""
        M = _precond_diagonals(th_flat)
        return _irfft2(_rfft2(w.reshape(2, n, n)) / M).reshape(-1)

    prob.suggested_h_precond = h_precond

    # Wiener-informed warm start for the muse loop's cold start: treat the
    # data as unlensed and invert the whitening for u_z; φ starts at 0.
    # Pass as muse(..., z0=prob.suggested_z0).
    Cz = np.asarray(_host(Cz0), np.float64)
    xf = np.fft.rfft2(np.asarray(_host(x_obs), np.float64))
    uz0 = np.fft.irfft2(np.sqrt(Cz) * xf / (Cz + s2), s=(n, n))
    prob.suggested_z0 = {
        "uphi": torch.zeros((n, n), dtype=torch.float32, device=dev),
        "uz": torch.tensor(uz0, dtype=torch.float32, device=dev)}
    return prob
