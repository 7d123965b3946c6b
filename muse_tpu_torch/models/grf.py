"""Gaussian-random-field models: the field GRF and the packed spectral GRF.

Counterpart of ``muse_tpu/models/grf.py``'s hermitian white sampler
(grf.py:46-107), ``GrfConfig`` (the ``"fft"`` transform mode;
grf.py:110-173), ``grf_problem`` (grf.py:176-413),
``grf_spectral_problem`` (grf.py:416-662), ``grf_field_problem``
(grf.py:665-738) and ``grf_marginal_mle`` (grf.py:741-805).

``grf_field_problem`` infers the log-amplitude θ of the power spectrum
C_k(θ) = e^θ (k+k0)^(−γ) of a 2D field z from x = z + σ·noise. Its latent
IS the field, and its log-likelihood's Fourier-space term
Σ_k w_k|ẑ_k|²/C_k runs in the hand-written CUDA kernel of
``ops/grf_spectrum.py`` on a card. The MAP is the Wiener filter
ẑ_k = C x̂_k/(C+σ²), batched over lanes.

``grf_problem`` is the same model with the WHITE field u as its latent,
z = S_θ u, in pixel space: its MAP enters and leaves the packed-spectral
PCG through cuFFT, and its analytic θ-score ½Σ w|x̂|²·∂C/(C+σ²)²/n² is one
``spectrum_quadform`` launch per batched evaluation.

``grf_spectral_problem`` carries x and the white latent in the isometric
packing ṽ = pack(√w/n · rfft2(v)), where every operator is diagonal: its
MAP is a batched PCG whose operator and curvature run in the fused
``spectrum_quadform_and_grad`` kernel, and its analytic θ-score in the
``spectrum_quadform`` kernel.

Transforms are ``torch.fft`` with the default "backward" norm, as
``jnp.fft`` uses. Every tensor lives on the configuration's device, in
float32; the device defaults to the card (``"cuda"``) and raises where
there is none.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..adapters.simple import SimpleMuseProblem
from ..utils.device import resolve_device
from ..utils.keys import lane_generator

__all__ = ["GrfConfig", "grf_problem", "grf_field_problem",
           "grf_spectral_problem", "grf_marginal_mle",
           "hermitian_white_packed", "pack_field_host"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@functools.lru_cache(maxsize=None)
def _herm_white_coeffs(n: int):
    """Mask coefficients for drawing pack(rfft2(N(0,1)^{n×n})) by indexing.

    A copy of muse_tpu's ``_herm_white_coeffs`` (grf.py:49-84). Per packed
    coordinate of a hermitian white spectrum: generic modes (herm weight 2)
    are iid N(0,1); in the two self-mirrored columns (0 and n/2) rows r and
    n−r are conjugate duplicates (re copied, im negated, each N(0,1/2));
    the four self-conjugate modes are real N(0,1). Encoded as a
    mask-weighted combination of a normal draw and its row-flip
    r→(n−r) mod n. Returns four read-only (n, n//2+1) float32 arrays
    (a, b, c, d): re = a·g + b·flip(g), im = c·h + d·flip(h).
    """
    nr = n // 2 + 1
    a = np.ones((n, nr), np.float32)         # own-draw coefficient (re)
    b = np.zeros((n, nr), np.float32)        # flipped-draw coefficient
    c = np.ones((n, nr), np.float32)         # own-draw coefficient (im)
    d = np.zeros((n, nr), np.float32)
    self_rows = [0] + ([n // 2] if n % 2 == 0 else [])
    spec_cols = [0] + ([nr - 1] if n % 2 == 0 else [])
    for col in spec_cols:
        for r in range(n):
            if r in self_rows:
                a[r, col], c[r, col] = 1.0, 0.0      # real mode
            elif r < n - r:
                a[r, col] = c[r, col] = 1.0 / np.sqrt(2.0)
            else:                                    # mirror of n−r
                a[r, col] = c[r, col] = 0.0
                b[r, col] = 1.0 / np.sqrt(2.0)
                d[r, col] = -1.0 / np.sqrt(2.0)
    for v in (a, b, c, d):
        v.flags.writeable = False
    return a, b, c, d


def _herm_white_tensors(n: int, device) -> tuple:
    return tuple(torch.tensor(v, device=device) for v in _herm_white_coeffs(n))


def _herm_white_draw(gen: torch.Generator, n: int, coeffs) -> torch.Tensor:
    a, b, c, d = coeffs
    shape = (n, n // 2 + 1)
    g = torch.randn(shape, generator=gen, device=a.device)
    h = torch.randn(shape, generator=gen, device=a.device)

    def flip(v):                              # r → (n − r) mod n
        return torch.roll(v.flip(0), 1, dims=0)

    re = a * g + b * flip(g)
    im = c * h + d * flip(h)
    return torch.cat([re.reshape(-1), im.reshape(-1)])


def hermitian_white_packed(gen: torch.Generator, n: int) -> torch.Tensor:
    """Draw pack(rfft2(white n×n field))-distributed noise without an FFT.

    Two (n, n//2+1) normal draws from ``gen`` (g, then h), combined by the
    masks of :func:`_herm_white_coeffs`; the (L,) result, L = 2·n·(n//2+1),
    lies on ``gen``'s device (muse_tpu grf.py:87-107, with a generator in
    place of the key)."""
    return _herm_white_draw(gen, n, _herm_white_tensors(n, gen.device))


def pack_field_host(x, herm_weight, n: int) -> np.ndarray:
    """Real (n, n) field → packed (L,) float32, on the host in float64
    (muse_tpu grf.py:633-640): pack(√w/n · rfft2(x))."""
    xf = np.fft.rfft2(np.asarray(_host(x), np.float64))
    xf = xf * (np.sqrt(np.asarray(_host(herm_weight), np.float64)) / n)
    return np.concatenate([xf.real.reshape(-1),
                           xf.imag.reshape(-1)]).astype(np.float32)


def _pack_spectrum(zf: torch.Tensor, sqw_n: torch.Tensor) -> torch.Tensor:
    """(…, n, m) complex half-spectrum → (…, 2·n·m) real, scaled by the
    isometric pack scale ``sqw_n`` = √w/n: [real; imag], each flattened."""
    zs = zf * sqw_n
    return torch.cat([zs.real.flatten(-2), zs.imag.flatten(-2)], -1)


def _unpack_spectrum(zt: torch.Tensor, sqw_n: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_pack_spectrum`."""
    re, im = zt.chunk(2, -1)
    return torch.complex(re, im).reshape(zt.shape[:-1] + sqw_n.shape) / sqw_n


def _packed_diag_pcg(A, b, Z0, atol, cg_maxiter, grid, nz=None):
    """Batched PCG on the diagonal system A·z = b in packed coordinates,
    preconditioned by the exact inverse 1/A. ``A`` is (1, L), ``b`` and the
    warm start ``Z0`` are (B, L), and ``grid`` = (n, 2m) is the kernels'
    view of a packed (L,). The operator and the curvature (Ap, pᵀAp) of
    every step come from one ``spectrum_quadform_and_grad`` call: the fused
    kernel on a card. Returns (the (B, L) solution, the MAP solver's aux
    dict).

    The CG residual r = b − Az is −∇z(−log_like) exactly, so the stop
    follows the solver-wide ∇z tolerance, an ABSOLUTE gradient norm:
    ``atol``·√nz (the L∞→L2 envelope; ``nz`` is the latent's length, L
    unless the caller's latent lives in pixels) over ‖b‖ is the per-lane
    relative tolerance that ``batched_cg`` takes."""
    from ..ops.cg import batched_cg
    from ..ops.grf_spectrum import spectrum_quadform_and_grad

    A_grid = A.reshape(grid)
    r0 = b - A * Z0
    b_norm = torch.linalg.vector_norm(b, dim=-1)
    rel_tol = atol * float(np.sqrt(np.float32(nz or Z0.shape[1]))) / \
        torch.clamp(b_norm, min=1e-30)

    def matvec_and_curvature(P):
        quad, half = spectrum_quadform_and_grad(
            P.reshape((P.shape[0],) + grid), A_grid)
        return half.reshape(P.shape), quad

    res = batched_cg(None, None, Z0, tol=rel_tol, maxiter=cg_maxiter,
                     precond=lambda R: R / A, r0=r0, z0=r0 / A,
                     b_norm=b_norm,
                     matvec_and_curvature=matvec_and_curvature)
    return res.x, {"converged": res.converged,
                   "failed": ~torch.isfinite(res.r_norm),
                   "iterations": res.iterations, "g_norm": res.r_norm}


class GrfConfig:
    """Static configuration for a GRF amplitude(/tilt) problem.

    ``k`` and ``herm_weight`` (each (n, n//2+1)) are computed from ``n``
    unless given, which lets ``convert.grf_config_from_arrays`` carry the
    JAX package's arrays across unchanged."""

    def __init__(self, n: int = 256, sigma_noise: float = 1.0,
                 gamma: float = 2.0, k0: float = 1.0,
                 infer_tilt: bool = False, *, device="cuda",
                 k=None, herm_weight=None):
        self.n = n
        self.sigma_noise = sigma_noise
        self.gamma = gamma
        self.k0 = k0
        self.infer_tilt = infer_tilt
        self.device = resolve_device(device)
        if k is None:
            ky = np.fft.fftfreq(n) * n
            kx = np.fft.rfftfreq(n) * n
            k = np.hypot(ky[:, None], kx[None, :])
        if herm_weight is None:
            # multiplicity of each rfft2 mode in the full hermitian spectrum
            # (columns 0 and n/2 appear once, the others twice)
            herm_weight = np.full((n, n // 2 + 1), 2.0)
            herm_weight[:, 0] = 1.0
            if n % 2 == 0:
                herm_weight[:, -1] = 1.0
        self.k = torch.tensor(np.asarray(k, np.float32), device=self.device)
        self.herm_weight = torch.tensor(np.asarray(herm_weight, np.float32),
                                        device=self.device)
        if tuple(self.k.shape) != (n, n // 2 + 1) or \
                self.herm_weight.shape != self.k.shape:
            raise ValueError(f"k and herm_weight must be ({n}, {n // 2 + 1})")

    def theta_tensor(self, theta) -> torch.Tensor:
        """θ as a float32 tensor on the device (differentiable if it was)."""
        if isinstance(theta, torch.Tensor):
            return theta.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(theta, np.float32),
                               device=self.device)

    def rfft2(self, u):
        """Batched 2D real FFT over the trailing axes."""
        return torch.fft.rfft2(u, dim=(-2, -1))

    def irfft2(self, v):
        """Inverse of :meth:`rfft2` for hermitian-consistent spectra."""
        return torch.fft.irfft2(v, s=(self.n, self.n), dim=(-2, -1))

    def spectrum(self, theta) -> torch.Tensor:
        """C_k(θ) = e^{θ₀} (k+k0)^{-(γ+θ₁)} on the rfft grid."""
        th = torch.atleast_1d(self.theta_tensor(theta))
        gamma = self.gamma + (th[1] if self.infer_tilt else 0.0)
        return torch.exp(th[0]) * (self.k + self.k0) ** (-gamma)

    def apply_sqrtC(self, u, theta):
        """z = S_θ u = F⁻¹(√C_k · F u) — real symmetric operator."""
        return self.irfft2(torch.sqrt(self.spectrum(theta)) * self.rfft2(u))

    def apply_C(self, u, theta):
        """F⁻¹(C_k · F u): the field covariance applied to u."""
        return self.irfft2(self.spectrum(theta) * self.rfft2(u))


def grf_problem(config: Optional[GrfConfig] = None, *, n: int = 256,
                sigma_noise: float = 1.0, gamma: float = 2.0,
                k0: float = 1.0, infer_tilt: bool = False,
                theta_true=None, data_seed: int = 42, x_obs=None,
                solver: str = "cg", cg_maxiter: int = 200,
                prior_std: float = 3.0, mesh=None,
                fft_mode: str = "auto", device="cuda") -> SimpleMuseProblem:
    """The whitened GRF in pixel space: the latent is the white field
    u ~ N(0, I), z = S_θ u, x = z + σ·noise.

    Counterpart of muse_tpu's ``grf_problem`` (grf.py:176-413). The latent
    Hessian is I + S_θᵀS_θ/σ², of bounded condition number.

      * ``solver="cg"`` (default): the batched PCG in packed-spectral
        coordinates, where the normal-equation operator A = 1 + C/σ² is
        diagonal. The only transforms of a solve are ``rfft2`` of x and of
        the warm start at entry and one ``irfft2`` at exit; every CG step
        is one launch of the fused ``spectrum_quadform_and_grad`` kernel
        on a card. ``"direct"``: the Fourier-diagonal closed form
        û = √C x̂/(σ²+C). ``"lbfgs"``: no ``custom_zhat``, so the MAPs take
        the generic batched L-BFGS on the log-likelihood.
      * ``grad_theta``: the analytic score at the exact MAP, the
        cancellation-free sum ½ Σ w p ∂C/(C+σ²)², p = |x̂|²/n², through the
        ``spectrum_quadform`` kernel: one launch per batched evaluation and
        θ component.
      * ``fft_mode``: ``"auto"`` and ``"fft"`` are ``torch.fft``. The
        einsum DFT (``"matmul"``) exists in the JAX package for sharded
        layouts that XLA's FFT rejects and is not ported (ROADMAP, "Left
        out on purpose"). ``mesh`` is not ported yet (ROADMAP Queue 1 item
        10).

    ``x_obs`` (an (n, n) array or tensor) is the data; without it the data
    are drawn at ``theta_true`` from ``data_seed``. ``config``, when given,
    fixes the device.
    """
    from ..ops.grf_spectrum import (pack_rfft2, pack_weights,
                                    spectrum_quadform)

    if solver not in ("cg", "direct", "lbfgs"):
        raise ValueError(f"solver must be 'cg'|'direct'|'lbfgs', got "
                         f"{solver!r}")
    if fft_mode not in ("auto", "fft", "matmul"):
        raise ValueError(f"fft_mode must be 'auto'|'fft'|'matmul', got "
                         f"{fft_mode!r}")
    if fft_mode == "matmul":
        raise NotImplementedError(
            "grf_problem(fft_mode='matmul'): the einsum DFT guards a fault "
            "of XLA's FFT under sharding and is left out of the port "
            "(ROADMAP, 'Left out on purpose')")
    if mesh is not None:
        raise NotImplementedError(
            "grf_problem(mesh=...) is not ported yet (ROADMAP Queue 1 item "
            "10)")
    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, infer_tilt,
                              device=device)
    n = cfg.n
    s2 = cfg.sigma_noise ** 2
    dev = cfg.device
    nr = n // 2 + 1
    grid = (n, 2 * nr)       # the kernels' (n, 2m) view of a packed (L,)
    sqw_n = torch.sqrt(cfg.herm_weight) / n   # isometric pack scale
    neg_logk = -torch.log(cfg.k + cfg.k0)

    # CRN white split (problem.py): the pixel whites are θ-independent, so
    # the muse loop hoists the RNG out of the outer iteration (the
    # θ-dependent √C scaling stays)
    def sample_white(gen):
        return (torch.randn((n, n), generator=gen, device=dev),
                torch.randn((n, n), generator=gen, device=dev))

    def x_of_white(W, theta):
        u, e = W
        return cfg.apply_sqrtC(u, theta) + cfg.sigma_noise * e, u

    def sample_x_z(gen, theta):
        return x_of_white(sample_white(gen), theta)

    def log_like(x, u, theta):
        r = x - cfg.apply_sqrtC(u, theta)
        return -0.5 * (torch.sum(r * r) / s2 + torch.sum(u * u))

    def log_prior(theta):
        th = torch.atleast_1d(cfg.theta_tensor(theta))
        return -torch.sum(th ** 2) / (2 * prior_std ** 2)

    def grad_theta(x, u, theta):
        """Analytic ∂θ log_like in Fourier space (the ∇θ_logLike override).

        Per rfft mode, with r̂ = x̂ − √C û and p = |x̂|²/n²:
          g_α = ½/σ² Σ w Re[r̂·conj(∂_α√C·û)]/n²
        which AT THE EXACT MAP û = √C x̂/(C+σ²) collapses to the
        cancellation-free, all-positive form
          g_α = ½ Σ w p ∂_αC/(C+σ²)²      (∂C/∂θ₀ = C; ∂C/∂θ₁ = −log(k+k₀)C).
        At high SNR (σ² ≪ C) the real-space product rᵀSu/σ² loses the
        residual's significant bits to float32 FFT rounding; this form has
        a per-mode relative error ~eps. It assumes that the latent solve
        reached the Wiener MAP (exact for ``solver="direct"``, to the
        solver's tolerance for ``"cg"``)."""
        C = cfg.spectrum(theta)
        wq = cfg.herm_weight * C / ((C + s2) ** 2 * (n * n))
        z = pack_rfft2(x)[None]
        g0 = 0.5 * spectrum_quadform(z, pack_weights(wq))[0]
        if not cfg.infer_tilt:
            scalar = (theta.dim() if isinstance(theta, torch.Tensor)
                      else np.ndim(theta)) == 0
            return g0 if scalar else g0.reshape(1)
        g1 = 0.5 * spectrum_quadform(z, pack_weights(neg_logk * wq))[0]
        return torch.stack([g0, g1])

    # batched MAP solvers over the whitened latent; the normal equations
    # are (I + S_θᵀS_θ/σ²) u = S_θᵀ x / σ², with S_θᵀS_θ = C_k

    def _theta_of(th_flat):
        return th_flat if cfg.infer_tilt else th_flat[0]

    def zhat_cg(xs, Z0, th_flat, atol):
        """Batched PCG in PACKED-SPECTRAL coordinates.

        A = I + SᵀS/σ² is exactly diagonal per Fourier mode, so the CG runs
        on the isometric packing ũ = pack(√w/n · rfft2(u)) (Parseval with
        hermitian column weights). CG in exact arithmetic is invariant
        under an isometric change of basis, and the packed residual norm
        equals the pixel-space gradient norm, so the stopping semantics
        are those of a pixel-space CG. The diagonal operator keeps the
        hermitian-consistent subspace because the spectrum is radial."""
        B = xs.shape[0]
        C = cfg.spectrum(_theta_of(th_flat))
        A = (1.0 + C / s2).reshape(-1).repeat(2)[None]   # (1, 2·n·nr)
        bt = _pack_spectrum(torch.sqrt(C) * cfg.rfft2(xs) / s2, sqw_n)
        u0t = _pack_spectrum(cfg.rfft2(Z0.reshape(B, n, n)), sqw_n)
        ut, aux = _packed_diag_pcg(A, bt, u0t, atol, cg_maxiter, grid,
                                   nz=n * n)
        return cfg.irfft2(_unpack_spectrum(ut, sqw_n)).reshape(B, -1), aux

    def zhat_direct(xs, Z0, th_flat, atol):
        C = cfg.spectrum(_theta_of(th_flat))
        Z = cfg.irfft2(torch.sqrt(C) * cfg.rfft2(xs) / (s2 + C))
        B = Z.shape[0]
        return Z.reshape(B, -1), {
            "converged": torch.ones(B, dtype=torch.bool, device=dev),
            "failed": torch.zeros(B, dtype=torch.bool, device=dev)}

    if x_obs is None:
        if theta_true is None:
            theta_true = (torch.zeros(2, device=dev) if cfg.infer_tilt
                          else 0.0)
        x_obs, _ = sample_x_z(lane_generator(data_seed, dev), theta_true)
    else:
        x_obs = torch.tensor(np.asarray(_host(x_obs), np.float32),
                             device=dev)

    prob = SimpleMuseProblem(
        x_obs, sample_x_z, log_like, log_prior,
        custom_zhat={"cg": zhat_cg, "direct": zhat_direct,
                     "lbfgs": None}[solver],
        grad_theta_log_like=grad_theta, device=dev,
        sample_white=sample_white, x_of_white=x_of_white)
    prob.grf_config = cfg

    def h_precond(w, x, th_flat):
        """Ready-made CG preconditioner for implicit-diff get_H (the Pl
        hook, src/muse.jl:312): for the whitened latent the z-Hessian is
        EXACTLY Fourier-diagonal, A = −∇z²logLike = I + C_θ/σ², so this is
        the exact inverse and the per-column CG solves converge in O(1)
        iterations."""
        C = cfg.spectrum(_theta_of(th_flat))
        return cfg.irfft2(cfg.rfft2(w.reshape(n, n))
                          / (1.0 + C / s2)).reshape(-1)

    prob.suggested_h_precond = h_precond
    return prob


def grf_field_problem(config: Optional[GrfConfig] = None, *, n: int = 256,
                      sigma_noise: float = 1.0, gamma: float = 2.0,
                      k0: float = 1.0, theta_true: float = 0.0,
                      data_seed: int = 42, x_obs=None,
                      prior_std: float = 3.0,
                      device="cuda") -> SimpleMuseProblem:
    """Non-whitened GRF: the latent IS the field z ~ N(0, F⁻¹CF).

      log p(x, z|θ) = −½ [ Σ(x−z)²/σ² + Σ_k w_k|ẑ_k|²/C_k / n²
                           + Σ_k w_k log C_k ] + const

    The quadform term runs through :func:`spectrum_quadform` (the CUDA
    kernel on a card). ``x_obs`` (an (n, n) array or tensor) is the data;
    without it the data are drawn at ``theta_true`` from ``data_seed``.
    ``config``, when given, fixes the device.
    """
    from ..ops.grf_spectrum import pack_rfft2, pack_weights, spectrum_quadform

    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, False, device=device)
    n = cfg.n
    s2 = cfg.sigma_noise ** 2
    dev = cfg.device

    def sample_x_z(gen, theta):
        # draw order as in JAX: the white field u first, then the noise
        u = torch.randn((n, n), generator=gen, device=dev)
        z = cfg.apply_sqrtC(u, theta)
        x = z + cfg.sigma_noise * torch.randn((n, n), generator=gen,
                                              device=dev)
        return x, z

    def log_like(x, z, theta):
        C = cfg.spectrum(theta)
        invCw2 = pack_weights(cfg.herm_weight / C)
        quad = spectrum_quadform(pack_rfft2(z)[None], invCw2)[0] / n ** 2
        logdet = torch.sum(cfg.herm_weight * torch.log(C))
        r = x - z
        return -0.5 * (torch.sum(r * r) / s2 + quad + logdet)

    def log_prior(theta):
        th = torch.atleast_1d(cfg.theta_tensor(theta))
        return -torch.sum(th ** 2) / (2 * prior_std ** 2)

    def zhat_wiener(xs, Z0, th_flat, atol):
        """All lanes' MAPs at once: ẑ_k = C x̂_k / (C + σ²)."""
        C = cfg.spectrum(th_flat[0])
        Z = cfg.irfft2(C * cfg.rfft2(xs) / (C + s2))
        B = Z.shape[0]
        return Z.reshape(B, -1), {
            "converged": torch.ones(B, dtype=torch.bool, device=dev),
            "failed": torch.zeros(B, dtype=torch.bool, device=dev)}

    if x_obs is None:
        x_obs, _ = sample_x_z(lane_generator(data_seed, dev), theta_true)
    else:
        x_obs = torch.tensor(np.asarray(_host(x_obs), np.float32),
                             device=dev)

    prob = SimpleMuseProblem(x_obs, sample_x_z, log_like, log_prior,
                             custom_zhat=zhat_wiener, device=dev)
    prob.grf_config = cfg
    return prob


def grf_spectral_problem(config: Optional[GrfConfig] = None, *,
                         n: int = 256, sigma_noise: float = 1.0,
                         gamma: float = 2.0, k0: float = 1.0,
                         infer_tilt: bool = False, theta_true=None,
                         data_seed: int = 42, x_obs=None, solver: str = "cg",
                         cg_maxiter: int = 200, prior_std: float = 3.0,
                         mesh=None, noise: str = "marginal",
                         device="cuda") -> SimpleMuseProblem:
    """The whitened GRF with x AND z in packed-spectral coordinates.

    Counterpart of muse_tpu's ``grf_spectral_problem`` (grf.py:416-662):
    the observation and the white latent are carried in the isometric
    packing ṽ = pack(√w/n · rfft2(v)) of length L = 2·n·(n//2+1), where
    the MAP operator, the θ-score and the implicit-H preconditioner are
    all diagonal.

      * ``noise="marginal"`` (default): x̃ = √(C+σ²)·w₁ and the conditional
        ũ|x̃ = (√C/(C+σ²))·x̃ + √(σ²/(C+σ²))·w₂, with w₁, w₂ hermitian
        white draws (:func:`hermitian_white_packed`). x depends on w₁ alone
        (``x_white_parts = (0,)``), so the iteration neither keeps w₂
        resident nor computes ũ. ``"direct"``: x̃ = √C·ũ + σ·ẽ from the same
        sampler. ``"fft"``: the two whites are packed rfft2s of pixel
        normals.
      * ``solver="cg"``: the batched PCG of ``ops/cg.py`` with A = 1 + C/σ²
        and M⁻¹ = 1/A; its operator and curvature (Ap, pᵀAp) come from the
        fused ``spectrum_quadform_and_grad`` kernel on a card.
        ``"direct"``: the closed form û = √C x̃/(σ²+C). ``"lbfgs"``: no
        ``custom_zhat``, so the MAPs take the generic batched L-BFGS
        (``ops/lbfgs.py``) on the log-likelihood.
      * ``grad_theta``: the analytic score ½Σ x̃²·∂C/(C+σ²)² through the
        ``spectrum_quadform`` kernel, one launch per batched evaluation.

    ``x_obs`` may be a real (n, n) field (packed on the host in float64)
    or an already packed (L,) vector; without it the data are drawn at
    ``theta_true`` from ``data_seed``. ``prob.x_real`` holds the pixel
    field for closed-form oracles (:func:`grf_marginal_mle`).
    ``mesh`` is not ported yet (ROADMAP Queue 1 item 10). ``config``, when
    given, fixes the device.
    """
    from ..ops.grf_spectrum import spectrum_quadform

    if noise not in ("marginal", "direct", "fft"):
        raise ValueError(
            f"noise must be 'marginal'|'direct'|'fft', got {noise!r}")
    if solver not in ("cg", "direct", "lbfgs"):
        raise ValueError(f"solver must be 'cg'|'direct'|'lbfgs', got "
                         f"{solver!r}")
    if mesh is not None:
        raise NotImplementedError(
            "grf_spectral_problem(mesh=...) is not ported yet (ROADMAP "
            "Queue 1 item 10)")
    cfg = config or GrfConfig(n, sigma_noise, gamma, k0, infer_tilt,
                              device=device)
    n = cfg.n
    s2 = cfg.sigma_noise ** 2
    dev = cfg.device
    nr = n // 2 + 1
    grid = (n, 2 * nr)       # the kernels' (n, 2m) view of a packed (L,)
    sqw_n = torch.sqrt(cfg.herm_weight) / n
    sqw_n_host = np.sqrt(np.asarray(_host(cfg.herm_weight), np.float64)) / n
    logk_tiled = torch.log(cfg.k + cfg.k0).reshape(-1).repeat(2)
    coeffs = _herm_white_tensors(n, dev)

    def _C2(theta):
        """Spectrum per packed coordinate: C_k tiled over (re, im)."""
        return cfg.spectrum(theta).reshape(-1).repeat(2)

    def pack_field(v):
        """Real (n, n) field → packed (L,) on the device."""
        zs = torch.fft.rfft2(v, dim=(-2, -1)) * sqw_n
        return torch.cat([zs.real.reshape(-1), zs.imag.reshape(-1)])

    def unpack_field(vt):
        """Packed (L,) → real (n, n) field, numpy float64 on the host."""
        re, im = np.split(np.asarray(_host(vt), np.float64), 2)
        zf = (re + 1j * im).reshape(n, nr) / sqw_n_host
        return np.fft.irfft2(zf, s=(n, n))

    # ---- packed white noise and the sample completion --------------- #
    if noise == "fft":
        def sample_white(gen):
            return tuple(pack_field(torch.randn((n, n), generator=gen,
                                                device=dev))
                         for _ in range(2))
    else:
        def sample_white(gen):
            return (_herm_white_draw(gen, n, coeffs),
                    _herm_white_draw(gen, n, coeffs))

    if noise == "marginal":
        # x̃ ~ N(0, C+σ²) and ũ|x̃ ~ N(√C x̃/(C+σ²), σ²/(C+σ²)): the same
        # joint law as the other modes, with x a function of w₁ alone
        def x_of_white(W, theta):
            w1, w2 = W
            C2 = _C2(theta)
            D = C2 + s2
            xt = torch.sqrt(D) * w1
            if w2 is None:
                return xt, None
            return xt, (torch.sqrt(C2) / D) * xt + torch.sqrt(s2 / D) * w2
    else:
        def x_of_white(W, theta):
            ut, et = W
            return torch.sqrt(_C2(theta)) * ut + cfg.sigma_noise * et, ut

    def sample_x_z(gen, theta):
        # the CRN stream of every noise mode is the white split composed
        return x_of_white(sample_white(gen), theta)

    def log_like(xt, ut, theta):
        r = xt - torch.sqrt(_C2(theta)) * ut
        return -0.5 * (torch.sum(r * r) / s2 + torch.sum(ut * ut))

    def log_prior(theta):
        th = torch.atleast_1d(cfg.theta_tensor(theta))
        return -torch.sum(th ** 2) / (2 * prior_std ** 2)

    def grad_theta(xt, ut, theta):
        """Analytic ∂θ log_like at the exact MAP: ½Σ x̃²·∂C/(C+σ²)², one
        spectrum quadform per θ component."""
        C2 = _C2(theta)
        wq = C2 / (C2 + s2) ** 2
        z = xt.reshape((1,) + grid)
        g0 = 0.5 * spectrum_quadform(z, wq.reshape(grid))[0]
        if not cfg.infer_tilt:
            scalar = (theta.dim() if isinstance(theta, torch.Tensor)
                      else np.ndim(theta)) == 0
            return g0 if scalar else g0.reshape(1)
        g1 = 0.5 * spectrum_quadform(z, (-logk_tiled * wq).reshape(grid))[0]
        return torch.stack([g0, g1])

    def zhat_cg(xs, Z0, th_flat, atol):
        """Batched PCG with the diagonal operator A = 1 + C/σ²."""
        C2 = _C2(th_flat)[None]
        return _packed_diag_pcg(1.0 + C2 / s2, torch.sqrt(C2) * xs / s2, Z0,
                                atol, cg_maxiter, grid)

    def zhat_direct(xs, Z0, th_flat, atol):
        C2 = _C2(th_flat)[None]
        Z = torch.sqrt(C2) * xs / (s2 + C2)
        B = Z.shape[0]
        return Z, {"converged": torch.ones(B, dtype=torch.bool, device=dev),
                   "failed": torch.zeros(B, dtype=torch.bool, device=dev)}

    if x_obs is None:
        if theta_true is None:
            theta_true = (torch.zeros(2, device=dev) if cfg.infer_tilt
                          else 0.0)
        x_obs, _ = sample_x_z(lane_generator(data_seed, dev), theta_true)
    elif np.ndim(_host(x_obs)) == 2:
        x_obs = torch.tensor(pack_field_host(x_obs, cfg.herm_weight, n),
                             device=dev)
    else:
        x_obs = torch.tensor(np.asarray(_host(x_obs), np.float32),
                             device=dev)

    prob = SimpleMuseProblem(
        x_obs, sample_x_z, log_like, log_prior,
        custom_zhat={"cg": zhat_cg, "direct": zhat_direct,
                     "lbfgs": None}[solver],
        grad_theta_log_like=grad_theta, device=dev,
        sample_white=sample_white, x_of_white=x_of_white,
        x_white_parts=(0,) if noise == "marginal" else None)
    prob.grf_config = cfg
    prob.x_real = unpack_field(x_obs)     # for closed-form oracles
    prob.pack_field = pack_field
    prob.unpack_field = unpack_field

    def h_precond(w, x, th_flat):
        """Exact A⁻¹ for implicit-diff get_H: diagonal in packed
        coordinates."""
        return w / (1.0 + _C2(th_flat) / s2)

    prob.suggested_h_precond = h_precond
    return prob


def grf_marginal_mle(x_obs, cfg: GrfConfig, theta0=0.0,
                     iters: int = 200) -> Tuple[float, float]:
    """Exact marginal MLE θ̂ and Fisher width(s) for the GRF problem.

    Marginally x̂_k ~ CN(0, n²(C_k(θ)+σ²)) per rfft mode (hermitian
    weights w_k), so with p_k = |x̂_k|²/n² and d_α = ∂C/∂θ_α:
      ∂ nll/∂θ_α = ½ Σ w_k (d_α/(C+σ²)) (1 − p_k/(C+σ²))
      I_αβ       = ½ Σ w_k d_α d_β / (C+σ²)²     (expected Fisher)
    Solved by damped Fisher-scoring Newton in float64 on the host.

    Amplitude-only configs return ``(θ̂, 1/√I)`` as floats; with
    ``cfg.infer_tilt`` the return is ``(θ̂ (2,), Σ (2,2))`` with Σ = I⁻¹.
    Raises ``RuntimeError`` if Fisher scoring has not converged after
    ``iters`` damped steps (e.g. an MLE at the θ→−∞ boundary).
    """
    xf = np.fft.rfft2(np.asarray(_host(x_obs), np.float64))
    p = (np.abs(xf) ** 2) / (cfg.n ** 2)
    w = np.asarray(_host(cfg.herm_weight), np.float64)
    kk = np.asarray(_host(cfg.k), np.float64)
    s2 = cfg.sigma_noise ** 2
    logk = np.log(kk + cfg.k0)
    nth = 2 if cfg.infer_tilt else 1

    th = np.zeros(nth)
    th[:] = np.atleast_1d(np.asarray(theta0, np.float64))[:nth]
    for _ in range(iters):
        gamma = cfg.gamma + (th[1] if cfg.infer_tilt else 0.0)
        C = np.exp(th[0]) * (kk + cfg.k0) ** (-gamma)
        D = C + s2
        d = np.stack([C, -logk * C][:nth])
        dn = 0.5 * np.einsum("kl,akl->a", w * (1.0 - p / D), d / D)
        I = 0.5 * np.einsum("akl,bkl->ab", d, w * d / D ** 2)
        step = -np.linalg.solve(I, dn)
        nrm = np.linalg.norm(step)
        if nrm > 1.0:
            step *= 1.0 / nrm
        th += step
        if nrm < 1e-12:
            break
    else:
        raise RuntimeError(
            f"grf_marginal_mle: Fisher scoring did not converge in "
            f"{iters} iterations (last |step| = {nrm:.3g}, θ = {th}); "
            "the marginal MLE may be at the θ→−∞ boundary (data "
            "consistent with zero signal amplitude).")
    gamma = cfg.gamma + (th[1] if cfg.infer_tilt else 0.0)
    C = np.exp(th[0]) * (kk + cfg.k0) ** (-gamma)
    D = C + s2
    d = np.stack([C, -logk * C][:nth])
    I = 0.5 * np.einsum("akl,bkl->ab", d, w * d / D ** 2)
    if not cfg.infer_tilt:
        return float(th[0]), float(1.0 / np.sqrt(I[0, 0]))
    return th, np.linalg.inv(I)
