"""Gaussian-random-field models: the field GRF of slice 1.

Counterpart of ``muse_tpu/models/grf.py``'s ``GrfConfig`` (the ``"fft"``
transform mode; grf.py:110-173), ``grf_field_problem`` (grf.py:665-738) and
``grf_marginal_mle`` (grf.py:741-805). The whitened ``grf_problem`` and the
packed ``grf_spectral_problem`` are not ported yet (ROADMAP Queue 1
items 1 and 11).

``grf_field_problem`` infers the log-amplitude θ of the power spectrum
C_k(θ) = e^θ (k+k0)^(−γ) of a 2D field z from x = z + σ·noise. Its latent
IS the field, and its log-likelihood's Fourier-space term
Σ_k w_k|ẑ_k|²/C_k runs in the hand-written CUDA kernel of
``ops/grf_spectrum.py`` on a card. The MAP is the Wiener filter
ẑ_k = C x̂_k/(C+σ²), batched over lanes.

Transforms are ``torch.fft`` with the default "backward" norm, as
``jnp.fft`` uses. Every tensor lives on the configuration's device, in
float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..adapters.simple import SimpleMuseProblem
from ..utils.device import resolve_device
from ..utils.keys import lane_generator

__all__ = ["GrfConfig", "grf_field_problem", "grf_marginal_mle"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class GrfConfig:
    """Static configuration for a GRF amplitude(/tilt) problem.

    ``k`` and ``herm_weight`` (each (n, n//2+1)) are computed from ``n``
    unless given, which lets ``convert.grf_config_from_arrays`` carry the
    JAX package's arrays across unchanged."""

    def __init__(self, n: int = 256, sigma_noise: float = 1.0,
                 gamma: float = 2.0, k0: float = 1.0,
                 infer_tilt: bool = False, *, device="cpu",
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


def grf_field_problem(config: Optional[GrfConfig] = None, *, n: int = 256,
                      sigma_noise: float = 1.0, gamma: float = 2.0,
                      k0: float = 1.0, theta_true: float = 0.0,
                      data_seed: int = 42, x_obs=None,
                      prior_std: float = 3.0,
                      device="cpu") -> SimpleMuseProblem:
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
