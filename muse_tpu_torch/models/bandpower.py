"""Bandpower GRF model: a vector θ of many components (the CMB-bandpower
configuration).

Counterpart of ``muse_tpu/models/bandpower.py``. The problem family MUSE
was built for (arXiv:2112.09354 §5: CMB lensing BANDPOWERS, tens of θ
components, one per annulus of |k|): infer the per-band log-amplitudes
θ ∈ R^nbands of a 2D Gaussian random field's power spectrum from a noisy
map,

  C_k(θ) = exp(θ_{b(k)}) · (|k| + k0)^{-γ},    b(k) = the |k|-annulus,
  u ~ N(0, I),  z = S_θ u,  x = z + σ n.

The reference handles a vector θ generically (``src/muse.jl:277-333``) and
ships no field model; this family is the configuration that runs the
nθ ≫ 1 regime.

It is carried end to end in the isometric PACKED-SPECTRAL coordinates of
:func:`~muse_tpu_torch.models.grf.grf_spectral_problem`, and built by the
same builder (``models/grf.py``'s ``_packed_spectral_problem``), which
holds the white draws and split, the log-likelihood, the MAP solvers, the
data's forms and the field share: C(θ) per packed coordinate, the per-band
score and the prior are all that is this module's own. Every density,
score, MAP solve and the exact implicit-diff H preconditioner is diagonal
elementwise work, and the hermitian white noise is drawn by indexing
(``hermitian_white_packed``). A MUSE iteration runs no FFT at any nbands.
The MAP is the batched PCG of ``ops/cg.py``, whose operator and curvature
come from the fused ``spectrum_quadform_and_grad`` kernel on a card, one
launch per CG step.

The per-band score g_b = ½ Σ_{c ∈ band b} x̃_c² C/(C+σ²)² is a segment sum
over static band indices. ``index_add_`` on a card accumulates with
atomics, in an order that changes from run to run, and the score carries
its information in its low bits; here the packed coordinates are sorted by
band once (a fixed permutation), and each band is one contiguous slice
summed by ``torch.sum``, whose order is fixed: a rerun is bitwise equal.

Closed-form oracle: the bands are disjoint, so the marginal MLE decouples
per band and the Fisher matrix is exactly DIAGONAL; :func:`bandpower_mle`
returns both.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..adapters.simple import SimpleMuseProblem
from .grf import GrfConfig, _packed_spectral_problem

__all__ = ["band_edges", "bandpower_problem", "bandpower_mle"]


def _k_grid64(n: int) -> np.ndarray:
    """The rfft grid's |k| in float64: THE band-assignment coordinate.

    Band membership must be decided everywhere on the same float64 values
    that ``band_edges`` quantized: a float32 round trip (through
    ``GrfConfig.k``) can push a mode that sits exactly on an edge into the
    band below, emptying a band that ``band_edges`` guaranteed non-empty
    (and making the decoupled Fisher matrix singular)."""
    ky = np.fft.fftfreq(n) * n
    kx = np.fft.rfftfreq(n) * n
    return np.hypot(ky[:, None], kx[None, :])


def _herm_weight64(n: int) -> np.ndarray:
    w = np.full((n, n // 2 + 1), 2.0)
    w[:, 0] = 1.0
    if n % 2 == 0:
        w[:, -1] = 1.0
    return w


def band_edges(n: int, nbands: int) -> np.ndarray:
    """|k|-annulus edges with ~equal hermitian-weighted mode counts.

    Quantile edges over the rfft grid's |k| distribution (each conjugate
    pair counted once through the hermitian weights), deduplicated so that
    every band is non-empty. Raises if the grid cannot support ``nbands``
    distinct annuli."""
    k = _k_grid64(n).ravel()
    order = np.argsort(k)
    cw = np.cumsum(_herm_weight64(n).ravel()[order])
    targets = cw[-1] * np.arange(1, nbands) / nbands
    idx = np.searchsorted(cw, targets)
    edges = np.unique(k[order][idx])
    if len(edges) != nbands - 1:
        raise ValueError(
            f"grid n={n} has too few distinct |k| annuli for "
            f"nbands={nbands}; use a larger n or fewer bands")
    return edges


def bandpower_problem(n: int = 64, nbands: int = 8, *,
                      sigma_noise: float = 1.0, gamma: float = 2.0,
                      k0: float = 1.0, theta_true=None, data_seed: int = 42,
                      x_obs=None, solver: str = "cg",
                      cg_maxiter: int = 200, prior_std: float = 3.0,
                      mesh=None, device="cuda") -> SimpleMuseProblem:
    """Build the bandpower MUSE problem (see the module docstring).

    θ is the length-``nbands`` vector of per-annulus log-amplitudes.
    ``x_obs`` may be a pixel-space (n, n) map (packed on the host in
    float64) or an already packed vector; without it the data are drawn at
    ``theta_true`` from ``data_seed``. ``prob.x_real`` holds the pixel map
    for the closed-form oracle. ``solver="cg"`` (default) is the batched
    diagonal-operator PCG through the fused kernel, ``"direct"`` the
    per-mode Wiener closed form, ``"lbfgs"`` the generic batched L-BFGS.

    ``mesh``: as for ``grf_spectral_problem``, a field axis gives this rank
    the rows ``mesh.field_rows(n)`` of the packed grid. ``band_sum`` then
    sums, per band, the sorted slice of the rank's own coordinates, and
    the solver's field reduction turns the partial (nbands,) vectors into
    the global one, in a fixed order (a rerun is bitwise equal).
    """
    cfg = GrfConfig(n, sigma_noise, gamma, k0, False, device=device)
    dev = cfg.device
    s2 = sigma_noise ** 2
    k64 = _k_grid64(n)
    edges = band_edges(n, nbands)
    band_grid = np.searchsorted(edges, k64, side="right")
    # the band and the base spectrum (the shape at θ = 0) per packed
    # coordinate
    band_all = np.tile(band_grid.reshape(-1), 2)
    P0_all = np.tile(((k64 + k0) ** (-gamma)).astype(np.float32)
                     .reshape(-1), 2)

    def model_on(cols, grid):
        band_host = band_all[cols]
        band_idx = torch.tensor(band_host, dtype=torch.int64, device=dev)
        # this rank's packed coordinates sorted by band, once: band b is the
        # slice [starts[b], starts[b+1]) of the permuted vector
        order = torch.tensor(np.argsort(band_host, kind="stable"), device=dev)
        starts = np.concatenate([[0], np.cumsum(
            np.bincount(band_host, minlength=nbands))])
        P0 = torch.tensor(P0_all[cols], device=dev)

        def C2(theta):
            """C per packed coordinate: P0 · exp(θ_band)."""
            return P0 * torch.exp(cfg.theta_tensor(theta)[band_idx])

        def band_sum(q):
            """Σ over each band's coordinates of a packed (L,) vector (this
            rank's slice of one under a field axis) → the (nbands,) sums, in
            a fixed order (a rerun is bitwise equal)."""
            qs = q[order]
            return torch.stack([qs[starts[b]:starts[b + 1]].sum()
                                for b in range(nbands)])

        def grad_theta(xt, ut, theta):
            """Analytic ∂θ log_like at the exact MAP: the all-positive
            packed Fourier score (the real-space form loses the residual's
            bits to float32 cancellation at high SNR), reduced per band:
            ∂C/∂θ_b = C·1_{band b}, so
            g_b = ½ Σ_{c ∈ band b} x̃_c² C/(C+σ²)²."""
            C = C2(theta)
            return band_sum(0.5 * xt * xt * C / (C + s2) ** 2)

        return C2, grad_theta, {"band_sum": band_sum}

    def log_prior(theta):
        th = cfg.theta_tensor(theta)
        return -torch.sum(th ** 2) / (2 * prior_std ** 2)

    prob = _packed_spectral_problem(
        "bandpower_problem", cfg, model_on, log_prior,
        np.zeros(nbands) if theta_true is None else theta_true,
        noise="direct", solver=solver, x_obs=x_obs, data_seed=data_seed,
        cg_maxiter=cg_maxiter, mesh=mesh, weight64=_herm_weight64(n))
    prob.nbands = nbands
    prob.band_edges = edges
    return prob


def bandpower_mle(x_obs, n: int, nbands: int, *, sigma_noise: float = 1.0,
                  gamma: float = 2.0, k0: float = 1.0,
                  iters: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    """Exact marginal MLE θ̂ and Fisher covariance for the bandpower model.

    Marginally x̂_k ~ CN(0, n²(C_k(θ)+σ²)); the bands are disjoint, so the
    MLE decouples per band and the expected Fisher matrix is DIAGONAL:
      I_bb = ½ Σ_{k ∈ b} w_k C_k²/(C_k+σ²)².
    Solved by damped Fisher scoring in float64 on the host. ``x_obs`` is
    the pixel-space (n, n) map. Returns ``(θ̂ (nbands,), Σ (nbands,
    nbands) = I⁻¹)``; raises RuntimeError when it has not converged (a
    band consistent with zero amplitude runs to the θ → −∞ boundary).
    """
    if isinstance(x_obs, torch.Tensor):
        x_obs = x_obs.detach().cpu().numpy()
    xf = np.fft.rfft2(np.asarray(x_obs, np.float64))
    p = (np.abs(xf) ** 2) / (n ** 2)
    w = _herm_weight64(n)
    kk = _k_grid64(n)
    s2 = sigma_noise ** 2
    P0 = (kk + k0) ** (-gamma)
    edges = band_edges(n, nbands)
    band = np.searchsorted(edges, kk, side="right").reshape(-1)

    def per_band(v):
        return np.bincount(band, weights=v.reshape(-1), minlength=nbands)

    th = np.zeros(nbands)
    for _ in range(iters):
        C = P0 * np.exp(th[band]).reshape(kk.shape)
        D = C + s2
        # the bands are disjoint: the score and the (diagonal) Fisher
        # matrix are per-band sums
        dn = 0.5 * per_band(w * (1.0 - p / D) * C / D)
        fisher = 0.5 * per_band(w * C ** 2 / D ** 2)
        step = -dn / fisher
        nrm = np.linalg.norm(step)
        if nrm > 1.0:
            step *= 1.0 / nrm
        th += step
        if nrm < 1e-12:
            break
    else:
        raise RuntimeError(
            f"bandpower_mle: Fisher scoring did not converge in {iters} "
            f"iterations (last |step| = {nrm:.3g}, θ = {th}); some band "
            "may be consistent with zero amplitude (θ→−∞ boundary).")
    C = P0 * np.exp(th[band]).reshape(kk.shape)
    fisher = 0.5 * per_band(w * C ** 2 / (C + s2) ** 2)
    return th, np.diag(1.0 / fisher)
