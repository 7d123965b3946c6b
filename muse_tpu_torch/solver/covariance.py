"""Covariance assembly — ``finalize_result!`` (reference src/muse.jl:535-549).

Counterpart of ``muse_tpu/solver/covariance.py``. Σ⁻¹ = Hᵀ J⁻¹ H + H_prior,
with H_prior = −∇²logPriorθ at θ̂ in the untransformed space; Σ = inv(Σ⁻¹);
plus the convenience Gaussian ``dist`` (Normal for scalar θ, MvNormal
otherwise). All of it is tiny dense θ-space linear algebra, done on the
host in float64; ``finalize_result.host_syncs`` counts its one blocking
device→host read, the prior's Hessian.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..distributions import MvNormal, Normal
from ..result import MuseResult
from .muse import _host

__all__ = ["finalize_result"]


def finalize_result(result: MuseResult, comp) -> MuseResult:
    if result.H is None or result.J is None or result.theta is None:
        return result

    H = np.atleast_2d(np.asarray(result.H, np.float64))
    J = np.atleast_2d(np.asarray(result.J, np.float64))
    th = np.atleast_1d(np.asarray(result.theta, np.float64))

    H_prior = -np.atleast_2d(_host(comp.prior_hess_u(
        torch.as_tensor(th, dtype=comp.dtype, device=comp.device)),
        finalize_result))

    # For a well-specified model at θ̂, J ≈ H ≈ Fisher. A large mismatch
    # usually means per-sim MAP error is leaking into the score variance
    # (tighten grad_z_atol) or the model is badly misspecified.
    ratio = np.diag(J) / np.maximum(np.abs(np.diag(H)), 1e-30)
    if (ratio > 25.0).any() or (ratio < 0.04).any():
        warnings.warn(
            f"J/H diagonal ratio is {ratio} — expected O(1) at θ̂. "
            "Suspect MAP solutions too loose (tighten grad_z_atol), "
            "model misspecification, or a weak-information regime "
            "(J ≫ H is then genuine and σθ is conservative); σθ may be "
            "unreliable.")

    result.Sigma_inv = H.T @ np.linalg.inv(J) @ H + H_prior
    result.Sigma = np.linalg.inv(result.Sigma_inv)

    if th.size == 1:
        result.dist = Normal(float(th[0]), float(np.sqrt(result.Sigma[0, 0])))
    else:
        result.dist = MvNormal(th, 0.5 * (result.Sigma + result.Sigma.T))
    return result


finalize_result.host_syncs = 0
