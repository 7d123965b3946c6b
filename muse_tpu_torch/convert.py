"""Carry state from ``muse_tpu`` (JAX) to this package.

Every function takes the JAX side's arrays as numpy (``np.asarray`` of a
JAX array) or a file ``muse_tpu`` wrote, and builds the port's objects,
so both packages compute the same thing from the same state. Nothing
here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.grf import GrfConfig
from .result import MuseResult
from .utils.device import resolve_device

__all__ = ["grf_config_from_arrays", "x_obs", "result_from_muse_tpu"]


def grf_config_from_arrays(n, sigma_noise, gamma, k0, k, herm_weight, *,
                           infer_tilt: bool = False,
                           device="cpu") -> GrfConfig:
    """A port ``GrfConfig`` holding the JAX config's ``k`` and
    ``herm_weight`` arrays as they are."""
    return GrfConfig(int(n), float(sigma_noise), float(gamma), float(k0),
                     infer_tilt, device=device, k=np.asarray(k),
                     herm_weight=np.asarray(herm_weight))


def x_obs(x, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """The JAX side's observed data as a tensor on ``device``."""
    return torch.tensor(np.asarray(x), dtype=dtype,
                        device=resolve_device(device))


def result_from_muse_tpu(filename: str) -> MuseResult:
    """A ``MuseResult`` from a pickle that ``muse_tpu``'s ``MuseResult.save``
    wrote (numpy only). θ, the per-sim scores ``gs`` and Jacobians ``Hs``,
    the history and the covariance carry over; the JAX PRNG key does not
    (a seed of the port is another stream), so ``key`` is left None.
    Unpickle only files you trust."""
    res = MuseResult.load(filename)
    res.key = None
    return res
