"""Carry state from ``muse_tpu`` (JAX) to this package.

Every function takes the JAX side's arrays as numpy (``np.asarray`` of a
JAX array) or a file ``muse_tpu`` wrote, and builds the port's objects,
so both packages compute the same thing from the same state. Nothing
here imports JAX. Tensors land on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.grf import GrfConfig, pack_field_host
from .result import MuseResult
from .utils.device import resolve_device
from .utils.tree import tree_map

__all__ = ["grf_config_from_arrays", "x_obs", "observed", "theta", "latent",
           "packed_x_obs", "whites_from_arrays", "result_from_muse_tpu"]


def grf_config_from_arrays(n, sigma_noise, gamma, k0, k, herm_weight, *,
                           infer_tilt: bool = False,
                           device="cuda") -> GrfConfig:
    """A port ``GrfConfig`` holding the JAX config's ``k`` and
    ``herm_weight`` arrays as they are."""
    return GrfConfig(int(n), float(sigma_noise), float(gamma), float(k0),
                     infer_tilt, device=device, k=np.asarray(k),
                     herm_weight=np.asarray(herm_weight))


def x_obs(x, device="cuda", dtype=torch.float32) -> torch.Tensor:
    """The JAX side's observed data as a tensor on ``device``."""
    return torch.tensor(np.asarray(x), dtype=dtype,
                        device=resolve_device(device))


def observed(obs: dict, device="cuda") -> dict:
    """A PPL ``observed={site: value}`` dict of the JAX side as the port's
    dict of float32 tensors on ``device``."""
    return {k: x_obs(v, device) for k, v in obs.items()}


def theta(th, device="cuda"):
    """A θ of the JAX side (a scalar, an array such as a ``vector_funnel``
    θ, or a dict, tuple or list of them) as float32 tensors on ``device``,
    in the same structure."""
    return tree_map(lambda v: x_obs(v, device), th)


def latent(z, device="cuda"):
    """A latent of the JAX side (an array, or a dict of arrays such as the
    lensing model's ``{"uphi", "uz"}`` or its ``suggested_z0``) as float32
    tensors on ``device``. Dict keys flatten in sorted order in both
    packages, so the flat layouts agree."""
    if isinstance(z, dict):
        return {k: x_obs(v, device) for k, v in z.items()}
    return x_obs(z, device)


def packed_x_obs(x, n: int, device="cuda") -> torch.Tensor:
    """A real (n, n) field packed as ``grf_spectral_problem`` carries its
    data, pack(√w/n · rfft2(x)), on the host in float64 (muse_tpu
    grf.py:633-640), as a float32 tensor on ``device``."""
    x = np.asarray(x)
    if x.shape != (n, n):
        raise ValueError(f"expected an ({n}, {n}) field, got {x.shape}")
    herm_weight = GrfConfig(n, device="cpu").herm_weight
    return torch.tensor(pack_field_host(x, herm_weight, n),
                        device=resolve_device(device))


def whites_from_arrays(*whites, device="cuda") -> tuple:
    """The whites of ``muse_tpu``'s ``comp.sample_whites(keys)``, one array
    per part (two (B, L) arrays for the packed GRF and the bandpower model,
    two (B, n, n) for the pixel GRF, three for the lensing model), as the
    port's ``W_all`` tuple."""
    if not whites:
        raise ValueError("whites_from_arrays needs at least one part")
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(w), dtype=torch.float32, device=dev)
                 for w in whites)


def result_from_muse_tpu(filename: str) -> MuseResult:
    """A ``MuseResult`` from a pickle that ``muse_tpu``'s ``MuseResult.save``
    wrote (numpy only). θ, the per-sim scores ``gs`` and Jacobians ``Hs``,
    the history and the covariance carry over; the JAX PRNG key does not
    (a seed of the port is another stream), so ``key`` is left None.
    Unpickle only files you trust."""
    res = MuseResult.load(filename)
    res.key = None
    return res
