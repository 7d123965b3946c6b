"""θ-space bijectors (transformed ↔ untransformed hyper-parameter space).

Counterpart of ``muse_tpu/transforms.py``. The reference's Turing adapter
derives transforms from variable supports and includes the
change-of-variables volume factor in transformed-space densities
(``src/turing.jl:171-186``); the Soss adapter leaves it out. Problems pick
the convention with ``volume_factor``; the bijectors expose
``log_det_jacobian`` so either is computable.

Convention: ``forward`` maps the constrained (untransformed, model) space
to the unconstrained (transformed) space where the outer quasi-Newton
iteration runs; ``log_det_jacobian(θ)`` is log|det ∂forward/∂θ| at a
constrained point, summed. All maps are elementwise on flat tensors and
compose with ``torch.func``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

__all__ = [
    "Bijector", "Identity", "Log", "Softplus", "Logit", "Affine",
    "Blockwise", "from_support",
]


@dataclasses.dataclass(frozen=True)
class Bijector:
    """An elementwise bijector given by forward/inverse/logdet closures."""

    forward: Callable[[torch.Tensor], torch.Tensor]
    inverse: Callable[[torch.Tensor], torch.Tensor]
    # log|det d forward / dθ| at a constrained θ, summed over dims
    log_det_jacobian: Callable[[torch.Tensor], torch.Tensor]
    name: str = "bijector"

    def __repr__(self):
        return f"Bijector({self.name})"


def Identity() -> Bijector:
    return Bijector(lambda x: x, lambda y: y,
                    lambda x: torch.zeros_like(x).sum(), "identity")


def Log() -> Bijector:
    """θ ∈ (0,∞) → y = log θ.  d y/dθ = 1/θ."""
    return Bijector(torch.log, torch.exp,
                    lambda x: -torch.sum(torch.log(x)), "log")


def Softplus() -> Bijector:
    """θ ∈ (0,∞) → y = softplus⁻¹(θ) = log(exp(θ)−1)."""
    def fwd(x):
        return torch.log(-torch.expm1(-x)) + x

    def ldj(x):
        # dy/dx = 1/(1 − exp(−x))
        return -torch.sum(torch.log(-torch.expm1(-x)))

    return Bijector(fwd, torch.nn.functional.softplus, ldj, "softplus_inv")


def Logit(lo: float = 0.0, hi: float = 1.0) -> Bijector:
    """θ ∈ (lo,hi) → y = logit((θ−lo)/(hi−lo))."""
    width = hi - lo
    log_width = math.log(width) if isinstance(width, (int, float)) \
        else torch.log(torch.as_tensor(width))

    def fwd(x):
        u = (x - lo) / width
        return torch.log(u) - torch.log1p(-u)

    def inv(y):
        return lo + width * torch.sigmoid(y)

    def ldj(x):
        u = (x - lo) / width
        return torch.sum(-torch.log(u) - torch.log1p(-u) - log_width)

    return Bijector(fwd, inv, ldj, f"logit({lo},{hi})")


def Affine(scale: float, shift: float = 0.0) -> Bijector:
    def ldj(x):
        return torch.sum(math.log(abs(scale)) * torch.ones_like(x))
    return Bijector(lambda x: x * scale + shift,
                    lambda y: (y - shift) / scale, ldj, "affine")


@dataclasses.dataclass(frozen=True)
class Blockwise:
    """Per-block bijectors over contiguous slices of a flat θ: ``sizes[i]``
    coordinates get ``bijectors[i]`` (the Turing adapter linking each
    variable through its own support transform, src/turing.jl:142-153)."""

    bijectors: Sequence[Bijector]
    sizes: Sequence[int]
    name: str = "blockwise"

    def _split(self, x):
        return x.split(list(self.sizes))

    def forward(self, x):
        return torch.cat([torch.atleast_1d(b.forward(p))
                          for b, p in zip(self.bijectors, self._split(x))])

    def inverse(self, y):
        return torch.cat([torch.atleast_1d(b.inverse(p))
                          for b, p in zip(self.bijectors, self._split(y))])

    def log_det_jacobian(self, x):
        return sum(b.log_det_jacobian(p)
                   for b, p in zip(self.bijectors, self._split(x)))


_SUPPORT_REGISTRY = {
    "real": Identity,
    "positive": Log,
    "unit_interval": Logit,
}


def from_support(support: str, **kwargs) -> Bijector:
    """The standard bijector for a distribution's support tag."""
    if support not in _SUPPORT_REGISTRY:
        raise KeyError(f"no bijector registered for support {support!r}")
    return _SUPPORT_REGISTRY[support](**kwargs)
