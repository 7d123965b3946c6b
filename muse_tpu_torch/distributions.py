"""The Gaussians behind ``MuseResult.dist``.

Counterpart of the two classes of ``muse_tpu/distributions.py`` that
``finalize_result`` builds (``Normal`` for a scalar θ, ``MvNormal``
otherwise; the reference's ``src/muse.jl:542-546``). Parameters are host
numpy values; ``log_prob`` and ``sample`` take numpy or tensors and draw
from an explicit ``torch.Generator``. The rest of the JAX package's
distribution library waits for the PPL port (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Normal", "MvNormal"]

_LOG2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class Normal:
    loc: float = 0.0
    scale: float = 1.0

    @property
    def mean(self):
        return self.loc

    @property
    def stddev(self):
        return self.scale

    def log_prob(self, x):
        x = torch.as_tensor(x, dtype=torch.float64)
        z = (x - self.loc) / self.scale
        return -0.5 * (z * z + _LOG2PI) - math.log(self.scale)

    def sample(self, generator: torch.Generator, shape=()):
        eps = torch.randn(tuple(shape), generator=generator,
                          dtype=torch.float64, device=generator.device)
        return self.loc + self.scale * eps


@dataclasses.dataclass(frozen=True)
class MvNormal:
    """Full-covariance multivariate normal (event dim = last axis)."""

    loc: np.ndarray
    cov: np.ndarray

    @property
    def mean(self):
        return self.loc

    @property
    def stddev(self):
        return np.sqrt(np.diagonal(self.cov))

    def _chol(self):
        return torch.linalg.cholesky(torch.as_tensor(self.cov,
                                                     dtype=torch.float64))

    def log_prob(self, x):
        L = self._chol()
        d = (torch.as_tensor(x, dtype=torch.float64)
             - torch.as_tensor(self.loc, dtype=torch.float64))
        y = torch.linalg.solve_triangular(L, d[..., None], upper=False)[..., 0]
        n = L.shape[-1]
        return (-0.5 * (y * y).sum(-1) - torch.log(torch.diagonal(L)).sum()
                - 0.5 * n * _LOG2PI)

    def sample(self, generator: torch.Generator, shape=()):
        L = self._chol().to(generator.device)
        eps = torch.randn(tuple(shape) + (L.shape[-1],), generator=generator,
                          dtype=torch.float64, device=generator.device)
        return torch.as_tensor(self.loc, dtype=torch.float64,
                               device=generator.device) + eps @ L.T
