"""The distribution library behind the PPL, the models and ``result.dist``.

Counterpart of ``muse_tpu/distributions.py``: dataclass distributions with
``sample``, ``log_prob``, ``support``, ``bijector`` and ``expand`` (an
i.i.d. batch). Parameters are Python numbers or tensors and broadcast.

  * ``sample(generator, shape=None)`` draws from an explicit
    ``torch.Generator`` on the generator's device, in the default float
    dtype; ``shape`` defaults to the parameters' broadcast shape.
  * ``log_prob`` is elementwise (the PPL sums per site) and has no
    ``.item()``, no in-place op and no branch on values, so ``vmap`` and
    ``grad`` pass through it. A host value (a number or numpy array) is
    evaluated in float64, as ``result.dist`` is used.
  * ``Gamma`` (and ``Beta`` and ``StudentT``, built on it) sample by
    Marsaglia and Tsang's squeeze method with a fixed count of
    ``_GAMMA_ROUNDS`` proposal rounds, all drawn from the generator
    (``torch._standard_gamma`` takes none). A concentration a < 1 draws
    Gamma(a + 1)·U^{1/a}.

``Normal`` (scalar θ) and ``MvNormal`` (vector θ) are also the Gaussians
``finalize_result`` builds (the reference's ``src/muse.jl:542-546``);
``MvNormal.sample``'s ``shape`` is the batch shape, the event dimension is
added.
"""

from __future__ import annotations

import dataclasses
import math
from numbers import Number
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "Distribution", "Normal", "LogNormal", "HalfNormal", "Uniform",
    "Exponential", "Gamma", "Beta", "StudentT", "MvNormal", "MvNormalDiag",
]

_LOG2PI = math.log(2.0 * math.pi)

# proposal rounds of the gamma sampler; each accepts with probability
# ≥ 0.95, so a draw is left without an accepted round with ≤ 0.05⁸ ≈ 4e-11
_GAMMA_ROUNDS = 8


def _value(x):
    """A host value (number, numpy) as a float64 tensor; tensors as they
    are."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, np.float64))


def _shape(v) -> tuple:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def _log(v):
    return math.log(v) if isinstance(v, Number) else torch.log(v)


def _lgamma(v):
    return math.lgamma(v) if isinstance(v, Number) else torch.lgamma(v)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=gen, device=gen.device)


def _param(v, gen: torch.Generator, shape) -> torch.Tensor:
    """A parameter broadcast to ``shape`` on the generator's device."""
    return torch.broadcast_to(torch.as_tensor(v, device=gen.device,
                                              dtype=torch.get_default_dtype()),
                              tuple(shape))


def _standard_gamma(gen: torch.Generator, a: torch.Tensor) -> torch.Tensor:
    """Gamma(a, 1) draws of a's shape: Marsaglia–Tsang, fixed rounds."""
    boost = a < 1
    ab = torch.where(boost, a + 1, a)
    d = ab - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = d.clone()
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for _ in range(_GAMMA_ROUNDS):
        x = _normal(gen, a.shape)
        u = _uniform(gen, a.shape)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
    u = _uniform(gen, a.shape)
    return torch.where(boost, out * u ** (1.0 / a), out)


class Distribution:
    """Base: broadcastable elementwise distribution."""

    support = "real"
    shape: Tuple[int, ...] = ()

    def sample(self, generator: torch.Generator, shape=None):
        raise NotImplementedError

    def log_prob(self, x):
        """Elementwise log density (not summed; the PPL sums per site)."""
        raise NotImplementedError

    def expand(self, shape):
        """Broadcast the parameters to ``shape`` (an i.i.d. batch)."""
        return _Expanded(self, tuple(shape))

    def bijector(self):
        """Support bijector (constrained → unconstrained) for this
        distribution's support, bounds included: the PPL links latents and
        hypers through it (src/turing.jl:142-153)."""
        from .transforms import from_support
        return from_support(self.support)

    def _sample_shape(self, shape):
        return self.shape if shape is None else tuple(shape)


@dataclasses.dataclass(frozen=True)
class _Expanded(Distribution):
    base: Distribution
    _shape: Tuple[int, ...]

    @property
    def support(self):  # type: ignore[override]
        return self.base.support

    @property
    def shape(self):  # type: ignore[override]
        return self._shape

    def sample(self, generator, shape=None):
        return self.base.sample(generator,
                                self._shape if shape is None else shape)

    def log_prob(self, x):
        # broadcast to the expanded batch shape, so a scalar value under an
        # expansion or plate counts once per batch element
        lp = self.base.log_prob(x)
        return torch.broadcast_to(
            lp, torch.broadcast_shapes(tuple(lp.shape), self._shape))

    def bijector(self):
        return self.base.bijector()


@dataclasses.dataclass(frozen=True)
class Normal(Distribution):
    loc: float = 0.0
    scale: float = 1.0
    support = "real"

    @property
    def shape(self):
        return torch.broadcast_shapes(_shape(self.loc), _shape(self.scale))

    @property
    def mean(self):
        return self.loc

    @property
    def stddev(self):
        return self.scale

    def sample(self, generator, shape=None):
        return self.loc + self.scale * _normal(generator,
                                               self._sample_shape(shape))

    def log_prob(self, x):
        z = (_value(x) - self.loc) / self.scale
        return -0.5 * (z * z + _LOG2PI) - _log(self.scale)


@dataclasses.dataclass(frozen=True)
class LogNormal(Distribution):
    loc: float = 0.0
    scale: float = 1.0
    support = "positive"

    @property
    def shape(self):
        return torch.broadcast_shapes(_shape(self.loc), _shape(self.scale))

    def sample(self, generator, shape=None):
        return torch.exp(self.loc + self.scale * _normal(
            generator, self._sample_shape(shape)))

    def log_prob(self, x):
        lx = torch.log(_value(x))
        z = (lx - self.loc) / self.scale
        return -0.5 * (z * z + _LOG2PI) - _log(self.scale) - lx


@dataclasses.dataclass(frozen=True)
class Uniform(Distribution):
    lo: float = 0.0
    hi: float = 1.0

    @property
    def support(self):  # type: ignore[override]
        if _shape(self.lo) == () and _shape(self.hi) == () \
                and float(self.lo) == 0.0 and float(self.hi) == 1.0:
            return "unit_interval"
        return "interval"

    def bijector(self):
        from .transforms import Logit
        return Logit(self.lo, self.hi)

    @property
    def shape(self):
        return torch.broadcast_shapes(_shape(self.lo), _shape(self.hi))

    def sample(self, generator, shape=None):
        u = _uniform(generator, self._sample_shape(shape))
        return self.lo + (self.hi - self.lo) * u

    def log_prob(self, x):
        x = _value(x)
        inside = (x >= self.lo) & (x <= self.hi)
        lp = -_log(self.hi - self.lo) + torch.zeros_like(x)
        return torch.where(inside, lp, -math.inf)


@dataclasses.dataclass(frozen=True)
class Exponential(Distribution):
    rate: float = 1.0
    support = "positive"

    @property
    def shape(self):
        return _shape(self.rate)

    def sample(self, generator, shape=None):
        u = _uniform(generator, self._sample_shape(shape))
        return -torch.log1p(-u) / self.rate

    def log_prob(self, x):
        return _log(self.rate) - self.rate * _value(x)


@dataclasses.dataclass(frozen=True)
class HalfNormal(Distribution):
    scale: float = 1.0
    support = "positive"

    @property
    def shape(self):
        return _shape(self.scale)

    def sample(self, generator, shape=None):
        return torch.abs(self.scale * _normal(generator,
                                              self._sample_shape(shape)))

    def log_prob(self, x):
        z = _value(x) / self.scale
        return -0.5 * (z * z + _LOG2PI) + math.log(2.0) - _log(self.scale)


@dataclasses.dataclass(frozen=True)
class Gamma(Distribution):
    concentration: float = 1.0
    rate: float = 1.0
    support = "positive"

    @property
    def shape(self):
        return torch.broadcast_shapes(_shape(self.concentration),
                                      _shape(self.rate))

    def sample(self, generator, shape=None):
        a = _param(self.concentration, generator, self._sample_shape(shape))
        return _standard_gamma(generator, a) / self.rate

    def log_prob(self, x):
        x = _value(x)
        a, b = self.concentration, self.rate
        return (a * _log(b) + (a - 1) * torch.log(x) - b * x - _lgamma(a))


@dataclasses.dataclass(frozen=True)
class Beta(Distribution):
    a: float = 1.0
    b: float = 1.0
    support = "unit_interval"

    @property
    def shape(self):
        return torch.broadcast_shapes(_shape(self.a), _shape(self.b))

    def sample(self, generator, shape=None):
        shape = self._sample_shape(shape)
        x = _standard_gamma(generator, _param(self.a, generator, shape))
        y = _standard_gamma(generator, _param(self.b, generator, shape))
        return x / (x + y)

    def log_prob(self, x):
        x = _value(x)
        a, b = self.a, self.b
        return ((a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x)
                - (_lgamma(a) + _lgamma(b) - _lgamma(a + b)))


@dataclasses.dataclass(frozen=True)
class StudentT(Distribution):
    df: float = 1.0
    loc: float = 0.0
    scale: float = 1.0
    support = "real"

    @property
    def shape(self):
        return torch.broadcast_shapes(_shape(self.df), _shape(self.loc),
                                      _shape(self.scale))

    def sample(self, generator, shape=None):
        shape = self._sample_shape(shape)
        df = _param(self.df, generator, shape)
        z = _normal(generator, shape)
        chi2 = 2.0 * _standard_gamma(generator, 0.5 * df)
        return self.loc + self.scale * z / torch.sqrt(chi2 / df)

    def log_prob(self, x):
        v = self.df
        z = (_value(x) - self.loc) / self.scale
        return (_lgamma((v + 1) / 2) - _lgamma(v / 2)
                - 0.5 * _log(v * math.pi) - _log(self.scale)
                - ((v + 1) / 2) * torch.log1p(z * z / v))


@dataclasses.dataclass(frozen=True)
class MvNormalDiag(Distribution):
    """Diagonal-covariance multivariate normal (event dim = last axis)."""

    loc: torch.Tensor
    scale_diag: torch.Tensor
    support = "real"

    @property
    def shape(self):
        return torch.broadcast_shapes(_shape(self.loc),
                                      _shape(self.scale_diag))

    def sample(self, generator, shape=None):
        return self.loc + self.scale_diag * _normal(
            generator, self._sample_shape(shape))

    def log_prob(self, x):
        z = (_value(x) - self.loc) / self.scale_diag
        lp = -0.5 * (z * z + _LOG2PI) - torch.log(_value(self.scale_diag))
        return torch.sum(lp, dim=-1)


@dataclasses.dataclass(frozen=True)
class MvNormal(Distribution):
    """Full-covariance multivariate normal (event dim = last axis), with
    host (numpy) parameters, evaluated in float64."""

    loc: np.ndarray
    cov: np.ndarray
    support = "real"

    @property
    def shape(self):
        return np.shape(self.loc)

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
