"""Hyper-parameter (θ) handling: named flat vectors.

Counterpart of ``muse_tpu/theta.py``. The reference uses ComponentArrays.jl
to give θ both flat-vector semantics (for the outer Newton iteration) and
named-field access (``src/util.jl:32-53``). A :class:`ThetaSpec` built from
an example θ — a scalar, a 1-D array or tensor, or a mapping of names to
scalars and arrays — ravels θ into a flat vector for the solver and
unravels solver output back into the user's structure. Mapping keys are
taken in sorted order, as JAX's pytree flattening takes them, so both
packages lay θ out alike.

Every method works on numpy (host, float64) and on tensors (device; the
unflattening is differentiable, for ``torch.func.grad`` over θ).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["ThetaSpec"]


def _shape(v) -> tuple:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


@dataclasses.dataclass(frozen=True)
class ThetaSpec:
    """Maps user-facing θ structures to flat vectors and back.

    Attributes:
      fields: ``((name, shape), …)`` for a mapping θ, else ``((None, shape),)``.
      n: flat dimension of θ.
      scalar: True if the user passed a bare scalar.
      names: flat coordinate names, e.g. ``("theta",)`` or ``("mu[0]", …)``.
      dtype: the device dtype of flattened tensors.
    """

    fields: tuple
    n: int
    scalar: bool
    names: tuple
    dtype: Any = torch.float32

    @classmethod
    def from_example(cls, theta: Any, dtype=torch.float32) -> "ThetaSpec":
        if isinstance(theta, Mapping):
            fields = tuple((k, _shape(theta[k])) for k in sorted(theta))
        else:
            fields = ((None, _shape(theta)),)
        names = []
        for name, shape in fields:
            if len(shape) > 1:
                raise ValueError(f"θ leaves must be scalars or 1-D, got shape "
                                 f"{shape} for {name or 'theta'}")
            base = name or "theta"
            if shape == ():
                names.append(base)
            else:
                names.extend(f"{base}[{i}]" for i in range(shape[0]))
        scalar = not isinstance(theta, Mapping) and fields[0][1] == ()
        return cls(fields=fields, n=len(names), scalar=scalar,
                   names=tuple(names), dtype=dtype)

    def _leaves(self, theta):
        # a θ that is not a mapping is already flat (e.g. result.theta), as
        # JAX's ravel_pytree takes it
        if self.fields[0][0] is None or not isinstance(theta, Mapping):
            return [theta]
        return [theta[name] for name, _ in self.fields]

    def flatten(self, theta: Any):
        """User θ → flat (n,) vector: a tensor if θ holds a tensor (keeping
        its device and graph), else a float64 numpy array."""
        leaves = self._leaves(theta)
        if any(isinstance(v, torch.Tensor) for v in leaves):
            dev = next(v.device for v in leaves if isinstance(v, torch.Tensor))
            flat = torch.cat([torch.as_tensor(v, dtype=self.dtype,
                                              device=dev).reshape(-1)
                              for v in leaves])
        else:
            flat = np.concatenate([np.asarray(v, np.float64).reshape(-1)
                                   for v in leaves])
        if flat.shape[0] != self.n:
            raise ValueError(
                f"θ has flat dimension {flat.shape[0]}, expected {self.n}")
        return flat

    def unflatten(self, flat):
        """Flat vector → user structure (0-d for a scalar θ); tensors stay
        tensors and numpy stays numpy."""
        out, i = {}, 0
        for name, shape in self.fields:
            size = int(np.prod(shape)) if shape else 1
            out[name] = flat[i:i + size].reshape(shape)
            i += size
        return out[None] if self.fields[0][0] is None else out

    def to_user(self, flat) -> Any:
        """Like :meth:`unflatten`, on the host: floats and numpy arrays."""
        if isinstance(flat, torch.Tensor):
            flat = flat.detach().cpu().numpy()
        out = self.unflatten(np.asarray(flat, np.float64))

        def conv(v):
            return float(v) if np.ndim(v) == 0 else np.asarray(v)
        if isinstance(out, dict):
            return {k: conv(v) for k, v in out.items()}
        return conv(out)
