"""Hyper-parameter (θ) handling: named flat vectors.

Counterpart of ``muse_tpu/theta.py``. The reference uses ComponentArrays.jl
to give θ both flat-vector semantics (for the outer Newton iteration) and
named-field access (``src/util.jl:32-53``). A :class:`ThetaSpec` built from
an example θ ravels θ into a flat vector for the solver and unravels solver
output back into the user's structure. θ is what ``muse_tpu.ThetaSpec``
takes: a scalar, an array or tensor of any shape, a mapping of names to
scalars and arrays, or a tuple or list of such trees. Leaves are taken in
JAX's pytree order (mapping keys sorted, sequences in order, each leaf
row-major) and named as JAX names them (``theta[3]``, ``a[0]``, ``[1]``,
``[0].b``), so both packages lay θ out alike.

Every method works on numpy (host, float64) and on tensors (device; the
unflattening is differentiable, for ``torch.func.grad`` over θ).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

from .utils.tree import tree_leaves, tree_map

__all__ = ["ThetaSpec"]


def _leaf(v):
    """A leaf as a tensor (kept) or a float64 numpy array."""
    return v if isinstance(v, torch.Tensor) else np.asarray(v, np.float64)


def _canonicalize(theta: Any) -> Any:
    """θ as a tree of leaves. A mapping's values are leaves themselves, as
    muse_tpu takes them (``jnp.asarray`` of each): a sequence there is one
    array, and a mapping there is refused."""
    if isinstance(theta, Mapping):
        for k, v in theta.items():
            if isinstance(v, Mapping):
                raise TypeError(f"θ entry {k!r} is a mapping: a mapping θ "
                                "holds scalars and arrays (as muse_tpu's "
                                "ThetaSpec takes it)")
        return {k: _leaf(theta[k]) for k in sorted(theta)}
    return tree_map(_leaf, theta)


def _names(tree, path: str = "") -> list:
    """JAX's ``_leaf_names`` for ``tree``: the key path of each leaf, and an
    index per element of a leaf that is not 0-d."""
    if isinstance(tree, Mapping):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{path}.{k}")]
    if isinstance(tree, (tuple, list)):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{path}[{i}]")]
    base = path.lstrip(".") or "theta"
    if tree.ndim == 0:
        return [base]
    return [f"{base}[{i}]" for i in range(math.prod(tree.shape))]


@dataclasses.dataclass(frozen=True)
class ThetaSpec:
    """Maps user-facing θ structures to flat vectors and back.

    Attributes:
      skeleton: θ's structure with ``None`` in place of each leaf.
      shapes: the leaves' shapes, in flattening order.
      n: flat dimension of θ.
      scalar: True if the user passed a bare scalar.
      names: flat coordinate names, e.g. ``("theta",)`` or ``("mu[0]", …)``.
      dtype: the device dtype of flattened tensors.
    """

    skeleton: Any
    shapes: tuple
    n: int
    scalar: bool
    names: tuple
    dtype: Any = torch.float32

    @classmethod
    def from_example(cls, theta: Any, dtype=torch.float32) -> "ThetaSpec":
        tree = _canonicalize(theta)
        # a sequence θ must be rectangular, as muse_tpu requires of it
        # (its ``jnp.ndim(θ)``)
        scalar = (not isinstance(theta, Mapping) and np.ndim(tree_map(
            lambda v: v.detach().cpu().numpy()
            if isinstance(v, torch.Tensor) else v, tree)) == 0)
        names = _names(tree)
        return cls(skeleton=tree_map(lambda v: None, tree),
                   shapes=tuple(tuple(v.shape) for v in tree_leaves(tree)),
                   n=len(names), scalar=scalar, names=tuple(names),
                   dtype=dtype)

    def _leaves(self, theta) -> list:
        # an array or tensor is already flat (e.g. result.theta), as JAX's
        # ravel_pytree takes it
        if isinstance(theta, (torch.Tensor, np.ndarray)):
            return [theta]
        return tree_leaves(_canonicalize(theta))

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
        leaves, at = [], 0
        for shape in self.shapes:
            size = math.prod(shape)
            leaves.append(flat[at:at + size].reshape(shape))
            at += size
        leaves = iter(leaves)
        return tree_map(lambda _: next(leaves), self.skeleton)

    def to_user(self, flat) -> Any:
        """Like :meth:`unflatten`, on the host: floats and numpy arrays."""
        if isinstance(flat, torch.Tensor):
            flat = flat.detach().cpu().numpy()
        return tree_map(lambda v: float(v) if v.ndim == 0 else v,
                        self.unflatten(np.asarray(flat, np.float64)))
