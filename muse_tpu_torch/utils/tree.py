"""Pytrees of tensors: x, z and the whites of a lane.

A pytree here is a tensor, or a dict, tuple or list of pytrees (the PPL's
x and z are dicts of tensors keyed by site name). Dict entries are taken
in sorted-key order, as JAX's pytree flattening and :class:`ThetaSpec`
take them, so both packages lay a flat z out alike. ``None`` is a leaf.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch

__all__ = ["tree_map", "tree_leaves", "TreeSpec"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *parts) for parts in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in flattening order."""
    out = []
    tree_map(out.append, tree)
    return out


class TreeSpec:
    """Flattens one lane's pytree of tensors to a 1-D vector and back.

    Built from an example; a single tensor flattens by ``reshape(-1)``
    alone. ``unflatten`` is differentiable and works under ``vmap``."""

    def __init__(self, example: Any):
        leaves = tree_leaves(example)
        self.shapes = [tuple(v.shape) for v in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.n = sum(self.sizes)
        self._skeleton = tree_map(lambda v: None, example)

    def flatten(self, tree) -> torch.Tensor:
        leaves = tree_leaves(tree)
        if len(leaves) == 1:
            return leaves[0].reshape(-1)
        return torch.cat([v.reshape(-1) for v in leaves])

    def unflatten(self, flat: torch.Tensor):
        parts = flat.split(self.sizes) if len(self.sizes) > 1 else [flat]
        leaves = iter([p.reshape(s) for p, s in zip(parts, self.shapes)])
        return tree_map(lambda _: next(leaves), self._skeleton)
