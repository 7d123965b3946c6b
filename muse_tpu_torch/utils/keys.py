"""Common-random-number seed discipline.

Counterpart of ``muse_tpu/utils/keys.py``. The reference's ``split_rng``
derives N child RNGs without advancing the parent (``src/util.jl:87-92``)
and is re-called with the same rng every outer iteration
(``src/muse.jl:169``), so each simulation re-uses the same randomness at
every θ. That makes the Monte-Carlo score s(θ) deterministic in θ, which is
what lets a quasi-Newton root-finder converge.

Here a simulation is an integer seed. Each lane draws from its own
``torch.Generator(device)`` seeded with it (:func:`lane_generator`), so no
code touches global RNG state. Seeds come from numpy's ``SeedSequence``
with the simulation's index in the spawn key: the same master seed always
gives the same seeds, and a larger ``nsims`` keeps the smaller set as its
prefix (the incremental ``get_J!`` resume, ``src/muse.jl:499-506``).
Torch's generators give other numbers than JAX's threefry from any seed,
so the two packages agree in distribution, not draw by draw.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sim_seeds", "dummy_seed", "lane_generator"]

# spawn-key heads: simulation lanes and the data lane's dummy never collide
_SIMS, _DUMMY = 0, 1


def _derive(seed: int, spawn_key) -> int:
    if not isinstance(seed, (int, np.integer)) or seed < 0:
        raise ValueError(f"seed must be a non-negative int, got {seed!r}")
    ss = np.random.SeedSequence(int(seed), spawn_key=tuple(spawn_key))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def sim_seeds(seed: int, nsims: int, salt: int = 0) -> list:
    """Per-sim seeds; ``salt`` separates independent sets (``get_H`` uses
    ``salt=1``, as ``muse_tpu`` does, jacobians.py:578)."""
    return [_derive(seed, (_SIMS, salt, i)) for i in range(nsims)]


def dummy_seed(seed: int) -> int:
    """Seed of the data lane (lane 0) of ``muse_step``. That lane's sample is
    replaced by the observed data; it is drawn only so that every lane does
    the same work (the ``fold_in(key, 2**31 - 1)`` of muse.py:179)."""
    return _derive(seed, (_DUMMY, 2 ** 31 - 1))


def lane_generator(seed: int, device) -> torch.Generator:
    """A fresh generator on ``device`` seeded with one lane's seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
