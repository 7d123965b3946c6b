"""The port's seed rule, frozen.

A copy of ``muse_tpu_torch/utils/keys.py`` at commit f22a353 (``_derive``,
``sim_seeds``, ``dummy_seed``). The reference draws each simulation lane
from the seed the port derives for it, so it must derive the same seeds
without importing the port.
"""

from __future__ import annotations

import numpy as np

# spawn-key heads of the port: simulation lanes and the data lane's dummy
_SIMS, _DUMMY = 0, 1


def derive(seed: int, spawn_key) -> int:
    """A non-negative 63-bit seed from ``seed`` and a spawn key."""
    ss = np.random.SeedSequence(int(seed), spawn_key=tuple(spawn_key))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def sim_seeds(seed: int, nsims: int, salt: int = 0) -> list:
    """Per-sim seeds: ``muse_fit`` and ``get_J`` take salt 0, ``get_H`` 1."""
    return [derive(seed, (_SIMS, salt, i)) for i in range(nsims)]


def dummy_seed(seed: int) -> int:
    """Seed of the data lane, whose draw the port replaces by the data."""
    return derive(seed, (_DUMMY, 2 ** 31 - 1))


def lane_seed(seed: int, lane: int) -> int:
    """Seed of ``muse_fit``'s global lane ``lane``: the data lane's dummy
    for 0, then the sims in order (``solver/muse.py``'s ``seeds_all``)."""
    return dummy_seed(seed) if lane == 0 else derive(seed, (_SIMS, 0,
                                                            lane - 1))
