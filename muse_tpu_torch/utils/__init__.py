from .device import resolve_device, synchronize
from .keys import dummy_seed, lane_generator, sim_seeds
from .progress import ProgressReporter

__all__ = ["dummy_seed", "lane_generator", "sim_seeds", "resolve_device",
           "synchronize", "ProgressReporter"]
