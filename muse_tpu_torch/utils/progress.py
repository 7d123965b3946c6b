"""Progress reporting.

The reference streams worker progress through a ``RemoteChannel`` into a
master-side ProgressMeter (``src/progress.jl:17-47``) because its unit of
work is a per-sim task on a remote process.  Here, all sims advance inside
one compiled device step, so the natural progress unit is the outer
iteration; per-iteration stats (current θ, score norm) are the payload.
Uses tqdm when available; degrades to stderr lines; silent by default.
"""

from __future__ import annotations

import sys
import time


class ProgressReporter:
    def __init__(self, total: int, label: str, enabled: bool = False):
        self.enabled = enabled
        self.total = max(total, 0)
        self.label = label
        self.n = 0
        self._t0 = time.perf_counter()
        self._tqdm = None
        if enabled:
            try:
                from tqdm import tqdm
                self._tqdm = tqdm(total=self.total, desc=label,
                                  file=sys.stderr, leave=True)
            except ImportError:
                pass

    def grow(self, extra: int):
        """Raise the total after construction (work discovered late,
        e.g. an extra adaptive-FD rebalancing round)."""
        self.total += max(extra, 0)
        if self._tqdm is not None:
            self._tqdm.total = self.total
            self._tqdm.refresh()

    def step(self, msg: str = "", inc: int = 1):
        self.n += inc
        if not self.enabled:
            return
        if self._tqdm is not None:
            self._tqdm.update(inc)
            if msg:
                self._tqdm.set_postfix_str(msg)
        else:
            dt = time.perf_counter() - self._t0
            print(f"{self.label}: {self.n}/{self.total} ({dt:.1f}s) {msg}",
                  file=sys.stderr)

    def close(self):
        if self._tqdm is not None:
            self._tqdm.close()
