"""Spans and host-sync counters of the port: where a pipeline's host time goes.

Off by default; :func:`enable` turns the spans on for the process. On, each
``span(name)`` adds its host wall (``time.perf_counter_ns``, the clock a
caller's own pipeline walls use) to a per-process table by name, and while
a ``torch.profiler`` records it also enters ``record_function(name)``, so
the span lands in the Chrome trace as a ``user_annotation`` on the device
trace's clock, where an idle gap of the device can be put down to the
innermost span around it. A span never synchronises the device: on a card
a span ends when its work is queued, and the wait for that work shows in
the span of the next blocking read. Off, ``span`` costs one flag test and
returns a shared ``nullcontext``.

The counters stay function attributes at the site that counts
(``batched_cg.host_syncs``, ``spectrum_quadforms_cuda.launches``, ...);
:func:`counters` lists them by dotted name. A ``host_syncs`` counter counts
the blocking device→host reads of its function (``.cpu()``, ``.item()``,
``bool``/``int``/``float`` of a tensor), on any device, so a CPU run counts
what a card run counts.

    from muse_tpu_torch.utils import trace
    trace.enable(True)
    ...                          # muse_fit → get_J → get_H
    trace.summary()              # {"spans": {name: {"n", "s"}}, "counters"}
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

__all__ = ["enable", "enabled", "span", "spanned", "summary", "reset",
           "counters"]

_on = False
_OFF = contextlib.nullcontext()
_table = {}                 # name → [calls, nanoseconds]


def enable(on: bool = True) -> None:
    """Turn the spans on (or off) for this process."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        row = _table.get(self.name)
        if row is None:
            _table[self.name] = [1, dt]
        else:
            row[0] += 1
            row[1] += dt
        return False


def span(name: str):
    """A context manager around one phase, recorded under ``name`` while
    the spans are on."""
    if not _on:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def reset() -> None:
    """Clear the span table (the counters are their sites' own)."""
    _table.clear()


def summary() -> dict:
    """The span table, ``{name: {"n": calls, "s": seconds}}``, and
    :func:`counters`."""
    return {"spans": {k: {"n": n, "s": ns * 1e-9}
                      for k, (n, ns) in _table.items()},
            "counters": counters()}


def counters() -> dict:
    """Every counter the port keeps, by ``<function>.<counter>``."""
    from ..models.grf import grf_spectral_problem
    from ..models.lensing import zhat_varpro_counts
    from ..ops import grf_spectrum as gs
    from ..ops import lens_planes as lp
    from ..ops.cg import batched_cg
    from ..ops.herm_white import herm_white_cuda
    from ..ops.lbfgs import batched_lbfgs
    from ..ops.newton_cg import batched_newton_cg
    from ..ops.varpro import batched_varpro
    from ..solver.compiled import sample_whites_counts
    from ..solver.covariance import finalize_result
    from ..solver.jacobians import get_H, get_J
    from ..solver.muse import muse_fit

    sites = (
        ("batched_cg", batched_cg,
         ("steps", "curvature_steps", "host_syncs")),
        ("batched_lbfgs", batched_lbfgs,
         ("iterations", "ls_evaluations", "host_syncs")),
        ("batched_varpro", batched_varpro,
         ("iterations", "ls_trials", "inner_steps", "host_syncs")),
        ("batched_newton_cg", batched_newton_cg,
         ("iterations", "cg_steps", "hvps", "host_syncs")),
        ("zhat_varpro", zhat_varpro_counts,
         ("polish_entries", "polished_lanes", "frozen_lanes")),
        ("spectrum_quadform_cuda", gs.spectrum_quadform_cuda, ("launches",)),
        ("spectrum_quadforms_cuda", gs.spectrum_quadforms_cuda,
         ("launches",)),
        ("spectrum_quadform_and_grad_cuda",
         gs.spectrum_quadform_and_grad_cuda, ("launches",)),
        ("SpectrumQuadform", gs.SpectrumQuadform, ("evaluations",)),
        ("SpectrumQuadforms", gs.SpectrumQuadforms, ("evaluations",)),
        ("herm_white_cuda", herm_white_cuda, ("launches",)),
        ("lens_expand_cuda", lp.lens_expand_cuda, ("launches",)),
        ("lens_combine_cuda", lp.lens_combine_cuda, ("launches",)),
        ("lens_residual_cuda", lp.lens_residual_cuda, ("launches",)),
        ("lens_spread_cuda", lp.lens_spread_cuda, ("launches",)),
        ("lens_contract_cuda", lp.lens_contract_cuda, ("launches",)),
        ("sample_whites", sample_whites_counts,
         ("batched_lanes", "looped_lanes")),
        ("muse_fit", muse_fit, ("host_syncs",)),
        ("get_J", get_J, ("host_syncs",)),
        ("get_H", get_H, ("host_syncs",)),
        ("finalize_result", finalize_result, ("host_syncs",)),
        ("grf_spectral_problem", grf_spectral_problem, ("host_syncs",)),
    )
    return {f"{site}.{name}": getattr(owner, name)
            for site, owner, names in sites for name in names}
