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

The counters stay attributes of the site that counts
(``batched_cg.host_syncs``, ``spectrum_quadforms_cuda.launches``, ...), and
the site declares them where it keeps them, with :func:`declare`;
:func:`counters` lists every declared one by dotted name. This module knows
no site: the package imports every module that keeps counters, so they are
all declared once ``muse_tpu_torch`` is. A ``host_syncs`` counter counts
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
import sys
import time
import types

import torch

__all__ = ["enable", "enabled", "span", "spanned", "summary", "reset",
           "declare", "counters"]

_on = False
_OFF = contextlib.nullcontext()
_table = {}                 # name → [calls, nanoseconds]
_sites = {}                 # site → (its owner's reader, counter names)


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


def declare(owner, *names: str, site: str = None):
    """Declare the counters ``names`` of ``owner``: each an attribute of it,
    set to 0 here, and listed by :func:`counters` as ``<site>.<name>``.
    Returns ``owner``.

    A function or a class is its module's global of its name, and is read
    there at each :func:`counters` call, so a wrapper that takes that
    global's place and carries the counts meanwhile (the benchmark's launch
    recorder) is what is read; its site is its name. Any other owner (a
    namespace of counts) is read as it is, under the ``site`` it names."""
    for name in names:
        setattr(owner, name, 0)
    if isinstance(owner, (types.FunctionType, type)):
        module, site = owner.__module__, owner.__name__

        def reader():
            return getattr(sys.modules[module], site)
    elif site is None:
        raise TypeError(f"declare: a {type(owner).__name__} owner names its "
                        "site")
    else:
        def reader():
            return owner
    _sites[site] = (reader, names)
    return owner


def counters() -> dict:
    """Every declared counter, by ``<site>.<counter>``."""
    out = {}
    for site, (reader, names) in _sites.items():
        owner = reader()
        for name in names:
            out[f"{site}.{name}"] = getattr(owner, name)
    return out
