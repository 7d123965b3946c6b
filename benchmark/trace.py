"""The traced run's instruments: spans, counters and the device trace.

Spans come from the benchmark's own code around the calls into each layer:
in the traced run only, a ``torch.profiler.record_function`` around each
phase of a pipeline and a wrapper around each of the program's step methods
(``CompiledProblem``, the model's ``STEP_METHODS``).

The traced window's first pipelines run under ``torch.profiler``, whose
Chrome trace gives the device's busy intervals, the kernels' device time by
name and what the host did in each idle gap; there the step wrappers only
name their span, so the device's timeline is the program's but for the
profiler's own cost on the host. The kernel wrappers record the shape of
every launch while the profiler runs, so a kernel's bytes are counted for
exactly the launches it timed. The pipelines after them are timed: each
step call with a synchronise on each side, reading the port's counters
(the model's ``COUNTS.counters``) before and after.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import re
import time

import torch


class Tracer:
    """Spans and counters of the pipelines of one run. Off, it adds nothing
    but a ``nullcontext`` per phase."""

    def __init__(self, enabled: bool, device, model):
        self.enabled = enabled
        self.device = device
        self.model = model
        self.pipelines = []          # one record per timed pipeline
        self._current = None
        self._depth = 0
        self._patched = []
        self.launches = None         # [(kind, shape)] while profiling

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def pipeline(self, timed: bool = True):
        """Around one pipeline: its wall and, ``timed``, its step calls."""
        if not self.enabled:
            yield
            return
        rec = {"steps": [], "wall": None, "timed": timed}
        self._current = rec
        self.sync()
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("bench.pipeline"):
                yield rec
            self.sync()
            rec["wall"] = time.perf_counter() - t0
            if timed:
                self.pipelines.append(rec)
        finally:
            self._current = None

    # -- the program's step methods and kernel wrappers, patched ---------- #

    def install(self):
        if not self.enabled:
            return
        from muse_tpu_torch.solver import CompiledProblem
        for name in self.model.STEP_METHODS:
            fn = getattr(CompiledProblem, name)
            setattr(CompiledProblem, name, self._wrap_step(name, fn))
            self._patched.append((CompiledProblem, name, fn))
        counts = self.model.COUNTS
        mod = importlib.import_module(counts.KERNEL_MODULE)
        for kind, spec in counts.KERNELS.items():
            for w in spec["wrappers"]:
                fn = getattr(mod, w)
                setattr(mod, w, self._wrap_launch(kind, w, fn))
                self._patched.append((mod, w, fn))

    def uninstall(self):
        for owner, name, fn in reversed(self._patched):
            wrapped = getattr(owner, name)
            if "launches" in wrapped.__dict__:
                fn.launches = wrapped.launches
            setattr(owner, name, fn)
        self._patched = []

    def _wrap_step(self, name, fn):
        tracer = self

        def wrapped(comp, *args, **kwargs):
            rec = tracer._current
            if rec is None or tracer._depth:
                return fn(comp, *args, **kwargs)
            tracer._depth += 1
            try:
                if not rec["timed"]:
                    with torch.profiler.record_function("step." + name):
                        return fn(comp, *args, **kwargs)
                counters = tracer.model.COUNTS.counters
                tracer.sync()
                c0 = counters()
                t0 = time.perf_counter()
                with torch.profiler.record_function("step." + name):
                    out = fn(comp, *args, **kwargs)
                tracer.sync()
                t1 = time.perf_counter()
                c1 = counters()
            finally:
                tracer._depth -= 1
            lanes = (int(args[4].shape[0])
                     if name in tracer.model.FIT_STEPS else None)
            rec["steps"].append({
                "name": name, "seconds": t1 - t0, "lanes": lanes,
                "fit": name in tracer.model.FIT_STEPS,
                **{k: c1[k] - c0[k] for k in c0}})
            return out
        return wrapped

    def _wrap_launch(self, kind, wrapper, fn):
        tracer = self
        shape_of = self.model.COUNTS.launch_shape

        # the wrapper takes the place of the module's global, which the
        # original reads to count its launches: it carries the counts meanwhile
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if tracer.launches is not None:
                tracer.launches.append((kind, shape_of(wrapper, args)))
            return fn(*args, **kwargs)
        return wrapped

    # -- the profiled pipelines ------------------------------------------ #

    def profiler(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)


_TAGS = re.compile(r"\w*(?:Functor|functor|Ops)\w*")
_GENERIC = {"BinaryFunctor", "BUnaryFunctor", "AUnaryFunctor", "ReduceOp"}


def short_name(name: str) -> str:
    """A device operation's name without its signature: the kernel's own
    name (its namespace dropped), and for PyTorch's templated kernels the
    functors that say what it computes, as in
    ``vectorized_elementwise_kernel[MulFunctor]``."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    head = name[:cut]
    base = head.split("<")[0].split("::")[-1]
    tags = []
    for t in _TAGS.findall(head[len(head.split("<")[0]):]):
        if t not in tags and t != base and t not in _GENERIC:
            tags.append(t)
    return f"{base}[{','.join(tags[:2])}]" if tags else base


def device_trace(prof, path, counts) -> dict:
    """Reduce a finished profile: the traced window (the ``bench.profiled``
    span), the union of device intervals in it, device seconds by kernel
    name and by the program's kernels (``counts.KERNELS``, each finalize
    pass given to the first pass before it), and idle gaps by the innermost
    ``bench.``/``step.`` span around their midpoint. ``path`` is a scratch
    file for the Chrome trace, removed here."""
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"]
    win = [e for e in spans if e["name"] == "bench.profiled"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                   e["name"]) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and e.get("ph") == "X"), key=lambda t: t[0])
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
           if b > w0 and a < w1]
    by_name, kinds = {}, {k: 0.0 for k in counts.KERNELS}
    last_kind = None
    for a, b, name in dev:
        short = short_name(name)
        by_name[short] = by_name.get(short, 0.0) + (b - a) * 1e-6
        kind = next((k for k, s in counts.KERNELS.items()
                     if short.split("<")[0] in s["device_names"]), None)
        if kind is not None:
            last_kind = kind
            kinds[kind] += (b - a) * 1e-6
        elif short == counts.FINALIZE and last_kind is not None:
            kinds[last_kind] += (b - a) * 1e-6
    busy, gaps, end = 0.0, [], w0
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    labels = [e for e in spans
              if e["name"].startswith(("bench.", "step."))
              and e["name"] not in ("bench.profiled", "bench.pipeline")]
    gap_s = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [e for e in labels if float(e["ts"]) <= mid
                 <= float(e["ts"]) + float(e["dur"])]
        name = (min(inner, key=lambda e: float(e["dur"]))["name"]
                if inner else "bench.window")
        gap_s[name] = gap_s.get(name, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy * 1e-6,
            "by_name": by_name, "kernel_s": kinds, "gaps": gap_s}
