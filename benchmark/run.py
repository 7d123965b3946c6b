"""The benchmark of muse_tpu_torch: time to a fitted θ̂ ± σ on fresh data.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a
configuration (``benchmark/configs/<config>.json``, whose ``model`` names
the module of ``benchmark/models/`` that runs it, its reference in
``benchmark/reference/`` and its counts in ``benchmark/counts/``) under a
traffic mix (``benchmark/traffic/<traffic>.json``: sims a fit, the pool of
data realizations, how many pipelines the reference checks).

Set-up: imports, the kernels' library (built into ``muse_tpu_torch/_build``
on a checkout's first run), the pool of data realizations on the device
from ``--seed``, and one warm pipeline on a realization outside the window.
The window runs whole pipelines back to back (build the problem on the
data, ``muse_fit`` → ``get_J`` → ``get_H``, θ̂ and σ read to the host) and
starts none after ``--seconds``. Then the reference checks a sample of the
pipelines drawn from the seed, the longest among them, and the run prints
each number compared beside its limit on stderr and one JSON line on
stdout. ``--trace 1`` spans the program's step calls, profiles the first
pipelines of the window, and reports the per-layer metrics
(``benchmark/metrics/<name>.py``) in place of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path

T_MODULE = time.time()

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "muse_tpu")
#: pipelines the traced run profiles, from the window's first
PROFILED = 2


def _process_start() -> float:
    """The epoch second at which this process started (Linux /proc), or
    this module's import where /proc is not there."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_MODULE


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(workload: str, bench: dict = None) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json``: its entry, its
    configuration and traffic files, and the metrics it reports."""
    bench = bench or _load(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def here(m):
        return "workloads" not in m or workload in m["workloads"]
    return {"cell": cell, "config": _load(ROOT / conf["file"]),
            "traffic": _load(BENCH / "traffic" / f"{cell['traffic']}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if here(m)],
            "per_layer": [m for m in bench["per_layer"] if here(m)]}


def _derive(seed: int, key) -> int:
    from benchmark.reference.keys import derive
    return derive(seed % 2 ** 64, key)


class _Picker:
    """The pipelines the reference checks: a sample of the window's finished
    pipelines drawn from the seed as they finish (a reservoir of ``size`` −
    1), and the longest. Only theirs keep their ``bulk``, so the window
    holds a few pipelines' worth of it, however many it runs."""

    def __init__(self, rng, size: int):
        self.rng, self.size = rng, max(size - 1, 0)
        self.sample, self.longest, self.seen = [], None, 0
        self.held = set()

    def add(self, k: int, outs: list, walls: list):
        if len(self.sample) < self.size:
            self.sample.append(k)
        elif self.size:
            j = int(self.rng.integers(self.seen + 1))
            if j < self.size:
                self.sample[j] = k
        self.seen += 1
        if self.longest is None or walls[k] > walls[self.longest]:
            self.longest = k
        keep = set(self.picked())
        for old in (self.held | {k}) - keep:
            outs[old].pop("bulk", None)
        self.held = keep

    def picked(self) -> list:
        return sorted(set(self.sample) | {self.longest})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _err(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None, *, device=None, spec=None) -> int:
    """Run one cell; returns the exit code. ``device`` and ``spec`` (a
    :func:`cell_spec`, sizes changed) let a test drive the rest of a run
    on the CPU; without them the run takes the card or fails."""
    t_start = _process_start()
    args = parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    import numpy as np
    import torch

    spec = spec or cell_spec(args.workload)
    cell, cfg, traffic = spec["cell"], spec["config"], spec["traffic"]
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            _err(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                 f"torch.cuda.is_available() is "
                 f"{torch.cuda.is_available()}")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    model = importlib.import_module(f"benchmark.models.{cfg['model']}")
    from benchmark import peaks as peaks_mod
    from benchmark.trace import Tracer, device_trace

    import muse_tpu_torch  # noqa: F401
    if cuda:
        from muse_tpu_torch.ops.kernels import load_library
        load_library()
    nsims = traffic["nsims"]
    P = traffic["pool"]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    pool = model.make_pool(cfg, _derive(args.seed, (1,)), P + 1, device)
    tracer = Tracer(bool(args.trace), device, model)
    tracer.install()
    try:
        # the warm pipeline, on the realization the window never takes
        model.pipeline(cfg, pool[P], _derive(args.seed, (2,)), nsims,
                       tracer.span)
        if args.trace:
            with tracer.profiler():      # the profiler's own first start
                torch.zeros(1, device=device).add_(1)
        sync()
        setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        setup_s = time.time() - t_start

        # ---- the window -------------------------------------------- #
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        outs, walls, seeds, failed = [], [], [], 0
        picker = _Picker(np.random.default_rng(_derive(args.seed, (3,))),
                         traffic["check_pipelines"])
        prof, launches = None, []
        t0 = time.perf_counter()
        i = 0
        # a traced window profiles its first PROFILED pipelines and times
        # at least one after them
        while (time.perf_counter() - t0 < args.seconds
               or (args.trace and i <= PROFILED)):
            profiled = bool(args.trace) and i < PROFILED
            if profiled and i == 0:
                prof = tracer.profiler()
                prof.__enter__()
                tracer.launches = []
                marker = torch.profiler.record_function("bench.profiled")
                marker.__enter__()
            seed_i = _derive(args.seed, (0, i))
            ts = time.perf_counter()
            try:
                with tracer.pipeline(timed=not profiled) as rec:
                    out = model.pipeline(cfg, pool[i % P], seed_i, nsims,
                                         tracer.span)
                    if rec is not None:
                        rec["iterations"] = out["iterations"]
                sync()
            except Exception:                      # counted, and reported
                failed += 1
                out = None
                _err(traceback.format_exc())
            walls.append(time.perf_counter() - ts)
            outs.append(out)
            seeds.append(seed_i)
            if out is not None:
                picker.add(i, outs, walls)
            i += 1
            if prof is not None and i == PROFILED:
                marker.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                launches, tracer.launches = tracer.launches, None
        window_s = time.perf_counter() - t0
        if prof is not None and tracer.launches is not None:
            marker.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            launches, tracer.launches = tracer.launches, None
    finally:
        tracer.uninstall()
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    attempted = len(outs)
    _err(f"pipelines {attempted} in {window_s:.3f} s, failed {failed}")

    # ---- the reference's check, after the window --------------------- #
    done = [k for k in range(attempted) if outs[k] is not None]
    nums = {}
    if done:
        pick = picker.picked()
        for k in pick:
            got = model.check(cfg, pool[k % P], seeds[k], nsims, outs[k])
            for name, v in got.items():
                nums[name] = max(nums.get(name, 0.0), v)
        _err(f"checked pipelines {pick}, the longest {picker.longest}")
    limits = cfg["limits"]
    correct = bool(done) and failed == 0 and all(
        nums.get(k, math.inf) <= lim for k, lim in limits.items())

    # ---- metrics ------------------------------------------------------ #
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    metrics = {}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                "count": cell["chips"] if cuda else 0,
                "memory_peak_bytes": int(max(setup_peak, peak_window))}
    if not args.trace:
        ok_walls = [walls[k] for k in done]
        values = {"setup_s": setup_s,
                  "fit_s": window_s / attempted if attempted else None,
                  "fit_p90_s": (float(np.percentile(ok_walls, 90))
                                if ok_walls else None),
                  "peak_gib": peak_window / 2 ** 30 if cuda else None}
        _err(f"fit_p90_s over {len(ok_walls)} pipelines")
        for m in spec["end_to_end"]:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        breakdown = None
    else:
        CACHE.mkdir(exist_ok=True)
        dev = (device_trace(prof, CACHE / f"trace.{os.getpid()}.json",
                            model.COUNTS) if prof is not None else None)
        reading = {"pipelines": [p for p in tracer.pipelines
                                 if "iterations" in p],
                   "device": dev, "launches": launches,
                   "cfg": cfg, "counts": model.COUNTS,
                   "peaks": peaks_mod.peaks(name) if cuda else None}
        for m in spec["per_layer"]:
            v = _metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if dev is not None:
            kinds = {k: sum(1 for kk, _ in launches if kk == k)
                     for k in model.COUNTS.KERNELS}
            _err(f"profiled {PROFILED} pipelines: launches {kinds}, device "
                 f"seconds {dev['kernel_s']}")
            _err(f"profiled window {dev['window_s']!r} s for {PROFILED} "
                 f"pipelines, {dev['window_s'] / PROFILED!r} s a pipeline")
            dev_info["busy_s"] = dev["busy_s"]
            dev_info["window_s"] = dev["window_s"]
            top = sorted(dev["by_name"].items(), key=lambda t: -t[1])[:10]
            gaps = sorted(dev["gaps"].items(), key=lambda t: -t[1])[:10]
            breakdown = {"device_ops": [list(t) for t in top],
                         "idle_gaps": [list(t) for t in gaps]}
        else:
            breakdown = None
        timed = tracer.pipelines
        if timed:
            by_step = {}
            for p in timed:
                for x in p["steps"]:
                    by_step[x["name"]] = by_step.get(x["name"], 0.0) + \
                        x["seconds"] / len(timed)
            _err(f"timed pipelines {len(timed)}, "
                 f"{sum(p['wall'] for p in timed) / len(timed)!r} s a "
                 f"pipeline; step calls, seconds a pipeline: {by_step}")
    if cuda:
        _err(f"card {name}, power limit {_power_limit()}")

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        _err(f"modules that must not load here are loaded: {found}")
        return 3

    # JSON has no infinity: a number that could not be read shows as 1e300
    checks = {k: {"value": min(nums.get(k, math.inf), 1e300), "limit": lim}
              for k, lim in limits.items()}
    for k, c in checks.items():
        _err(f"{k} {c['value']!r} limit {c['limit']!r}")
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


if __name__ == "__main__":
    sys.exit(main())
