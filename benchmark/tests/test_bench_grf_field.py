"""The field GRF cell at a small size on the CPU: a sound traced run is
correct and reports the cell's metrics; the control and the faults a cell
can have come out not correct; the counting functions against counts made
by hand.

The control is the reference put in the program's place with every stored
array rounded to bfloat16. The faults are planted under the timed path, in
the program's keyed step (``CompiledProblem.muse_step``) or its
finite-difference H (``CompiledProblem.h_fd``), with the rest of a run as it
is: a step that returns its first state forever, a step whose Wiener MAP is
skipped (the warm start handed back as the MAP; the scores are still the
MAP's), lane i drawn from lane i+1's seed, one sim's score altered where it
is produced, and the stencil's + side drawn at θ̂ itself.

The size is 256²: below ~100 in |k| every mode of this spectrum lies above
the noise (C > σ²), so at 32² or 64² a lane's score is a sum of a few
hundred terms of the order of the sims' spread, where at 256² and at the
cell's 1024² it carries −½Σw of the noise-dominated modes too, and a
×1.001 fault moves it by a large share of that spread at both sizes."""

import contextlib
import math

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.counts import grf_field as counts
from benchmark.models import grf_field
from benchmark.tests._tiny import run_tiny

#: 256² fields, 16 sims (17 lanes in one call), 4 H sims, 2 pipelines
#: checked a run
SMALL = {"n": 256, "nsims": 16, "h_nsims": 4}
SEED = 2 ** 31 + 4242


def small_spec():
    spec = run.cell_spec("grf_field_1024.sims100")
    spec["config"]["n"] = SMALL["n"]
    spec["config"]["h"]["nsims"] = SMALL["h_nsims"]
    spec["traffic"].update(nsims=SMALL["nsims"], pool=2, check_pipelines=2)
    return spec


def _unchanged(fn):
    first = {}

    def step(comp, th, th_t, seeds, Z, lane_ids, atol):
        key = (id(comp), int(lane_ids[0]))
        if key not in first:
            first[key] = fn(comp, th, th_t, seeds, Z, lane_ids, atol)
        return first[key]
    return step


def _map_skipped(fn):
    def step(comp, th, th_t, seeds, Z, lane_ids, atol):
        out = fn(comp, th, th_t, seeds, Z, lane_ids, atol)
        out["Z"] = Z
        return out
    return step


def _next_seed(fn):
    def step(comp, th, th_t, seeds, Z, lane_ids, atol):
        return fn(comp, th, th_t, list(seeds[1:]) + list(seeds[:1]), Z,
                  lane_ids, atol)
    return step


def _altered(fn):
    def step(comp, th, th_t, seeds, Z, lane_ids, atol):
        out = fn(comp, th, th_t, seeds, Z, lane_ids, atol)
        hit = lane_ids == 1                         # the first sim's score
        for k in ("g", "g_t"):
            out[k] = torch.where(hit[:, None], out[k] * 1.001, out[k])
        return out
    return step


def _plus_side_at_theta(fn):
    def h_fd(comp, seeds, th, steps, Zfid, atol, offsets):
        offsets = np.where(np.asarray(offsets) > 0, 0.0, offsets)
        return fn(comp, seeds, th, steps, Zfid, atol, offsets)
    return h_fd


@pytest.mark.parametrize(
    "method,fault",
    [("muse_step", _unchanged), ("muse_step", _map_skipped),
     ("muse_step", _next_seed), ("muse_step", _altered),
     ("h_fd", _plus_side_at_theta)],
    ids=["state_unchanged", "map_skipped", "next_seed", "altered",
         "plus_side_at_theta"])
def test_fault_is_refused(monkeypatch, method, fault):
    from muse_tpu_torch.solver import CompiledProblem
    monkeypatch.setattr(CompiledProblem, method,
                        fault(getattr(CompiledProblem, method)))
    rc, line, err = run_tiny(seed=SEED, seconds=0.1, spec=small_spec())
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
    checks = line["checks"]
    assert line["failed"] > 0 or any(
        c["value"] > c["limit"] for c in checks.values())
    if fault is _map_skipped:
        # the scores are the MAP's own: only the kept MAPs see it
        assert checks["map_gap"]["value"] > 0.5
        assert checks["score_gap"]["value"] <= checks["score_gap"]["limit"]
    if fault is _plus_side_at_theta:
        assert checks["H_gap"]["value"] > 0.4


def test_control_is_refused():
    spec = small_spec()
    cfg, nsims = spec["config"], SMALL["nsims"]
    pool = grf_field.make_pool(cfg, 2 ** 31 + 99, 2, "cpu")
    for i in range(2):
        out = grf_field.control(cfg, pool[i], 1000 + i, nsims)
        nums = grf_field.check(cfg, pool[i], 1000 + i, nsims, out)
        failed = [k for k, v in nums.items() if v > cfg["limits"][k]]
        assert failed, nums


def test_sound_traced_run_reports_the_cell_and_is_correct():
    """A traced run is correct and reports the cell's per-layer metrics:
    ``looped_lanes`` is every lane of the fit's one call an iteration,
    ``h_fd_ms`` and ``step_ms`` are positive. ``mfu_step`` needs a card's
    peaks, which the run reads on a card only: here it is read from the
    same records with the H100's."""
    from benchmark import peaks
    from benchmark.trace import Tracer

    rc, line, err = run_tiny(seed=SEED, seconds=0.1, trace=1,
                             spec=small_spec())
    assert rc == 0 and line["correct"] is True, (err[-2000:], line)
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert {"looped_lanes", "h_fd_ms", "step_ms", "host_share",
            "outer_iters"} <= set(m)
    assert np.isfinite(list(m.values())).all()
    assert m["looped_lanes"] == SMALL["nsims"] + 1
    assert m["h_fd_ms"] > 0 and m["step_ms"] > 0

    spec = small_spec()
    cfg = spec["config"]
    pool = grf_field.make_pool(cfg, 2 ** 31 + 5, 1, "cpu")
    tracer = Tracer(True, torch.device("cpu"), grf_field)
    tracer.install()
    try:
        with tracer.pipeline() as rec:
            out = grf_field.pipeline(cfg, pool[0], 2 ** 31 + 6,
                                     SMALL["nsims"], tracer.span)
            rec["iterations"] = out["iterations"]
    finally:
        tracer.uninstall()
    reading = {"pipelines": tracer.pipelines, "cfg": cfg, "counts": counts,
               "peaks": peaks.peaks("NVIDIA H100 80GB HBM3")}
    mfu = run._metric_reader("mfu_step")(reading)
    assert mfu is not None and 0 < mfu < 100
    fit = [x for x in tracer.pipelines[0]["steps"] if x["fit"]]
    assert len(fit) == out["iterations"]
    assert all(x["lanes"] == SMALL["nsims"] + 1 and x["cg_steps"] == 0
               and x["looped_lanes"] == SMALL["nsims"] + 1 for x in fit)
    fd = [x for x in tracer.pipelines[0]["steps"] if x["name"] == "h_fd"]
    assert [x["h_fd_lanes"] for x in fd] == [2 * SMALL["h_nsims"]]


def test_maps_are_kept_from_every_step_of_the_fit():
    """The kept MAPs cover the data lane and the drawn sims at every θ of
    the fit, each the lane's Wiener filter; a pipeline whose MAPs are
    missing is judged not correct."""
    spec = small_spec()
    cfg, nsims = spec["config"], SMALL["nsims"]
    pool = grf_field.make_pool(cfg, 2 ** 31 + 5, 1, "cpu")
    seed = 2 ** 31 + 77
    out = grf_field.pipeline(cfg, pool[0], seed, nsims,
                             lambda name: contextlib.nullcontext())
    lanes = grf_field.map_lanes(seed, nsims)
    assert lanes[0] == 0 and len(lanes) == 1 + grf_field.MAP_SIMS
    maps = out["bulk"]["maps"]
    assert len(maps) == len(lanes) * out["iterations"]
    nums = grf_field.check(cfg, pool[0], seed, nsims, out)
    assert all(v <= cfg["limits"][k] for k, v in nums.items()), nums
    out["bulk"]["maps"] = maps[:-1]
    nums = grf_field.check(cfg, pool[0], seed, nsims, out)
    assert nums["map_gap"] == nums["map_grad"] == math.inf


def test_same_seed_same_inputs():
    cfg = small_spec()["config"]
    a = grf_field.make_pool(cfg, 2 ** 31 + 7, 3, "cpu")
    b = grf_field.make_pool(cfg, 2 ** 31 + 7, 3, "cpu")
    assert a.shape == (3, SMALL["n"], SMALL["n"]) and torch.equal(a, b)
    assert not torch.equal(a, grf_field.make_pool(cfg, 8, 3, "cpu"))


def test_step_counts_by_hand():
    # n = 4: N = 16 pixels, h = 4·3 = 12 spectral values, a real FFT
    # 2.5·16·4 = 160 operations. Bytes a lane: the draws 2N floats; each
    # FFT pair N + h·(1 + 2 + 1) complex + N; the noise 3N; the stack 2N;
    # the mix 2N; the score N + h complex + 4h + 2h floats.
    N, h, fft = 16, 12, 160.0
    pair = 4 * N + 8 * 4 * h + 4 * N
    per_lane = (4 * 2 * N + 2 * pair + 4 * 3 * N + 4 * 2 * N + 4 * 2 * N
                + 4 * N + 8 * h + 4 * 6 * h)
    ops = 2 * (2 * fft + 4 * h) + 2 * N + fft + 6 * h
    assert counts.step({"n": 4}, 3, 0) == (3 * per_lane, 3 * ops)
    # the step has no PCG: a count of steps changes nothing
    assert counts.step({"n": 4}, 3, 5) == counts.step({"n": 4}, 3, 0)
    # the quadforms at B=2, K=1, (n, 2m) = (4, 6): z 48 in, w 24 in, 2 out
    assert counts.kernel_bytes("quadforms", (2, 1, 4, 6)) == 4 * (48 + 24
                                                                   + 2)
    z = torch.zeros(5, 4, 6)
    assert counts.launch_shape("spectrum_quadforms_cuda",
                               (z, torch.zeros(1, 4, 6))) == (5, 1, 4, 6)


def test_counters_read_the_port():
    from muse_tpu_torch.utils import trace
    c = counts.counters()
    assert set(c) == {"cg_steps", "looped_lanes", "h_fd_lanes"}
    assert c["cg_steps"] == 0
    t = trace.counters()
    assert c["looped_lanes"] == t["sample_batch.looped_lanes"]
    assert c["h_fd_lanes"] == t["h_fd.lanes"]
