"""The lensing cell at a tiny size on the CPU: a sound run is correct and
keeps its MAPs; the control and the faults a cell can have come out not
correct; the counting functions against counts made by hand.

The control is the reference put in the program's place with every stored
array rounded to bfloat16. The faults are planted under the timed path, in
the program's step (``CompiledProblem.muse_step_white``), with the rest of
a run as it is: a step that returns its first state forever, a step whose
MAP solve is skipped (the warm start handed back as the MAP), half of the
batch left out with the mean of the rest in its place, one sim's score
altered where it is produced, and every lane flagged unconverged."""

import contextlib
import math

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.counts import lensing as counts
from benchmark.models import lensing
from benchmark.tests._tiny import run_tiny

#: 16² maps, 6 sims, 3 outer steps, 4 H sims (2 of them checked): the θ
#: loop stops at ``maxsteps``, which the replay follows as it follows the
#: θ_rtol stop
TINY = {"n": 16, "nsims": 6, "maxsteps": 3, "h_nsims": 4, "h_checked": 2}
SEED = 2 ** 31 + 4242
#: at 16² the port's float32 HVP CG stalls at a residual of ~1e-2 of ‖b‖
#: within its 100 steps, so H reads 1.6e-3-6.2e-3 from float64 and σ up to
#: 4.7e-4 (CPU runs; tests/test_torch_lensing_reference.py holds H at a
#: converged CG); at 1024² the CG converges and the cell's limits hold
#: (PERF.md §2). The tiny cell's H and σ limits sit above that stall; the
#: others are the cell's.
TINY_LIMITS = {"H_gap": 2e-2, "sigma_gap": 5e-3}


def tiny_spec():
    spec = run.cell_spec("lensing_1024.sims64")
    cfg = spec["config"]
    cfg["n"] = TINY["n"]
    cfg["fit"]["maxsteps"] = TINY["maxsteps"]
    cfg["h"].update(nsims=TINY["h_nsims"], checked=TINY["h_checked"])
    cfg["limits"].update(TINY_LIMITS)
    spec["traffic"].update(nsims=TINY["nsims"], pool=2, check_pipelines=1)
    return spec


def _unchanged(fn):
    first = {}

    def step(comp, th, th_t, W, Z, lane_ids, atol):
        key = (id(comp), int(lane_ids[0]))
        if key not in first:
            first[key] = fn(comp, th, th_t, W, Z, lane_ids, atol)
        return first[key]
    return step


def _maps_skipped(fn):
    def step(comp, th, th_t, W, Z, lane_ids, atol):
        out = fn(comp, th, th_t, W, Z, lane_ids, atol)
        out["Z"] = Z
        return out
    return step


def _half_batch(fn):
    def step(comp, *args):
        out = fn(comp, *args)
        h = (out["g"].shape[0] + 1) // 2
        for k in ("g", "g_t"):
            g = out[k].clone()
            g[h:] = g[:h].mean(0)
            out[k] = g
        return out
    return step


def _altered(fn):
    def step(comp, th, th_t, W, Z, lane_ids, atol):
        out = fn(comp, th, th_t, W, Z, lane_ids, atol)
        hit = lane_ids == 1                         # the first sim's score
        for k in ("g", "g_t"):
            out[k] = torch.where(hit[:, None], out[k] * 1.001, out[k])
        return out
    return step


def _unconverged(fn):
    def step(comp, *args):
        out = fn(comp, *args)
        out["converged"] = torch.zeros_like(out["converged"])
        return out
    return step


@pytest.mark.parametrize(
    "fault", [_unchanged, _maps_skipped, _half_batch, _altered,
              _unconverged],
    ids=["state_unchanged", "maps_skipped", "half_batch", "altered",
         "all_unconverged"])
def test_fault_is_refused(monkeypatch, fault):
    from muse_tpu_torch.solver import CompiledProblem
    monkeypatch.setattr(CompiledProblem, "muse_step_white",
                        fault(CompiledProblem.muse_step_white))
    try:
        rc, line, err = run_tiny(seed=SEED, seconds=0.1, spec=tiny_spec())
    except RuntimeError:
        # the fault broke the set-up's warm pipeline (get_J or get_H
        # refuses what it was handed): the run ends without a result line
        return
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0 or any(
        c["value"] > c["limit"] for c in line["checks"].values())
    if fault is _maps_skipped:
        assert line["checks"]["map_grad"]["value"] > 1e2


def test_control_is_refused():
    spec = tiny_spec()
    cfg, nsims = spec["config"], TINY["nsims"]
    pool = lensing.make_pool(cfg, 2 ** 31 + 99, 1, "cpu")
    out = lensing.control(cfg, pool[0], 1000, nsims)
    nums = lensing.check(cfg, pool[0], 1000, nsims, out)
    failed = [k for k, v in nums.items() if v > cfg["limits"][k]]
    assert failed, nums


def test_sound_run_keeps_its_maps_and_is_correct():
    """A sound run is correct, and its checked pipeline kept the data lane
    and the drawn sims at every step, every lane at the last step and
    every H sim; a pipeline whose MAPs are missing reads not correct."""
    rc, line, err = run_tiny(seed=SEED, seconds=0.1, spec=tiny_spec())
    assert rc == 0 and line["correct"] is True, (err[-2000:], line)
    assert np.isfinite([c["value"] for c in line["checks"].values()]).all()

    spec = tiny_spec()
    cfg, nsims = spec["config"], TINY["nsims"]
    pool = lensing.make_pool(cfg, 2 ** 31 + 5, 1, "cpu")
    seed = 2 ** 31 + 77
    out = lensing.pipeline(cfg, pool[0], seed, nsims,
                           lambda name: contextlib.nullcontext())
    lanes = lensing.map_lanes(seed, nsims)
    bulk = out["bulk"]
    assert lanes[0] == 0 and len(lanes) == 1 + lensing.MAP_SIMS
    assert len(bulk["maps"]) == len(lanes) * out["iterations"]
    assert bulk["last"][1].shape == (nsims + 1, 2 * TINY["n"] ** 2)
    assert bulk["h"][1].shape == (TINY["h_nsims"], 2 * TINY["n"] ** 2)
    bulk["maps"] = bulk["maps"][:-1]
    assert lensing.check(cfg, pool[0], seed, nsims,
                         out)["map_grad"] == math.inf


def test_same_seed_same_inputs():
    cfg = tiny_spec()["config"]
    a = lensing.make_pool(cfg, 2 ** 31 + 7, 3, "cpu")
    b = lensing.make_pool(cfg, 2 ** 31 + 7, 3, "cpu")
    assert a.shape == (3, TINY["n"], TINY["n"]) and torch.equal(a, b)
    assert not torch.equal(a, lensing.make_pool(cfg, 8, 3, "cpu"))


def test_step_counts_by_hand():
    # n = 4: N = 16 pixels, n·nr = 12 half-spectrum modes, L = 24 packed
    # floats. G: read L + 6N, write N; Gᵀ: read N + 6N, write L.
    nbytes, ops = counts.inner_step({"n": 4})
    assert nbytes == 4 * (24 + 96 + 16 + 16 + 96 + 24)
    fft = 2.5 * 16 * 4
    assert ops == (36 * 12 + 6 * fft + 11 * 16) + (6 * 16 + 6 * fft
                                                     + 46 * 12)
    assert counts.step({"n": 4}, 3, 2) == (6 * nbytes, 6 * ops)
    assert counts.step({"n": 4}, 3, 0) == (0, 0)


def test_counters_read_the_port():
    from muse_tpu_torch.utils import trace
    c = counts.counters()
    assert set(c) == {"cg_steps", "h_cg_steps", "polished_lanes",
                      "frozen_lanes"}
    t = trace.counters()
    assert c["cg_steps"] == t["batched_varpro.inner_steps"]
    assert c["h_cg_steps"] == t["batched_cg.steps"]
