"""The comparison that decides ``correct`` refuses the control and the
faults a cell can have, at a tiny size on the CPU.

The control is the reference put in the program's place in bfloat16. The
faults are planted under the timed path, in the program's step
(``CompiledProblem.muse_step_white``), with the rest of a run as it is: a
step that returns its state unchanged, a step whose MAP solve is skipped
(the warm start handed back as the MAP; the analytic score never reads it),
half of the batch left out with the mean of the rest in its place, an
answer altered where it is produced. (A cell on one chip has no exchange
between chips to leave out.)"""

import contextlib

import numpy as np
import pytest
import torch

from benchmark.models import grf_spectral
from benchmark.tests._tiny import TINY, run_tiny, tiny_spec


def test_control_is_refused():
    spec = tiny_spec()
    cfg = spec["config"]
    pool = grf_spectral.make_pool(cfg, 2 ** 31 + 99, 2, "cpu")
    for i in range(2):
        out = grf_spectral.control(cfg, pool[i], 1000 + i, TINY["nsims"])
        nums = grf_spectral.check(cfg, pool[i], 1000 + i, TINY["nsims"], out)
        failed = [k for k, v in nums.items() if v > cfg["limits"][k]]
        assert failed, nums


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


@pytest.mark.parametrize(
    "fault", [_unchanged, _maps_skipped, _half_batch, _altered],
    ids=["state_unchanged", "maps_skipped", "half_batch", "altered"])
def test_fault_is_refused(monkeypatch, fault):
    from muse_tpu_torch.solver import CompiledProblem
    monkeypatch.setattr(CompiledProblem, "muse_step_white",
                        fault(CompiledProblem.muse_step_white))
    rc, line, err = run_tiny(seed=2 ** 31 + 4242, seconds=0.5)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0 or any(
        c["value"] > c["limit"] for c in line["checks"].values())
    if fault is _maps_skipped:
        assert line["checks"]["map_grad"]["value"] > 1e3


def test_maps_are_kept_from_every_step_of_the_fit():
    """The kept MAPs cover the data lane and the drawn sims at every θ of
    the fit, and a pipeline whose MAPs are missing is judged not correct."""
    spec = tiny_spec()
    cfg, nsims = spec["config"], TINY["nsims"]
    pool = grf_spectral.make_pool(cfg, 2 ** 31 + 5, 1, "cpu")
    seed = 2 ** 31 + 77
    out = grf_spectral.pipeline(cfg, pool[0], seed, nsims,
                                lambda name: contextlib.nullcontext())
    lanes = grf_spectral.map_lanes(seed, nsims)
    assert lanes[0] == 0 and len(lanes) == 1 + grf_spectral.MAP_SIMS
    maps = out["bulk"]["maps"]
    assert len(maps) == len(lanes) * out["iterations"]
    nums = grf_spectral.check(cfg, pool[0], seed, nsims, out)
    assert nums["map_grad"] <= cfg["limits"]["map_grad"], nums
    out["bulk"]["maps"] = maps[:-1]
    assert grf_spectral.check(cfg, pool[0], seed, nsims,
                              out)["map_grad"] == float("inf")


def test_sound_run_is_correct():
    rc, line, err = run_tiny(seed=2 ** 31 + 4242, seconds=0.5)
    assert rc == 0 and line["correct"] is True, (err[-2000:], line)
    assert np.isfinite([c["value"] for c in line["checks"].values()]).all()
