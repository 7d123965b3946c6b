"""Lensing's VarPro spans and counters (``models/lensing.py``,
``utils/trace.py``): ``muse.varpro.solve`` and ``muse.varpro.polish`` a
call, and ``zhat_varpro.polished_lanes`` and ``.frozen_lanes`` held to the
structure of a tiny solve and fit on the CPU."""

import warnings

import numpy as np
import pytest
import torch

import muse_tpu_torch as mt
from muse_tpu_torch.models import lensing_problem
from muse_tpu_torch.solver import CompiledProblem
from muse_tpu_torch.utils import trace

N, NSIMS = 16, 5


@pytest.fixture
def spans_on():
    trace.reset()
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)
        trace.reset()


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def _lanes(prob, seeds, theta):
    """The lanes' x at θ and their warm starts (the Wiener start)."""
    spec = mt.ThetaSpec.from_example(0.0)
    comp = CompiledProblem(prob, spec, spec.flatten(0.0))
    W = comp.sample_whites(seeds)
    th = torch.tensor([theta])
    xs = comp._xs_of_whites(W, th)
    z0 = comp.zspec.flatten(prob.suggested_z0)
    return xs, z0.expand(len(seeds), -1).clone(), th


def test_a_solve_that_needs_the_polish(spans_on):
    """With VarPro cut to one outer iteration no lane converges in it, so
    every lane goes to the polish: one polish entry, every lane handed to
    it, and the lanes the polish leaves unconverged counted as frozen."""
    prob = lensing_problem(n=N, gn_max_outer=1, device="cpu")
    xs, Z0, th = _lanes(prob, [1, 2, 3], 0.0)
    c0 = trace.counters()
    Z, aux = prob.zhat_varpro(xs, Z0, th, 3e-2)
    c = _delta(c0, trace.counters())
    spans = trace.summary()["spans"]
    assert spans["muse.varpro.solve"]["n"] == 1
    assert spans["muse.varpro.polish"]["n"] == 1
    assert c["zhat_varpro.polish_entries"] == 1
    assert prob.zhat_varpro.polish_entries == 1
    assert c["zhat_varpro.polished_lanes"] == 3
    assert c["zhat_varpro.frozen_lanes"] == int((~aux["converged"]).sum())
    assert c["batched_varpro.iterations"] == 1


def test_a_solve_without_the_polish(spans_on):
    """Lanes VarPro converges take no polish: no polish span, no lane
    handed over, none frozen."""
    prob = lensing_problem(n=N, device="cpu")
    xs, Z0, th = _lanes(prob, [4, 5], -0.5)
    c0 = trace.counters()
    Z, aux = prob.zhat_varpro(xs, Z0, th, 1e-2)
    c = _delta(c0, trace.counters())
    assert bool(aux["converged"].all())
    spans = trace.summary()["spans"]
    assert spans["muse.varpro.solve"]["n"] == 1
    assert "muse.varpro.polish" not in spans
    assert c["zhat_varpro.polish_entries"] == 0
    assert c["zhat_varpro.polished_lanes"] == 0
    assert c["zhat_varpro.frozen_lanes"] == 0


def test_a_fit_and_implicit_H_count_their_lanes(spans_on):
    """A tiny fit → implicit get_H: one VarPro span a step call and one in
    H's fiducial solve, a polish span a polish entry, the frozen lanes of
    the fit those its history flags unconverged, and H's HVP CG counted
    by ``batched_cg.steps`` (its operator is no curvature kernel)."""
    prob = lensing_problem(n=N, device="cpu")
    c0 = trace.counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = mt.muse_fit(mt.MuseResult(), prob, 0.0, nsims=NSIMS,
                          z0=prob.suggested_z0, maxsteps=3, alpha=0.3,
                          grad_z_atol=3e-3, seed=2)
    c_fit = _delta(c0, trace.counters())
    spans = trace.summary()["spans"]
    its = len(res.history)
    assert spans["muse.varpro.solve"]["n"] == its
    entries = c_fit["zhat_varpro.polish_entries"]
    assert spans.get("muse.varpro.polish", {"n": 0})["n"] == entries
    assert entries <= c_fit["zhat_varpro.polished_lanes"] <= entries * (
        NSIMS + 1)
    assert c_fit["zhat_varpro.frozen_lanes"] == sum(
        int((~np.asarray(h["map_converged"], bool)).sum())
        for h in res.history)
    assert spans["muse.varpro.solve"]["s"] <= spans["muse.step.solve"]["s"]

    c1 = trace.counters()
    trace.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mt.get_H(res, prob, nsims=4, implicit_diff=True,
                 implicit_diff_precond=prob.suggested_h_precond,
                 implicit_fit_atol=1e-3, seed=2)
    c_H = _delta(c1, trace.counters())
    assert trace.summary()["spans"]["muse.varpro.solve"]["n"] == 1
    assert c_H["batched_cg.curvature_steps"] == 0
    assert c_H["batched_cg.steps"] >= 1
    assert c_H["batched_cg.host_syncs"] >= 1
