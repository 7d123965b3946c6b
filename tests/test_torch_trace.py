"""The port's spans and host-sync counters (``muse_tpu_torch/utils/trace.py``):
off they record nothing; on, a CPU pipeline's span table and every
``host_syncs`` counter are what the pipeline's structure says."""

import ast
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import muse_tpu_torch as mt
from muse_tpu_torch.models import grf_spectral_problem
from muse_tpu_torch.ops import cg as cg_mod
from muse_tpu_torch.ops.cg import batched_cg
from muse_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
N, NSIMS, MAX_BATCH, MAXSTEPS, NSIMS_J, NSIMS_H = 32, 8, 4, 4, 12, 8


@pytest.fixture
def spans_on():
    trace.reset()
    trace.enable(True)
    try:
        yield
    finally:
        trace.enable(False)
        trace.reset()


def _checks(steps: int) -> int:
    """Reads of all(done) by a ``batched_cg`` loop that ran ``steps`` steps
    and stopped at a check point: one at each check point up to it."""
    k, n = 0, 1
    while k < steps:
        k = max(1, k + min(k, cg_mod._CHECK_EVERY))
        n += 1
    assert k == steps, "a loop that stops early stops at a check point"
    return n


def _chunks(lanes: int) -> list:
    return [(a, min(a + MAX_BATCH, lanes))
            for a in range(0, lanes, MAX_BATCH)]


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def _fit(prob):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mt.muse_fit(mt.MuseResult(), prob, 0.5, nsims=NSIMS,
                           max_batch=MAX_BATCH, maxsteps=MAXSTEPS,
                           theta_rtol=1e-4, alpha=1.0, seed=1)


def test_off_a_span_is_one_shared_object_and_records_nothing():
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")
    trace.reset()
    _fit(grf_spectral_problem(n=N, sigma_noise=0.1, device="cpu"))
    assert trace.summary()["spans"] == {}


def test_spans_do_not_change_the_fit(spans_on):
    on = _fit(grf_spectral_problem(n=N, sigma_noise=0.1, device="cpu"))
    trace.enable(False)
    off = _fit(grf_spectral_problem(n=N, sigma_noise=0.1, device="cpu"))
    assert np.array_equal(on.theta, off.theta)
    assert len(on.history) == len(off.history)


COUNTERS = {
    "batched_cg.steps", "batched_cg.curvature_steps",
    "batched_cg.host_syncs",
    "batched_lbfgs.iterations", "batched_lbfgs.ls_evaluations",
    "batched_lbfgs.host_syncs", "batched_varpro.iterations",
    "batched_varpro.ls_trials", "batched_varpro.inner_steps",
    "batched_varpro.host_syncs", "batched_newton_cg.iterations",
    "batched_newton_cg.cg_steps", "batched_newton_cg.hvps",
    "batched_newton_cg.host_syncs", "zhat_varpro.polish_entries",
    "zhat_varpro.polished_lanes", "zhat_varpro.frozen_lanes",
    "spectrum_quadform_cuda.launches",
    "spectrum_quadforms_cuda.launches",
    "spectrum_quadform_and_grad_cuda.launches",
    "SpectrumQuadform.evaluations", "SpectrumQuadforms.evaluations",
    "herm_white_cuda.launches", "lens_expand_cuda.launches",
    "lens_combine_cuda.launches", "lens_residual_cuda.launches",
    "lens_spread_cuda.launches", "lens_contract_cuda.launches",
    "diag_pcg_start_cuda.launches", "diag_pcg_update_cuda.launches",
    "diag_pcg_direction_cuda.launches", "sample_whites.batched_lanes",
    "sample_whites.looped_lanes", "muse_fit.host_syncs",
    "get_J.host_syncs", "get_H.host_syncs",
    "finalize_result.host_syncs", "grf_spectral_problem.host_syncs",
    "sample_batch.looped_lanes", "h_fd.lanes",
    "grf_field_problem.host_syncs"}


_FRESH = ("import json; from muse_tpu_torch.utils import trace; "
          "print(json.dumps(sorted(trace.counters())))")


@pytest.mark.parametrize("where", ["this process", "a fresh interpreter"])
def test_counters_list_every_counter(where):
    """Every site declares its counters, and importing the trace module
    alone (which imports the package first) declares them all."""
    if where == "this process":
        keys = set(trace.counters())
    else:
        out = subprocess.run([sys.executable, "-c", _FRESH], cwd=ROOT,
                             capture_output=True, text=True, check=True,
                             env={**os.environ, "PYTHONPATH": str(ROOT)})
        keys = set(json.loads(out.stdout.splitlines()[-1]))
    assert keys == COUNTERS


def test_trace_imports_no_layer_above_utils():
    """The bottom layer knows no site: ``utils/trace.py`` imports nothing
    of the package outside ``utils/``, at module level or in a function."""
    src = ROOT / "muse_tpu_torch" / "utils" / "trace.py"
    seen = []
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.ImportFrom):
            if node.level:     # relative to muse_tpu_torch.utils
                base = ["muse_tpu_torch", "utils"][:3 - node.level]
                mod = ".".join(base + ([node.module] if node.module else []))
                seen += [mod] if node.module else [
                    f"{mod}.{a.name}" for a in node.names]
            else:
                seen.append(node.module)
        elif isinstance(node, ast.Import):
            seen += [a.name for a in node.names]
    ours = [m for m in seen if m.split(".")[0] == "muse_tpu_torch"]
    assert all(m.startswith("muse_tpu_torch.utils.") for m in ours), ours


@pytest.mark.parametrize("maxiter,checks", [(1, 1), (3, 3), (20, 6),
                                            (30, 7)])
def test_cg_reads_done_at_each_check_point(maxiter, checks):
    """A loop that never converges (tol 0) runs out ``maxiter``: it reads
    all(done) at steps 0, 1, 2, 4, 8, 16, 24, … below it."""
    g = torch.Generator().manual_seed(maxiter)
    d = torch.rand((3, 16), generator=g) + 1.0
    b = torch.randn((3, 16), generator=g)
    c0 = trace.counters()
    res = batched_cg(lambda p: d * p, b, tol=0.0, maxiter=maxiter,
                     matvec_and_curvature=lambda p: (d * p,
                                                     (p * d * p).sum(-1)))
    c = _delta(c0, trace.counters())
    assert c["batched_cg.host_syncs"] == checks
    assert c["batched_cg.curvature_steps"] == maxiter
    assert c["batched_cg.steps"] == maxiter
    assert int(res.iterations.max()) == maxiter


@pytest.mark.parametrize("x_obs,reads", [("none", 2), ("packed", 4),
                                         ("field", 5)])
def test_build_counts_its_reads(x_obs, reads):
    """The packing weights and ``x_real``, and a tensor ``x_obs`` twice
    more (three times as a real field)."""
    base = grf_spectral_problem(n=N, sigma_noise=0.1, device="cpu")
    given = {"none": None, "packed": base.x,
             "field": torch.as_tensor(base.x_real, dtype=torch.float32)}
    c0 = trace.counters()
    grf_spectral_problem(n=N, sigma_noise=0.1, device="cpu",
                         x_obs=given[x_obs])
    c = _delta(c0, trace.counters())
    assert c["grf_spectral_problem.host_syncs"] == reads
    assert sum(v for k, v in c.items() if k.endswith(".host_syncs")) == reads


def test_a_pipeline_spans_and_syncs(spans_on):
    """muse_fit → get_J (new sims) → implicit get_H at n = 32, 8 sims in
    chunks of 4: span counts, parents against their children, and every
    ``host_syncs`` counter against the pipeline's structure."""
    c0 = trace.counters()
    prob = grf_spectral_problem(n=N, sigma_noise=0.1, device="cpu")
    c1 = trace.counters()
    trace.reset()
    res = _fit(prob)
    fit = trace.summary()
    c_build, c_fit = _delta(c0, c1), _delta(c1, fit["counters"])
    its, fit_chunks = len(res.history), _chunks(NSIMS + 1)
    assert its >= 1
    spans = fit["spans"]
    assert spans["muse.fit"]["n"] == 1
    assert spans["muse.fit.step"]["n"] == its * len(fit_chunks)
    assert spans["muse.sample_whites"]["n"] == len(fit_chunks)
    for name in ("muse.step.x", "muse.step.solve", "muse.step.score"):
        assert spans[name]["n"] == its * len(fit_chunks)

    def s(name):
        return spans[name]["s"]
    assert s("muse.fit") >= (s("muse.fit.step") + s("muse.fit.read")
                             + s("muse.fit.update") + s("muse.build.compiled")
                             + s("muse.sample_whites"))
    assert s("muse.fit.step") >= (s("muse.step.x") + s("muse.step.solve")
                                  + s("muse.step.score"))

    # θ₀'s transform, then five reads a chunk and four for the update
    assert c_fit["muse_fit.host_syncs"] == 1 + its * (5 * len(fit_chunks)
                                                      + 4)
    assert c_build["grf_spectral_problem.host_syncs"] == 2
    # one PCG a chunk and iteration, stopped at the check point after its
    # slowest lane
    pcg = [_checks(int(h["map_iterations"][a:b].max()))
           for h in res.history for a, b in fit_chunks]
    assert c_fit["batched_cg.host_syncs"] == sum(pcg)

    c1 = trace.counters()
    trace.reset()
    mt.get_J(res, prob, nsims=NSIMS_J, max_batch=MAX_BATCH,
             warn_reuse=False)
    c_J = _delta(c1, trace.counters())
    j_chunks = _chunks(NSIMS_J - NSIMS)
    assert len(j_chunks) == 1
    assert c_J["get_J.host_syncs"] == 3 * len(j_chunks)
    assert c_J["batched_cg.host_syncs"] == _checks(
        c_J["batched_cg.curvature_steps"])
    assert c_J["finalize_result.host_syncs"] == 0        # no H yet
    assert trace.summary()["spans"]["muse.get_J"]["n"] == 1

    c2 = trace.counters()
    trace.reset()
    mt.get_H(res, prob, nsims=NSIMS_H, max_batch=MAX_BATCH,
             implicit_diff=True,
             implicit_diff_precond=prob.suggested_h_precond)
    h = trace.summary()
    c_H = _delta(c2, h["counters"])
    h_chunks = _chunks(NSIMS_H)
    spans = h["spans"]
    assert spans["muse.sample_whites"]["n"] == len(h_chunks)
    for name in ("muse.h.maps", "muse.h.jac", "muse.h.cg",
                 "muse.get_H.read"):
        assert spans[name]["n"] == len(h_chunks)
    assert s("muse.get_H") >= (s("muse.h.maps") + s("muse.h.jac")
                               + s("muse.h.cg") + s("muse.get_H.read")
                               + s("muse.sample_whites"))
    assert c_H["get_H.host_syncs"] == 2 * len(h_chunks)
    assert c_H["finalize_result.host_syncs"] == 1
    # each chunk's fiducial PCG takes at most one step with the exact
    # preconditioner (its steps are the curvature steps), and the HVP CG
    # with the exact A⁻¹ one
    assert c_H["batched_cg.curvature_steps"] <= len(h_chunks)
    assert c_H["batched_cg.host_syncs"] == (
        len(h_chunks) + c_H["batched_cg.curvature_steps"]
        + _checks(1) * len(h_chunks))
    # the fit's and H's reads are every read of the pipeline
    for c, site in ((c_fit, "muse_fit"), (c_J, "get_J"), (c_H, "get_H")):
        assert {k for k, v in c.items()
                if k.endswith(".host_syncs") and v} <= {
            f"{site}.host_syncs", "batched_cg.host_syncs",
            "finalize_result.host_syncs"}


def test_the_keyed_route_spans_and_counts(spans_on):
    """The field GRF (no white split) at n = 32, 8 sims in one chunk:
    every outer iteration's keyed step draws all its lanes one generator
    at a time inside ``muse.step.sample``; get_J reuses the fit's scores;
    FD get_H draws its fiducial lanes and its ±ε stencil there too, inside
    ``muse.h.fiducial`` and ``muse.h.fd``. The build reads a tensor
    ``x_obs`` once and nothing otherwise."""
    from muse_tpu_torch.models import grf_field_problem

    c0 = trace.counters()
    base = grf_field_problem(n=N, sigma_noise=0.1, device="cpu")
    c1 = trace.counters()
    prob = grf_field_problem(n=N, sigma_noise=0.1, device="cpu",
                             x_obs=base.x)
    c2 = trace.counters()
    assert _delta(c0, c1)["grf_field_problem.host_syncs"] == 0
    assert _delta(c1, c2)["grf_field_problem.host_syncs"] == 1
    assert trace.summary()["spans"]["muse.build.problem"]["n"] == 2
    trace.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = mt.muse_fit(mt.MuseResult(), prob, 0.5, nsims=NSIMS,
                          maxsteps=MAXSTEPS, theta_rtol=1e-4, seed=1)
        mt.get_J(res, prob, nsims=NSIMS, warn_reuse=False)
        mt.get_H(res, prob, nsims=NSIMS_H)
    s = trace.summary()
    c = _delta(c2, s["counters"])
    its = len(res.history)
    spans = s["spans"]
    assert spans["muse.fit.step"]["n"] == its
    assert spans["muse.step.sample"]["n"] == its + 2
    assert spans["muse.h.fiducial"]["n"] == spans["muse.h.fd"]["n"] == 1
    assert "muse.sample_whites" not in spans
    assert c["sample_batch.looped_lanes"] == (its * (NSIMS + 1) + NSIMS_H
                                              + 2 * NSIMS_H)
    assert c["h_fd.lanes"] == 2 * NSIMS_H
    assert c["sample_whites.looped_lanes"] == 0
    assert s["spans"]["muse.get_H"]["s"] >= (spans["muse.h.fiducial"]["s"]
                                             + spans["muse.h.fd"]["s"])
