"""A cell end to end on the CPU at a tiny size, through the kernels' plain
versions; and the run's refusal to start without a card."""

import io
import contextlib

import pytest

from benchmark import run
from benchmark.tests._tiny import run_tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_end_to_end(trace):
    rc, line, err = run_tiny(seed=2 ** 31 + 12345, seconds=1.0, trace=trace)
    assert rc == 0, err[-3000:]
    assert KEYS <= set(line) <= KEYS | {"breakdown", "checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    if trace:
        # the device's shares need a card: the CPU run reads the spans
        assert {"host_share", "outer_iters", "step_ms",
                "cg_steps"} <= set(line["metrics"])
        assert "busy_s" in line["device"] and "window_s" in line["device"]
    else:
        assert {"setup_s", "fit_s", "fit_p90_s"} <= set(line["metrics"])
    # each number compared is printed beside its limit, last on stderr
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[0] for t in tail] == list(line["checks"])


def test_only_the_checked_pipelines_keep_their_bulk():
    import numpy as np
    walls = [1.0, 3.0, 2.0, 5.0, 1.5, 0.5, 4.0, 1.0, 2.5, 0.7]
    picker = run._Picker(np.random.default_rng(7), 4)
    outs = []
    for k, _ in enumerate(walls):
        outs.append({"bulk": k})
        picker.add(k, outs, walls)
        held = [j for j, o in enumerate(outs) if "bulk" in o]
        assert held == picker.picked() and len(held) <= 4
    assert picker.longest == 3 and 3 in picker.picked()
    again = run._Picker(np.random.default_rng(7), 4)
    outs2 = []
    for k, _ in enumerate(walls):
        outs2.append({"bulk": k})
        again.add(k, outs2, walls)
    assert again.picked() == picker.picked()


def test_same_seed_same_inputs():
    import torch
    from benchmark.models import grf_spectral
    cfg = run.cell_spec("grf_spectral_1024.sims512")["config"]
    cfg["n"] = 16
    a = grf_spectral.make_pool(cfg, 2 ** 31 + 7, 3, "cpu")
    b = grf_spectral.make_pool(cfg, 2 ** 31 + 7, 3, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, grf_spectral.make_pool(cfg, 8, 3, "cpu"))


def test_refuses_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", "grf_spectral_1024.sims512", "--seed",
                       "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of each cell on the card: correct, with every metric."""
    import subprocess
    import sys
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json
    for w in run._load(run.ROOT / "BENCHMARK.json")["workloads"]:
        out = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload", w["name"],
             "--seed", "2147483999", "--seconds", "5", "--trace", "0"],
            cwd=run.ROOT, capture_output=True, text=True, timeout=900)
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, out.stderr[-3000:]
