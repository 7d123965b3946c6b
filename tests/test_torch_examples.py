"""The port's demos (``muse_tpu_torch/examples``) run end to end on the
CPU at tests/test_docs_execute.py's sizes and print their accuracy lines
inside its bounds: the north-star gap to the exact MLE, the lensing
z-score, MUSE against the exact marginal. Each runs as
``python -m muse_tpu_torch.examples.<name> --device cpu`` in a subprocess
whose environment has only the repo on ``PYTHONPATH``."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args,pattern,bound", [
    (["muse_vs_hmc", "--dim", "64", "--nsims", "16", "--hmc-samples", "300"],
     r"MUSE − exact = ([+-][\d.]+)", 0.5),
    (["lensing_demo", "--n", "16", "--nsims", "8"],
     r"z-score ([+-][\d.]+)", 3.5),
    (["northstar_grf", "--n", "64", "--nsims", "16", "--max-batch", "16"],
     r"θ̂ − θ̂_MLE\(exact\)  = ([+-][\d.e-]+)", 2e-2),
], ids=["muse_vs_hmc", "lensing_demo", "northstar_grf"])
def test_example_runs_on_the_cpu(args, pattern, bound):
    # one thread: the suite runs beside other workers on the same cores
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", f"muse_tpu_torch.examples.{args[0]}",
         *args[1:], "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    m = re.search(pattern, out.stdout)
    assert m, (pattern, out.stdout[-2000:])
    assert abs(float(m.group(1))) < bound, out.stdout[-1500:]
    assert "cpu" in out.stdout


def test_example_refuses_a_missing_card():
    """``--device cuda`` (the default) without a card raises; no demo
    falls back to the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "muse_tpu_torch.examples.muse_vs_hmc",
         "--dim", "8"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
