"""A cell cut to a size a CPU test can hold, and a run of it in-process."""

from __future__ import annotations

import contextlib
import io
import json

from benchmark import run

#: 64² fields, 32 sims in chunks of 16: the spectral GRF's fits converge at
#: this size (at 32² with 8 sims the sims-variance H⁻¹ can cycle)
TINY = {"n": 64, "max_batch": 16, "nsims": 32, "pool": 3,
        "check_pipelines": 2}


def tiny_spec(workload="grf_spectral_1024.sims512"):
    spec = run.cell_spec(workload)
    spec["config"]["n"] = TINY["n"]
    spec["config"]["fit"]["max_batch"] = TINY["max_batch"]
    spec["traffic"].update(nsims=TINY["nsims"], pool=TINY["pool"],
                           check_pipelines=TINY["check_pipelines"])
    return spec


def run_tiny(seed=12345, seconds=1.0, trace=0, spec=None):
    """Run a tiny cell on the CPU: (exit code, last stdout line parsed,
    stderr)."""
    spec = spec or tiny_spec()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", spec["cell"]["name"], "--seed",
                       str(seed), "--seconds", str(seconds), "--trace",
                       str(trace)], device="cpu", spec=spec)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
