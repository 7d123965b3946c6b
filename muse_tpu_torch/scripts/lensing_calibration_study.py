"""Frequentist σθ calibration of the lensing demo's configuration.

The port of scripts/lensing_calibration_study.py. On ``--reps`` independent
data realizations it runs the lensing demo's pipeline (the n ≥ 256 branch
of examples/lensing_demo.py): ``muse_fit`` from the Wiener warm start with
alpha 0.3, Broyden H⁻¹ updates and the ±0.3 step clamp, then ``get_J``
reusing the fit's scores and implicit-diff ``get_H`` with the model's
preconditioner. It prints one JSON row per realization (θ̂ ± σ, the z-score,
iterations, wall) and a summary: coverage, bias and σ against the scatter
of θ̂. Realization ``rep`` draws its data from ``data_seed=100+rep`` and its
sims from ``seed=1000+rep`` with the port's generators, so these are other
realizations of the configuration than the JAX script's.

Run:  python -m muse_tpu_torch.scripts.lensing_calibration_study --n 256 --nsims 16 --reps 8
      (add --device cpu to run on the CPU, at a small --n)
"""

import argparse
import json
import time

import numpy as np

from muse_tpu_torch import MuseResult, get_H, get_J, muse_fit
from muse_tpu_torch.models import lensing_problem
from muse_tpu_torch.utils import resolve_device, synchronize


def run_one(rep, n, nsims, theta_true, theta_rtol=3e-4, maxsteps=30,
            grad_z_atol=3e-3, device="cuda"):
    """One realization's θ̂ ± σ, z-score, iterations and wall."""
    dev = resolve_device(device)
    prob = lensing_problem(n=n, theta_true=theta_true, data_seed=100 + rep,
                           device=dev)
    prev = {"v": np.zeros(1)}

    def clamp_step(th_t):
        th_t = np.clip(th_t, prev["v"] - 0.3, prev["v"] + 0.3)
        prev["v"] = np.asarray(th_t)
        return th_t

    synchronize(dev)
    t0 = time.perf_counter()
    res = MuseResult()
    # theta_rtol 3e-4: at looser values the σ-scaled step test passes on
    # the small damped steps of the march towards the root, and the fit
    # stops short of it
    muse_fit(res, prob, 0.0, nsims=nsims, z0=prob.suggested_z0,
             alpha=0.3, Hinv_update="broyden", regularize=clamp_step,
             grad_z_atol=grad_z_atol, theta_rtol=theta_rtol,
             maxsteps=maxsteps, max_batch=9, seed=1000 + rep)
    get_J(res, prob, nsims=nsims, grad_z_atol=grad_z_atol, max_batch=9,
          warn_reuse=False, skip_errors=True, seed=1000 + rep)
    get_H(res, prob, nsims=max(8, nsims // 8), implicit_diff=True,
          implicit_diff_precond=prob.suggested_h_precond,
          implicit_fit_atol=1e-3, max_batch=9, seed=1000 + rep)
    synchronize(dev)
    wall = time.perf_counter() - t0
    th, sig = float(res.theta[0]), float(res.sigma[0])
    return {"rep": rep, "theta_hat": th, "sigma": sig,
            "z": (th - theta_true) / sig, "iters": len(res.history),
            "wall_s": wall}


def summarize(rows, args):
    """The study's summary over its rows (the JAX script's keys)."""
    th = np.array([r["theta_hat"] for r in rows])
    sig = np.array([r["sigma"] for r in rows])
    z = np.array([r["z"] for r in rows])
    scatter = float(th.std(ddof=1))
    return {
        "summary": True, "n": args.n, "nsims": args.nsims,
        "reps": args.reps, "theta_true": args.theta_true,
        "theta_rtol": args.theta_rtol, "grad_z_atol": args.grad_z_atol,
        "mean_theta": float(th.mean()), "std_theta": scatter,
        "max_abs_z": float(np.abs(z).max()),
        "coverage_1.96": float(np.mean(np.abs(z) < 1.96)),
        "bias_over_se": float(np.mean(th - args.theta_true)
                              / (scatter / np.sqrt(len(th)))),
        # σ calibration: the reported σ against the scatter of θ̂ across
        # realizations (≈ 1 is calibrated)
        "median_sigma": float(np.median(sig)),
        "sigma_over_scatter": float(np.median(sig) / scatter),
        "diverged": int(np.sum(np.abs(th - args.theta_true) > 1.0)),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m muse_tpu_torch.scripts.lensing_calibration_study")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--nsims", type=int, default=16)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--theta-true", type=float, default=0.3)
    ap.add_argument("--theta-rtol", type=float, default=3e-4)
    # realizations [rep_start, rep_start + reps): rep k is the same data set
    # however the study is partitioned
    ap.add_argument("--rep-start", type=int, default=0)
    ap.add_argument("--maxsteps", type=int, default=30)
    ap.add_argument("--grad-z-atol", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fall back to the "
                         "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the study; prints each row and the summary, returns both."""
    args = parse_args(argv)
    rows = []
    for rep in range(args.rep_start, args.rep_start + args.reps):
        row = run_one(rep, args.n, args.nsims, args.theta_true,
                      theta_rtol=args.theta_rtol, maxsteps=args.maxsteps,
                      grad_z_atol=args.grad_z_atol, device=args.device)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = summarize(rows, args)
    print(json.dumps(summary), flush=True)
    return rows, summary


if __name__ == "__main__":
    main()
