"""CMB-lensing-style amplitude inference: the port of examples/lensing_demo.py.

Infers the lensing-potential log-amplitude θ = log A_φ from one observed
lensed map, marginalizing over the ~2n²-dimensional joint latent (unlensed
field + potential), then builds the Gaussianized posterior θ̂ ± σ with
get_J and implicit-diff get_H with the model's Fourier CG preconditioner.
The latent MAPs are batched variable projection with a Newton-CG polish
(``ops/varpro.py``, ``ops/newton_cg.py``).

Run:  python -m muse_tpu_torch.examples.lensing_demo [--n 1024 --nsims 64]
      (add --device cpu to run on the CPU, at a small --n)
"""

import argparse
import time

import numpy as np

from muse_tpu_torch import MuseResult, get_H, get_J, muse_fit
from muse_tpu_torch.models import lensing_problem
from muse_tpu_torch.utils import resolve_device, synchronize


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--nsims", type=int, default=32)
    ap.add_argument("--theta-true", type=float, default=0.3)
    ap.add_argument("--progress", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fall back to "
                         "the CPU)")
    return ap.parse_args(argv)



def main(argv=None):
    """Run the demo; returns θ̂, σ, the z-score and the walls."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    prob = lensing_problem(n=args.n, theta_true=args.theta_true,
                           data_seed=7, device=dev)

    # the trust-region guard for a log-amplitude: clamp each θ-step to
    # ±0.3, which keeps θ out of the strongly-lensed regime where
    # lockstep MAPs grind at the float32 resolution floor
    prev_th = {"v": np.zeros(1)}           # θ₀ of the fit below

    def clamp_step(th_t):
        th_t = np.clip(th_t, prev_th["v"] - 0.3, prev_th["v"] + 0.3)
        prev_th["v"] = np.asarray(th_t)
        return th_t

    # Flagship sizes (n ≥ 256) take the robust outer loop of the JAX demo:
    # Broyden secant updates of H⁻¹ (src/muse.jl:192-205; the sims-variance
    # H⁻¹ underestimates the score's slope far from the root, and undamped
    # steps limit-cycle against the clamp), the clamp above, MAPs to 3e-3
    # (so per-sim basin hopping does not make the CRN score ragged in θ)
    # and theta_rtol 3e-4 (the σ-scaled step test passes on small damped
    # steps far from the root at looser values). The whole nsims + 1 lanes
    # run as one chunk: on an H100 65 lanes × 1024² take 14.3 GiB and the
    # least seconds per lane of the widths 3-65 (chip_smoke phase 12).
    big = args.n >= 256
    atol = 3e-3 if big else 1e-2
    synchronize(dev)
    t0 = time.perf_counter()
    res = MuseResult()
    muse_fit(res, prob, 0.0, nsims=args.nsims, z0=prob.suggested_z0,
             alpha=(0.4 if not big else 0.3),
             Hinv_update=("sims" if not big else "broyden"),
             regularize=(None if not big else clamp_step),
             grad_z_atol=atol, theta_rtol=(1e-1 if not big else 3e-4),
             maxsteps=(50 if not big else 30), seed=1,
             progress=args.progress)
    synchronize(dev)
    t_fit = time.perf_counter() - t0

    # the fit's scores reused (no reuse warning); skip_errors drops a
    # straggler MAP's score from J with a warning
    get_J(res, prob, nsims=args.nsims, grad_z_atol=atol, warn_reuse=False,
          skip_errors=True, seed=1, progress=args.progress)
    # ≥ 8 H-sims: with 4 the scalar H swings by tens of percent between
    # data sets and σ inherits the noise
    get_H(res, prob, nsims=max(8, args.nsims // 8), implicit_diff=True,
          implicit_diff_precond=prob.suggested_h_precond,
          implicit_fit_atol=(1e-2 if not big else 1e-3), seed=1,
          progress=args.progress)
    synchronize(dev)
    t_total = time.perf_counter() - t0

    th, sig = float(res.theta[0]), float(res.sigma[0])
    z = (th - args.theta_true) / sig
    print(f"\nθ_true = {args.theta_true}")
    print(f"θ̂ ± σ  = {th:.4f} ± {sig:.4f}   (z-score {z:+.2f})")
    print(f"fit {t_fit:.2f}s, total incl. J+H {t_total:.2f}s "
          f"({len(res.history)} MUSE iterations, {args.nsims} sims, "
          f"{args.n}² × 2 latent, {dev})", flush=True)
    assert abs(z) < 3, "recovery outside 3σ — investigate"
    return {"theta": th, "sigma": sig, "z": z, "fit_s": t_fit,
            "wall_s": t_total, "iterations": len(res.history)}


if __name__ == "__main__":
    main()
