"""North-star accuracy and wall-clock: the port of examples/northstar_grf.py.

512 sims × 1024² GRF amplitude inference at high SNR (σ_noise = 0.01,
≈30k informative modes) on one card: the full muse_fit → get_J (the fit's
scores reused) → implicit-diff get_H pipeline, checked against the EXACT
closed-form oracles (marginal MLE θ̂ and Fisher σ; MUSE is exact for this
Gaussian problem, arXiv:2112.09354 §2): |θ̂ − θ̂_MLE| < 1e-3 and
σ/σ_Fisher ≈ 1.

Run:  python -m muse_tpu_torch.examples.northstar_grf [--nsims 512 --n 1024]
      (add --device cpu to run on the CPU, at a small --n)
"""

import argparse
import time

import numpy as np

from muse_tpu_torch import MuseResult, ThetaSpec, get_H, get_J, muse_fit
from muse_tpu_torch.models import (grf_marginal_mle, grf_problem,
                                   grf_spectral_problem)
from muse_tpu_torch.solver import CompiledProblem
from muse_tpu_torch.utils import resolve_device, synchronize


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--nsims", type=int, default=512)
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--representation", default="spectral",
                    choices=["spectral", "pixel"],
                    help="spectral (default): x/z in packed-Fourier "
                         "coordinates, no FFT in a muse iteration (the "
                         "fused kernel at every PCG step); pixel: the "
                         "pixel-space grf_problem (an rfft2/irfft2 pair "
                         "around each solve)")
    ap.add_argument("--repeat", action="store_true",
                    help="run the pipeline twice (one CompiledProblem) and "
                         "report the second, warm pass as well")
    ap.add_argument("--alpha", type=float, default=1.0,
                    help="outer Newton damping (reference default 0.7, "
                         "src/muse.jl:118). The sims-variance H⁻¹ is "
                         "near-exact for this Gaussian model, so undamped "
                         "Newton is safe and takes fewer iterations")
    ap.add_argument("--hinv", default="sims",
                    choices=["sims", "broyden", "diagonal_broyden"],
                    help="outer-loop H⁻¹ update (src/muse.jl:190-205)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fall back to "
                         "the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the demo; returns the last pass's accuracy numbers."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    build = (grf_spectral_problem if args.representation == "spectral"
             else grf_problem)
    prob = build(n=args.n, sigma_noise=0.01, solver="cg", data_seed=42,
                 device=dev)
    x_real = getattr(prob, "x_real", prob.x)
    mle, fisher_sig = grf_marginal_mle(x_real, prob.grf_config)

    spec = ThetaSpec.from_example(0.0)
    comp = CompiledProblem(prob, spec, spec.flatten(0.5))
    for _ in range(2 if args.repeat else 1):
        out = run(args, prob, comp, mle, fisher_sig)
    return out



def run(args, prob, comp, mle, fisher_sig):
    dev = comp.device
    synchronize(dev)
    t0 = time.perf_counter()
    res = MuseResult()
    # θ_rtol must support the accuracy target asserted below: the
    # convergence metric is the θ-step in σ units, so 1e-3 accuracy in a
    # σ≈8e-3 posterior needs steps driven well below 0.1σ
    muse_fit(res, prob, 0.5, nsims=args.nsims, max_batch=args.max_batch,
             theta_rtol=1e-5, Hinv_update=args.hinv, alpha=args.alpha,
             compiled=comp, seed=1)
    synchronize(dev)
    t_fit = time.perf_counter() - t0
    # the fit's scores reused: the calibrated design here, so the
    # defensive reuse warning is silenced
    get_J(res, prob, nsims=args.nsims, max_batch=args.max_batch,
          compiled=comp, seed=1, warn_reuse=False)
    synchronize(dev)
    t_j = time.perf_counter() - t0 - t_fit
    # the exact Fourier-diagonal z-Hessian inverse (the reference's Pl
    # hook, src/muse.jl:312) takes the per-column CG to O(1) iterations
    get_H(res, prob, nsims=max(8, args.nsims // 10), implicit_diff=True,
          implicit_diff_precond=prob.suggested_h_precond,
          max_batch=args.max_batch, compiled=comp, seed=1)
    synchronize(dev)
    t_total = time.perf_counter() - t0

    th, sig = float(res.theta[0]), float(res.sigma[0])
    # the 1e-3 target holds at the flagship size (1024², ≥512 sims), where
    # σ_Fisher ≈ 8e-3; at smaller sizes θ̂ and the MLE differ by the
    # MUSE-vs-MLE estimator gap, O(σ/√nsims), and the gate scales with it
    target = max(1e-3, 2.0 * fisher_sig / np.sqrt(args.nsims))
    print(f"θ̂ − θ̂_MLE(exact)  = {th - mle:+.2e}   (target < {target:.0e})")
    print(f"σ / σ_Fisher(exact) = {sig / fisher_sig:.4f}  (target ≈ 1)")
    print(f"J = {float(res.J[0, 0]):.0f}  H = {float(res.H[0, 0]):.0f} "
          f"(equal at θ̂ up to MC noise)")
    print(f"wall: fit {t_fit:.3f}s + J {t_j:.3f}s + H "
          f"{t_total - t_fit - t_j:.3f}s = {t_total:.3f}s "
          f"({len(res.history)} iterations, {args.nsims} sims, {args.n}², "
          f"{dev})", flush=True)
    assert abs(th - mle) < target, "accuracy target missed"
    assert 0.9 < sig / fisher_sig < 1.1, "σ target missed"
    return {"gap": th - mle, "target": target,
            "sigma_ratio": sig / fisher_sig, "wall_s": t_total,
            "iterations": len(res.history)}


if __name__ == "__main__":
    main()
