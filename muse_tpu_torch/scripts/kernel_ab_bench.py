"""End-to-end A/B of the CUDA quadform on the field GRF's muse step.

The port of scripts/pallas_ab_bench.py. ``grf_field_problem`` is the one
model family whose log-likelihood evaluates the spectrum quadform; its
per-lane θ-score in the muse step is analytic, ½Q/n² − ½Σw, with Q from
one ``spectrum_quadforms`` evaluation per batched score and no backward.
With ``use_pallas=True`` that evaluation launches the CUDA kernel once
per batched θ-score; with ``use_pallas=False`` the plain torch quadforms
run on the same device. This times the whole keyed ``muse_step`` both
ways through ``bench.time_step``, in turns (kernel, plain, plain,
kernel), and checks the counters: on a card one kernel launch per
evaluation, at least one evaluation per step with the kernel and none
with the plain version (on the CPU the kernel never launches; the
quadforms' evaluations are counted instead).

Run:  python -m muse_tpu_torch.scripts.kernel_ab_bench [--n 1024 --nsims 16]
      (add --device cpu to run on the CPU, at a small --n)
"""

import argparse

from muse_tpu_torch import bench
from muse_tpu_torch.models import grf_field_problem
from muse_tpu_torch.ops import grf_spectrum as gs
from muse_tpu_torch.solver import CompiledProblem
from muse_tpu_torch.theta import ThetaSpec
from muse_tpu_torch.utils import resolve_device


def ab_step(n, nsims, use_kernel, device="cuda"):
    """bench.time_step's arguments for the keyed muse_step of ``nsims``
    sims plus the data lane, with the kernel (``use_kernel``) or the plain
    quadform."""
    dev = resolve_device(device)
    prob = grf_field_problem(n=n, use_pallas=use_kernel, data_seed=42,
                             device=dev)
    spec = ThetaSpec.from_example(0.0)
    th0 = spec.flatten(0.0)
    comp = CompiledProblem(prob, spec, th0)
    return (comp, *bench.step_inputs(comp, th0, nsims))


def time_ab(n, nsims, reps=5, device="cuda"):
    """Each route's (median wall, spread, kernel launches, quadform
    evaluations), timed in turns (kernel, plain, plain, kernel): a route's
    wall is the mean of its two medians, its spread the larger of its two.
    Raises unless the kernel route evaluated the quadforms in every step,
    launching it once per evaluation on a card and never on the CPU, and
    the plain route never evaluated it."""
    dev = resolve_device(device)
    steps = {True: ab_step(n, nsims, True, dev),
             False: ab_step(n, nsims, False, dev)}
    got = {True: [], False: []}
    for use_kernel in (True, False, False, True):
        # the counters' increase over the timed steps (a caller's own
        # counts keep running)
        launches = -gs.spectrum_quadforms_cuda.launches
        evaluations = -gs.SpectrumQuadforms.evaluations
        wall, spread = bench.time_step(*steps[use_kernel], reps=reps)
        launches += gs.spectrum_quadforms_cuda.launches
        evaluations += gs.SpectrumQuadforms.evaluations
        got[use_kernel].append((wall, spread, launches, evaluations))
    out = {}
    for use_kernel, runs in got.items():
        walls, spreads, launches, evaluations = zip(*runs)
        nsteps = 2 * (reps + 1)                 # warm passes and reps
        if use_kernel:
            ok = sum(evaluations) >= nsteps and sum(launches) == (
                sum(evaluations) if dev.type == "cuda" else 0)
        else:
            ok = sum(launches) == sum(evaluations) == 0
        if not ok:
            raise RuntimeError(
                f"use_pallas={use_kernel} on {dev}: {sum(launches)} kernel "
                f"launches and {sum(evaluations)} quadform evaluations in "
                f"{nsteps} steps")
        out["cuda" if use_kernel else "plain"] = {
            "wall_s": sum(walls) / 2, "spread": max(spreads),
            "walls_s": list(walls), "launches": sum(launches),
            "evaluations": sum(evaluations), "steps": nsteps}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m muse_tpu_torch.scripts.kernel_ab_bench")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--nsims", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fall back to the "
                         "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    """Time both routes; prints the walls and cuda/plain and returns them."""
    args = parse_args(argv)
    out = time_ab(args.n, args.nsims, device=args.device)
    for name in ("cuda", "plain"):
        r = out[name]
        print(f"{name:5s}: {r['wall_s']} s/muse_step ({args.nsims} sims x "
              f"{args.n}^2; medians {r['walls_s']}, spread {r['spread']}; "
              f"{r['launches']} kernel launches, {r['evaluations']} "
              f"quadform evaluations in {r['steps']} steps)", flush=True)
    out["ratio"] = out["cuda"]["wall_s"] / out["plain"]["wall_s"]
    print(f"cuda/plain = {out['ratio']}", flush=True)
    return out


if __name__ == "__main__":
    main()
