"""Headline benchmark: wall-clock per MUSE iteration, 100 sims, 1024² latent.

Counterpart of the repo-root ``bench.py`` (muse_tpu, JAX), with the same
functions under the same names, the same six models, flags and JSON line.
It times one warm MUSE iteration of ``nsims`` simulations plus the data
lane: ``muse_step_white`` when the problem declares the CRN white split
(the iteration ``muse_fit`` runs), else the keyed ``muse_step``.
``vs_baseline`` is measured on the same device: the reference's execution
model, distinct sims one at a time at B = 1 (src/muse.jl:169-176), against
the lockstep-batched step.

Run:  python -m muse_tpu_torch.bench [--model grf] [--grid 1024 --nsims 100]
      python -m muse_tpu_torch.bench --quick --device cpu

Prints ONE JSON line on stdout, with bench.py's keys and meanings plus
``value_spread`` and ``reps``:
  {"metric": "muse_iteration_wall_s_100sims_1024sq", "value": ..., "unit":
   "s", "vs_baseline": ..., "baseline_per_sim_s": ..., "baseline_spread":
   ..., "certified": ..., "value_spread": ..., "reps": 5, ...}
Earlier lines, on stderr: the device (the card's name and power limit from
``nvidia-smi``) with the peak device memory of the timed step, and the
measured gaps of the check of the timed step. Numbers are printed
unrounded. ``--quick`` runs 128² and 16 sims unless ``--grid``/``--nsims``
say otherwise. ``--device`` defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .solver.compiled import CompiledProblem
from .theta import ThetaSpec
from .utils.device import resolve_device, synchronize
from .utils.keys import dummy_seed, lane_generator, sim_seeds
from .utils.tree import tree_map

__all__ = ["MODELS", "build", "step_inputs", "time_step",
           "check_timed_step", "time_sequential_baseline", "below_floor",
           "clamp_to_floor", "card_line", "main"]

MODELS = ("grf", "grf-pixel", "lensing", "funnel", "ppl", "bandpower")

# the noise margin of the physical-floor rule: a wall is taken as below the
# floor only when it is below by more than the larger of this share and the
# spread of the two measurements compared (a median of 5 can miss the floor
# by timer noise alone)
FLOOR_MARGIN = 0.05

# the certifier's tolerances (muse_tpu/solver/certify.py:114-115): the
# batched lane's objective may exceed the B = 1 re-solve's by at most
# OBJ_RTOL·max(|f_ref|, 1), and its ‖ẑ‖ differ by NORM_RTOL·(‖ẑ_ref‖ + 1)
OBJ_RTOL, NORM_RTOL = 0.05, 0.5
# and the θ-score that the timed step returns: the batched lane's g may
# differ from the re-solve's by G_RTOL of the re-solve's largest entry (the
# same draws and MAP; float32 sums in another order)
G_RTOL = 1e-3


def _ppl_model(d: int):
    """bench.py's three-site hierarchical model: the funnel's math through
    the PPL's effect handlers and bijectors."""
    from . import ppl
    from .distributions import Normal

    def model():
        th = ppl.sample("theta", Normal(0.0, 3.0))
        z = ppl.sample("z", Normal(0.0, torch.exp(th / 2)).expand((d,)))
        ppl.sample("x", Normal(z, 1.0))
    return model


def step_inputs(comp, th0, nsims: int, seed: int = 0):
    """(th, seeds_all, Z, lane_ids, atol) of one iteration of ``nsims``
    sims at flat θ₀: bench.py:93-100's layout. Lane 0 (the data lane) takes
    ``dummy_seed(seed)``, lanes 1..nsims ``sim_seeds(seed, nsims)``
    (``utils/keys.py``); Z starts at zeros and atol is 1e-2."""
    dev = comp.device
    seeds_all = [dummy_seed(seed)] + sim_seeds(seed, nsims)
    Z = torch.zeros((nsims + 1, comp.nz), dtype=comp.dtype, device=dev)
    lane_ids = torch.arange(nsims + 1, device=dev)
    return comp.theta(th0), seeds_all, Z, lane_ids, 1e-2


def build(n_grid, nsims, seed=0, model="grf", noise=None, nbands=12,
          device="cuda", x_obs=None):
    """(comp, th, seeds_all, Z, lane_ids, atol) of bench.py:32-102 for
    ``model``: the data drawn from ``data_seed=42`` (the port's counterpart
    of ``PRNGKey(42)``) unless ``x_obs`` (the PPL: the observed dict) hands
    them over, θ₀ = 0."""
    from .models import (bandpower_problem, funnel_problem, grf_problem,
                         grf_spectral_problem, lensing_problem)

    dev = resolve_device(device)
    theta_example = 0.0
    if model == "grf":
        # the packed-spectral representation is the flagship GRF path:
        # no FFT in an iteration, the fused kernel at every PCG step
        kw = {} if noise is None else {"noise": noise}
        prob = grf_spectral_problem(n=n_grid, solver="cg", data_seed=42,
                                    x_obs=x_obs, device=dev, **kw)
    elif model == "grf-pixel":
        prob = grf_problem(n=n_grid, solver="cg", data_seed=42, x_obs=x_obs,
                           device=dev)
    elif model == "lensing":
        prob = lensing_problem(n_grid, data_seed=42, x_obs=x_obs, device=dev)
    elif model == "bandpower":
        # many-band vector θ (the pmap_over=:jac regime the reference
        # special-cases at src/muse.jl:329-333)
        prob = bandpower_problem(n=n_grid, nbands=nbands, data_seed=42,
                                 x_obs=x_obs, device=dev)
        theta_example = np.zeros(nbands)
    elif model == "funnel":
        prob = funnel_problem(n_grid, data_seed=42, x_obs=x_obs, device=dev)
    elif model == "ppl":
        # the funnel through the PPL adapter: measures its overhead over
        # raw closures
        from . import ppl
        fn = _ppl_model(n_grid)
        theta_example = {"theta": 0.0}
        if x_obs is None:
            tmp = ppl.PPLMuseProblem(
                fn, observed={"x": torch.zeros(n_grid, device=dev)})
            x_obs, _ = tmp.sample_x_z(lane_generator(42, dev), theta_example)
        prob = ppl.model_problem(fn, theta_example, observed=x_obs,
                                 device=dev)
    else:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    spec = ThetaSpec.from_example(theta_example)
    th0 = spec.flatten(theta_example)
    comp = CompiledProblem(prob, spec, th0)
    return (comp, *step_inputs(comp, th0, nsims, seed))


def _chunks(n: int, max_batch):
    """The lane slices of one iteration at ``max_batch`` lanes a call, as
    ``muse_fit`` chunks them: the last chunk is smaller, not padded."""
    w = n if max_batch is None or max_batch >= n else max_batch
    return [slice(a, min(a + w, n)) for a in range(0, n, w)]


def _lanes(W_all, sl):
    """Lanes ``sl`` of the hoisted whites (a tuple of parts, None where the
    iteration reads no part)."""
    return tuple(None if w is None else tree_map(lambda a: a[sl], w)
                 for w in W_all)


def time_step(comp, th, seeds_all, Z, lane_ids, atol, reps=5,
              max_batch=None, W_all=None):
    """(median wall, spread) of ``reps`` iterations after one untimed warm
    pass; spread = (max − min)/median.

    One iteration is the serial sum over the ``max_batch`` chunks of the
    lanes, as ``muse_fit`` runs them. The device is synchronised before each
    clock read, so a wall times the work and not its enqueueing. ``W_all``
    (the hoisted whites of ``comp.sample_whites``) times ``muse_step_white``,
    else the keyed ``muse_step`` runs."""
    if W_all is None:
        step, draws = comp.muse_step, lambda sl: seeds_all[sl]
    else:
        step, draws = comp.muse_step_white, lambda sl: _lanes(W_all, sl)
    chunks = [(draws(sl), Z[sl], lane_ids[sl])
              for sl in _chunks(len(seeds_all), max_batch)]
    for kc, zc, lc in chunks:                       # warm
        step(th, th, kc, zc, lc, atol)
    walls = []
    for _ in range(reps):
        synchronize(comp.device)
        t0 = time.perf_counter()
        for kc, zc, lc in chunks:
            step(th, th, kc, zc, lc, atol)
        synchronize(comp.device)
        walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    return med, (max(walls) - min(walls)) / med


def _checked_chunks(n: int, max_batch):
    """The chunks :func:`check_timed_step` re-solves: the first, and the
    last where it is narrower (the one other width the timed step runs)."""
    chunks = _chunks(n, max_batch)
    first, last = chunks[0], chunks[-1]
    narrower = last.stop - last.start < first.stop - first.start
    return [first, last] if narrower else [first]


def check_timed_step(comp, th, seeds_all, Z, lane_ids, atol, max_batch=None,
                     W_all=None, outs=None):
    """Check the step that is timed against B = 1 re-solves: the port's
    counterpart of bench.py's ``certify_timed_step``, whose certifier is
    left out on purpose. Returns (verdict, the measured gaps).

    The first chunk is checked, and the last where it is narrower (the
    timed widths). Two lanes of each, the chunk's first sim lane and its
    last lane (the data lane at width 1), are re-solved one at a time
    with the keyed ``muse_step`` from the same seed and Z₀. Each lane's
    objective −log_like and ‖ẑ‖ are held against the re-solve's at
    ``certify.py:114-115``'s tolerances: the objective one-sided, at most
    OBJ_RTOL·max(|f_ref|, 1) above; the norm |Δ‖ẑ‖| ≤ NORM_RTOL·(‖ẑ_ref‖ +
    1). Its θ-score g, what the iteration returns, is held at
    max|Δg| ≤ G_RTOL·max|g_ref|, and its convergence flag must be the
    re-solve's. This runs at every width, so a hoisted step is compared
    with the keyed one at width 1 too. ``outs`` are the checked chunks'
    batched outputs (default: each chunk's step, run here)."""
    checked = _checked_chunks(len(seeds_all), max_batch)
    ok, gaps = True, []
    for i, w in enumerate(checked):
        if outs is not None:
            out = outs[i]
        elif W_all is None:
            out = comp.muse_step(th, th, seeds_all[w], Z[w], lane_ids[w],
                                 atol)
        else:
            out = comp.muse_step_white(th, th, _lanes(W_all, w), Z[w],
                                       lane_ids[w], atol)
        last = w.stop - 1
        first_sim = w.start + int(int(lane_ids[w.start]) == 0)
        for j in sorted({min(first_sim, last), last}):
            one = slice(j, j + 1)
            ref = comp.muse_step(th, th, seeds_all[one], Z[one],
                                 lane_ids[one], atol)
            z_b, g_b = out["Z"][j - w.start], out["g"][j - w.start]
            z_r, g_r = ref["Z"][0], ref["g"][0]
            x = (comp.x_obs if int(lane_ids[j]) == 0
                 else comp._sample_flat(seeds_all[j], th)[0])
            f_b, f_r = (float(-comp._ll(x, z, th)) for z in (z_b, z_r))
            n_b, n_r = (float(torch.linalg.vector_norm(z.double()))
                        for z in (z_b, z_r))
            g_scale = max(float(g_r.double().abs().max()), 1e-30)
            gap = {"lane": j, "objective": (f_b - f_r) / max(abs(f_r), 1.0),
                   "norm": abs(n_b - n_r) / (n_r + 1.0),
                   "g": float((g_b.double() - g_r.double()).abs().max())
                   / g_scale,
                   "converged": (bool(out["converged"][j - w.start]),
                                 bool(ref["converged"][0]))}
            gaps.append(gap)
            ok = ok and (math.isfinite(f_b) and gap["objective"] <= OBJ_RTOL
                         and gap["norm"] <= NORM_RTOL
                         and gap["g"] <= G_RTOL
                         and gap["converged"][0] == gap["converged"][1])
    return ok, gaps


def time_sequential_baseline(n_grid, model, nlanes=8, reps=5, nbands=12,
                             device="cuda"):
    """The reference's execution model on the same device: ``nlanes``
    distinct sims, one at a time, each a keyed ``muse_step`` at B = 1 with
    lane id 1 (a sim lane, not the data lane), the device drained after
    each (src/muse.jl:169-176). One untimed warm pass, then ``reps``
    passes; returns (mean seconds per sim, spread), spread = (max −
    min)/mean over the passes."""
    comp, th, seeds_all, Z, lane_ids, atol = build(
        n_grid, nlanes, model=model, nbands=nbands, device=device)
    one, Z1 = lane_ids[1:2], Z[:1]

    def one_pass():
        for s in seeds_all[1:]:
            comp.muse_step(th, th, [s], Z1, one, atol)
            synchronize(comp.device)

    one_pass()                                     # warm
    per_sim = []
    for _ in range(reps):
        synchronize(comp.device)
        t0 = time.perf_counter()
        one_pass()
        per_sim.append((time.perf_counter() - t0) / nlanes)
    mean = sum(per_sim) / len(per_sim)
    return mean, (max(per_sim) - min(per_sim)) / mean


def below_floor(t, floor_one, spread=0.0) -> bool:
    """``t`` is below the physical floor by more than the noise margin: the
    larger of FLOOR_MARGIN and ``spread`` (the measurements' own)."""
    return t < floor_one * (1.0 - max(FLOOR_MARGIN, spread))


def clamp_to_floor(t, spread, floor_one, floor_spread=0.0):
    """(wall, its spread or None, clamped) after the floor rule: a wall
    below ``floor_one`` by more than the margin (:func:`below_floor`, with
    the larger of the two spreads) is clamped to it, and its spread, that
    of a discarded measurement, is dropped; any other wall is kept with
    its spread."""
    if below_floor(t, floor_one, max(spread, floor_spread)):
        return floor_one, None, True
    return t, spread, False


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or the CPU's name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"{dev.type} (no card)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[dev.index or 0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m muse_tpu_torch.bench")
    ap.add_argument("--grid", type=int, default=None,
                    help="latent grid n (n² field; the funnel and the PPL "
                         "take n dimensions); default 1024, 128 with "
                         "--quick")
    ap.add_argument("--nsims", type=int, default=None,
                    help="sims besides the data lane; default 100, 16 with "
                         "--quick")
    ap.add_argument("--model", default="grf", choices=MODELS)
    ap.add_argument("--nbands", type=int, default=12,
                    help="θ components for --model bandpower")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="time the iteration chunked at this lane width "
                         "(the solver's max_batch execution model)")
    ap.add_argument("--quick", action="store_true",
                    help="128² and 16 sims (unless --grid/--nsims are given)")
    ap.add_argument("--no-hoist", action="store_true",
                    help="time the keyed muse_step even when the problem "
                         "declares the CRN white split (muse_fit's "
                         "hoist_sampling=False path)")
    ap.add_argument("--baseline-lanes", type=int, default=8,
                    help="distinct sims measured one at a time for the "
                         "sequential baseline (at least 8)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed passes of each measurement, after one "
                         "untimed warm pass")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fall back to the "
                         "CPU)")
    args = ap.parse_args(argv)
    if args.grid is None:
        args.grid = 128 if args.quick else 1024
    if args.nsims is None:
        args.nsims = 16 if args.quick else 100
    return args


def _note(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    """Run the benchmark; prints its JSON line and returns it as a dict.

    bench.py:276-285 defaults lensing at 1024² to ``--max-batch 3``, a
    width that routes around a TPU miscompile of other batch widths. The
    port has no such fault: on an H100 the 1024² lensing iteration runs at
    65 lanes a chunk, peaking at 14.32 GiB (chip_smoke phase 12, NVIDIA
    H100 80GB HBM3, 700 W), so all nsims + 1 lanes run in one call unless
    ``--max-batch`` says otherwise."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    nlanes = max(8, args.baseline_lanes)
    comp, th, seeds_all, Z, lane_ids, atol = build(
        args.grid, args.nsims, model=args.model, nbands=args.nbands,
        device=dev)

    # the hoisted CRN whites: muse_fit's iteration when the problem declares
    # the split, drawn once per fit (only the parts x reads, as muse_fit
    # keeps them), so the steady-state wall excludes the RNG
    W_all = None
    if not args.no_hoist and comp.problem.x_of_white is not None:
        W_all = comp.sample_whites(seeds_all, x_only=True)

    certified, gaps = check_timed_step(comp, th, seeds_all, Z, lane_ids,
                                       atol, max_batch=args.max_batch,
                                       W_all=W_all)
    for g in gaps:
        _note(f"# check of the timed step, lane {g['lane']} against its "
              f"keyed B=1 re-solve: objective gap {g['objective']:.3e} "
              f"(≤ {OBJ_RTOL}), ‖ẑ‖ gap {g['norm']:.3e} (≤ {NORM_RTOL}), "
              f"θ-score gap {g['g']:.3e} (≤ {G_RTOL}), converged "
              f"{g['converged'][0]} (B=1: {g['converged'][1]})")
    if not certified:
        _note(f"# WARNING: the check FAILED for model={args.model} at the "
              "timed width: this row times wrong work")

    if dev.type == "cuda":
        synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) / 2 ** 30
    batched_s, value_spread = time_step(comp, th, seeds_all, Z, lane_ids,
                                        atol, reps=args.reps,
                                        max_batch=args.max_batch, W_all=W_all)
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30} GiB, of "
            f"which {held} GiB allocated before it (the problem, the whites "
            "and the caller's tensors)" if dev.type == "cuda"
            else "not measured")
    _note(f"# device: {card_line(dev)}; peak device memory of the timed "
          f"step {peak}")

    seq_one, seq_spread = time_sequential_baseline(
        args.grid, args.model, nlanes=nlanes, reps=args.reps,
        nbands=args.nbands, device=dev)

    # the physical floor: the batched step holds at least one sim's work.
    # Hoisted, it does less than the keyed B = 1 step (no RNG), so its
    # floor is a B = 1 run of the same hoisted program on a sim lane
    if W_all is None:
        floor_one, floor_spread = seq_one, seq_spread
    else:
        floor_one, floor_spread = time_step(
            comp, th, seeds_all[1:2], Z[1:2], lane_ids[1:2], atol,
            reps=args.reps, W_all=_lanes(W_all, slice(1, 2)))
    baseline_artifact = False
    if W_all is not None and below_floor(seq_one, floor_one,
                                         max(seq_spread, floor_spread)):
        # the keyed B = 1 step does strictly more work than the hoisted
        # one: a smaller wall is a measurement artifact. Re-measure once,
        # then clamp and flag rather than publish a speedup that is not
        seq_one, seq_spread = time_sequential_baseline(
            args.grid, args.model, nlanes=nlanes, reps=args.reps,
            nbands=args.nbands, device=dev)
        seq_one, seq_spread, baseline_artifact = clamp_to_floor(
            seq_one, seq_spread, floor_one, floor_spread)
    floor_violation = False
    if below_floor(batched_s, floor_one, max(value_spread, floor_spread)):
        batched_s, value_spread = time_step(
            comp, th, seeds_all, Z, lane_ids, atol, reps=args.reps,
            max_batch=args.max_batch, W_all=W_all)
        batched_s, value_spread, floor_violation = clamp_to_floor(
            batched_s, value_spread, floor_one, floor_spread)

    suffix = ("" if args.model == "grf"
              else f"_{args.model.replace('-', '_')}")
    result = {
        "metric": f"muse_iteration_wall_s_{args.nsims}sims_"
                  f"{args.grid}sq{suffix}",
        "value": batched_s,
        "unit": "s",
        "vs_baseline": seq_one * (args.nsims + 1) / batched_s,
        "baseline_per_sim_s": seq_one,
        "baseline_spread": seq_spread,
        "certified": certified,
    }
    if baseline_artifact:
        # the baseline was clamped UP to the hoisted B = 1 floor: vs_baseline
        # is a lower bound, and the discarded measurement's spread is gone
        del result["baseline_spread"]
        result["baseline_artifact"] = True
    if W_all is not None:
        result["hoisted_crn"] = True
    if args.max_batch is not None:
        result["max_batch"] = args.max_batch
    if args.model == "bandpower":
        result["nbands"] = args.nbands
    if floor_violation:
        result["floor_violation"] = True   # the batched wall is the floor
    else:
        result["value_spread"] = value_spread
    result["reps"] = args.reps
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
