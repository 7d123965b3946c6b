"""Time the spectral-GRF MUSE step with noise="direct" against noise="fft".

The port of scripts/bench_noise_modes.py: the measurement behind
``grf_spectral_problem``'s choice of noise mode. ``"direct"`` draws the
data's noise with the hermitian white sampler (no FFT), ``"fft"`` as the
packed rfft2 of pixel normals (two FFT passes). Both time the keyed
``muse_step``, where the sampler runs at every iteration, through
``bench.build``/``bench.time_step`` (the headline bench's lane layout and
timing protocol). It reports the winner and changes no default.

Run:  python -m muse_tpu_torch.scripts.bench_noise_modes [--grid 1024 --nsims 100]
      (add --device cpu to run on the CPU, at a small --grid)
"""

import argparse
import json
import sys

from muse_tpu_torch import bench
from muse_tpu_torch.utils import resolve_device


def time_mode(noise, n_grid, nsims, reps=5, device="cuda"):
    """(median wall, spread) of the keyed muse_step with ``noise``."""
    comp, th, seeds_all, Z, lane_ids, atol = bench.build(
        n_grid, nsims, model="grf", noise=noise, device=device)
    return bench.time_step(comp, th, seeds_all, Z, lane_ids, atol, reps=reps)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m muse_tpu_torch.scripts.bench_noise_modes")
    ap.add_argument("--grid", type=int, default=1024)
    ap.add_argument("--nsims", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fall back to the "
                         "CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    """Time both modes; prints the JSON line and returns it as a dict. The
    spreads go to an earlier line on stderr."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    t_direct, s_direct = time_mode("direct", args.grid, args.nsims,
                                   device=dev)
    t_fft, s_fft = time_mode("fft", args.grid, args.nsims, device=dev)
    print(f"# spreads over 5 reps: direct {s_direct}, fft {s_fft}",
          file=sys.stderr, flush=True)
    result = {
        "metric": f"spectral_grf_noise_mode_s_{args.nsims}sims_"
                  f"{args.grid}sq",
        "direct_s": t_direct,
        "fft_s": t_fft,
        "winner": "direct" if t_direct <= t_fft else "fft",
        "backend": bench.card_line(dev),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
