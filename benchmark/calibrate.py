"""The readings that a cell's limits are set from, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 12 \
        --control-seeds 3 [--base-seed N] [--out FILE]

For each seed, the pipelines a run would check (``check_pipelines`` of the
traffic file, realizations and sim seeds as a run with that ``--seed``
derives them) run through the program and the reference judges each: the
lower reading of a number is the largest any of them gives. For the first
``--control-seeds`` seeds, the control (the reference put in the program's
place in bfloat16) runs on the same data and seeds and the reference judges
it the same way: the upper reading is the smallest, over seeds, of the
number a run would report (its largest over the pipelines). The benchmark's
own runs never run the control. Prints one JSON line per pipeline and a
summary line last; ``--out`` also writes them to a file.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def main(argv=None, *, device=None, spec=None) -> dict:
    import torch

    from benchmark import run
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = spec or run.cell_spec(args.workload)
    cfg, traffic = spec["config"], spec["traffic"]
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate needs a CUDA device", file=sys.stderr)
            return {}
        device = torch.device("cuda", 0)
    model = importlib.import_module(f"benchmark.models.{cfg['model']}")
    nsims, P, K = traffic["nsims"], traffic["pool"], traffic["check_pipelines"]
    if torch.device(device).type == "cuda":
        from muse_tpu_torch.ops.kernels import load_library
        load_library()
    from contextlib import nullcontext
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    per_seed = {"program": {}, "control": {}}
    for j in range(args.seeds):
        seed = args.base_seed + 7919 * j
        pool = model.make_pool(cfg, run._derive(seed, (1,)), P + 1, device)
        if j == 0:
            model.pipeline(cfg, pool[P], run._derive(seed, (2,)), nsims,
                           lambda name: nullcontext())
        kinds = ["program"] + (["control"] if j < args.control_seeds else [])
        for kind in kinds:
            worst = {}
            for i in range(K):
                seed_i = run._derive(seed, (0, i))
                t0 = time.perf_counter()
                if kind == "program":
                    out = model.pipeline(cfg, pool[i % P], seed_i, nsims,
                                         lambda name: nullcontext())
                else:
                    out = model.control(cfg, pool[i % P], seed_i, nsims)
                wall = time.perf_counter() - t0
                nums = model.check(cfg, pool[i % P], seed_i, nsims, out)
                emit({"kind": kind, "seed": seed, "pipeline": i,
                      "wall": wall, "iterations": len(out["thetas"]),
                      "numbers": nums})
                for k, v in nums.items():
                    worst[k] = max(worst.get(k, 0.0), v)
            per_seed[kind][seed] = worst
        del pool
    names = list(cfg["limits"])
    summary = {
        "lower": {k: max(w[k] for w in per_seed["program"].values())
                  for k in names},
        "upper": {k: min(w[k] for w in per_seed["control"].values())
                  for k in names} if per_seed["control"] else {},
        "program_seeds": len(per_seed["program"]),
        "control_seeds": len(per_seed["control"])}
    emit({"summary": summary})
    if args.out:
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return summary


if __name__ == "__main__":
    main()
