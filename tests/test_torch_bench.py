"""The port's measuring programs (``muse_tpu_torch/bench.py`` and
``muse_tpu_torch/scripts/``) on the CPU, against the repo-root ``bench.py``.

  * ``build`` builds bench.py's problem for every model: on bench.py's data
    and whites (``comp.sample_whites(keys_all)`` handed over as numpy,
    ``convert.whites_from_arrays``), one ``muse_step_white`` per side gives
    per-lane θ-scores within rtol 1e-4 of the largest entry (float32 MAPs
    and scores, sums in other orders) and the same convergence flags. The
    PPL declares no white split: the port's step takes JAX's sampled xs.
  * ``main`` prints one JSON line with bench.py's keys plus
    ``value_spread`` and ``reps`` under bench.py's metric name.
  * the physical-floor rule as a pure function on given timings, the check
    of the timed step against a perturbed lane (its ẑ, θ-score or
    convergence flag) in the first and the narrower last chunk, the
    refusal of a missing card, and each of the three scripts at a tiny
    size.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from muse_tpu_torch import bench, convert
from muse_tpu_torch.scripts import (bench_noise_modes, kernel_ab_bench,
                                    lensing_calibration_study)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py sets a JAX compilation cache; keep it inside the checkout
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(REPO, ".jax_cache"))
sys.path.insert(0, REPO)
import bench as jbench  # noqa: E402  (the repo-root JAX bench.py)

torch.set_num_threads(1)

CPU = "cpu"
# the keys of bench.py's JSON line (bench.py:355-377) and the port's two
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "baseline_per_sim_s",
              "baseline_spread", "certified"}
BENCH_OPTIONAL = {"hoisted_crn", "max_batch", "nbands", "floor_violation",
                  "baseline_artifact"}
PORT_KEYS = {"value_spread", "reps"}


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_scores_agree(out_t, out_j):
    gj = np.asarray(out_j["g"])
    gt = out_t["g"].numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-4,
                               atol=1e-4 * np.abs(gj).max())
    np.testing.assert_array_equal(out_t["converged"].numpy(),
                                  np.asarray(out_j["converged"]))


# Lensing takes its step at weak lensing, θ = −1, with the MAPs to 1e-3 (as
# tests/test_torch_lensing.py's step parity does): at bench.py's θ₀ = 0 and
# atol 1e-2 a 16² lensing lane's MAP is not a function of its inputs up to
# rounding, in muse_tpu too. On these data and whites muse_tpu's own scores
# at 5 lanes and at B = 1 differ by 10% of the largest (4e-4 at 8², 8e-3 at
# 32²), while the port's batched and B = 1 scores agree bitwise (ROADMAP
# Queue 3 item 3).
@pytest.mark.parametrize("model,step", [
    ("grf", None), ("grf-pixel", None), ("bandpower", None),
    ("lensing", (-1.0, 1e-3)), ("funnel", None)])
def test_build_step_matches_bench_py_on_its_whites(model, step):
    cj, thj, keys, Zj, lanes_j, atol_j = jbench.build(16, 4, model=model,
                                                      nbands=3)
    ct, th, seeds, Z, lanes, atol = bench.build(
        16, 4, model=model, nbands=3, device=CPU, x_obs=np.asarray(cj.x_obs))
    assert len(seeds) == Z.shape[0] == keys.shape[0] == 5
    assert ct.nz == cj.nz and atol == pytest.approx(float(atol_j))
    np.testing.assert_array_equal(th.numpy(), np.asarray(thj))
    np.testing.assert_array_equal(lanes.numpy(), np.asarray(lanes_j))
    if step is not None:
        th = torch.full_like(th, step[0])
        thj, atol, atol_j = jax.numpy.asarray(th.numpy()), step[1], step[1]
    W_j = cj.sample_whites(keys)
    out_j = cj.muse_step_white(thj, thj, W_j, Zj, lanes_j, atol_j)
    W = convert.whites_from_arrays(*(np.asarray(w) for w in W_j),
                                   device=CPU)
    _assert_scores_agree(ct.muse_step_white(th, th, W, Z, lanes, atol),
                         out_j)


def test_build_ppl_step_matches_bench_py_on_its_draws():
    cj, thj, keys, Zj, lanes_j, atol_j = jbench.build(16, 4, model="ppl")
    out_j = cj.muse_step(thj, thj, keys, Zj, lanes_j, atol_j)
    xs_j, _ = cj._sample_batch(keys, thj)
    ct, th, _, Z, lanes, atol = bench.build(
        16, 4, model="ppl", device=CPU,
        x_obs=convert.observed(_numpy(cj.x_obs), CPU))
    assert ct.problem.x_of_white is None      # no white split: keyed step
    xs = convert.observed(_numpy(xs_j), CPU)
    _assert_scores_agree(ct._step_from_xs(xs, th, th, Z, lanes, atol), out_j)


@pytest.mark.parametrize("argv,extra", [
    ([], {"hoisted_crn"}),
    (["--model", "bandpower", "--nbands", "3", "--max-batch", "2"],
     {"hoisted_crn", "nbands", "max_batch"}),
    (["--no-hoist"], set()),
], ids=["grf", "bandpower-chunked", "grf-keyed"])
def test_main_prints_one_json_line_with_bench_py_keys(argv, extra, capsys):
    out = bench.main(["--quick", "--grid", "16", "--nsims", "4", "--device",
                      CPU, *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == out
    assert set(line) - BENCH_OPTIONAL == BENCH_KEYS | PORT_KEYS
    assert set(line) & BENCH_OPTIONAL == extra
    suffix = "_bandpower" if "bandpower" in argv else ""
    assert line["metric"] == f"muse_iteration_wall_s_4sims_16sq{suffix}"
    assert line["certified"] is True and line["reps"] == 5
    assert line["unit"] == "s"
    for k in ("value", "vs_baseline", "baseline_per_sim_s"):
        assert np.isfinite(line[k]) and line[k] > 0


def test_quick_defaults_are_bench_py_sizes():
    args = bench.parse_args(["--quick"])
    assert (args.grid, args.nsims, args.reps) == (128, 16, 5)
    args = bench.parse_args([])
    assert (args.grid, args.nsims, args.device) == (1024, 100, "cuda")


@pytest.mark.parametrize("t,spread,floor_spread,want", [
    # below the floor by less than the 5% margin: kept with its spread
    (0.97, 0.01, 0.0, (0.97, 0.01, False)),
    # below by more than 5% but less than its own spread: kept
    (0.90, 0.20, 0.0, (0.90, 0.20, False)),
    # ... or less than the floor's spread: kept
    (0.90, 0.01, 0.15, (0.90, 0.01, False)),
    # below by more than every margin: clamped, its spread dropped
    (0.80, 0.10, 0.05, (1.0, None, True)),
    # above the floor: kept
    (1.30, 0.40, 0.0, (1.30, 0.40, False)),
])
def test_floor_rule_clamps_only_beyond_the_noise_margin(t, spread,
                                                        floor_spread, want):
    assert bench.clamp_to_floor(t, spread, 1.0, floor_spread) == want
    assert bench.below_floor(t, 1.0, max(spread, floor_spread)) == want[2]


def _honest(comp, th, seeds, Z, lanes, atol, W):
    """The batched output of one chunk of all lanes, cloned to perturb."""
    out = comp.muse_step_white(th, th, W, Z, lanes, atol)
    return {k: out[k].clone() for k in ("Z", "g", "converged")}


@pytest.mark.parametrize("lane", [1, 4])
def test_check_timed_step_fails_on_a_perturbed_lane(lane):
    comp, th, seeds, Z, lanes, atol = bench.build(16, 4, device=CPU)
    W = comp.sample_whites(seeds, x_only=True)
    ok, gaps = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                      W_all=W)
    assert ok and [g["lane"] for g in gaps] == [1, 4]
    assert max(abs(g["objective"]) + g["norm"] + g["g"]
               for g in gaps) < 1e-5
    out = _honest(comp, th, seeds, Z, lanes, atol, W)
    gen = torch.Generator().manual_seed(0)
    out["Z"][lane] += 3.0 * torch.randn(out["Z"].shape[1], generator=gen)
    ok, gaps = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                      W_all=W, outs=[out])
    assert not ok
    bad = {g["lane"]: g for g in gaps}[lane]
    assert bad["objective"] > bench.OBJ_RTOL


@pytest.mark.parametrize("what", ["g", "converged"])
def test_check_timed_step_fails_on_a_perturbed_score(what):
    """The θ-score and convergence flag the timed step returns are held
    too: at σ_noise = 1 the MAP solves take no step, so ẑ alone would
    compare the starting zeros."""
    comp, th, seeds, Z, lanes, atol = bench.build(16, 4, device=CPU)
    W = comp.sample_whites(seeds, x_only=True)
    out = _honest(comp, th, seeds, Z, lanes, atol, W)
    ok, gaps = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                      W_all=W, outs=[out])
    assert ok and all(g["converged"][0] == g["converged"][1] for g in gaps)
    if what == "g":
        # a 1% error in one lane's score, far above float32 rounding
        out["g"][4] *= 1.01
    else:
        out["converged"][4] = ~out["converged"][4]
    ok, gaps = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                      W_all=W, outs=[out])
    assert not ok
    bad = {g["lane"]: g for g in gaps}[4]
    if what == "g":
        assert bad["g"] > bench.G_RTOL and bad["objective"] < 1e-6
    else:
        assert bad["converged"][0] != bad["converged"][1]


def test_check_covers_the_narrower_last_chunk():
    comp, th, seeds, Z, lanes, atol = bench.build(16, 4, device=CPU)
    W = comp.sample_whites(seeds, x_only=True)
    # 5 lanes at 3 a chunk: the chunks 0-2 and 3-4, both widths checked
    ok, gaps = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                      max_batch=3, W_all=W)
    assert ok and [g["lane"] for g in gaps] == [1, 2, 3, 4]
    # at 4 a chunk the last chunk (lane 4 alone) is narrower too
    ok, gaps = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                      max_batch=4, W_all=W)
    assert ok and [g["lane"] for g in gaps] == [1, 3, 4]
    outs = [_honest(comp, th, seeds[s], Z[s], lanes[s], atol,
                    bench._lanes(W, s)) for s in (slice(0, 3), slice(3, 5))]
    outs[1]["g"][1] *= 1.01                    # lane 4, in the last chunk
    ok, gaps = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                      max_batch=3, W_all=W, outs=outs)
    assert not ok and [g["lane"] for g in gaps if g["g"] > bench.G_RTOL] \
        == [4]


def test_check_at_width_one_compares_the_hoisted_step_with_the_keyed():
    comp, th, seeds, Z, lanes, atol = bench.build(16, 4, device=CPU)
    W = comp.sample_whites(seeds, x_only=True)
    ok, gaps = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                      max_batch=1, W_all=W)
    assert ok and [g["lane"] for g in gaps] == [0]
    out = _honest(comp, th, seeds[:1], Z[:1], lanes[:1], atol,
                  bench._lanes(W, slice(0, 1)))
    out["Z"] = torch.zeros((1, comp.nz))       # an unsolved data lane
    ok, _ = bench.check_timed_step(comp, th, seeds, Z, lanes, atol,
                                   max_batch=1, W_all=W, outs=[out])
    assert not ok


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--quick", "--grid", "16", "--nsims", "4"])
    with pytest.raises(RuntimeError, match="is_available"):
        bench_noise_modes.main(["--grid", "16", "--nsims", "4"])


def test_kernel_ab_bench_runs_and_counts(capsys):
    out = kernel_ab_bench.main(["--n", "16", "--nsims", "2", "--device",
                                CPU])
    text = capsys.readouterr().out
    assert "cuda/plain = " in text and "s/muse_step" in text
    # on the CPU the kernel route runs the quadforms' plain version: its
    # evaluations are counted, one per batched θ-score, and nothing launches
    assert out["cuda"]["evaluations"] >= 12 and out["cuda"]["launches"] == 0
    assert out["plain"]["evaluations"] == out["plain"]["launches"] == 0
    assert np.isfinite(out["ratio"]) and out["ratio"] > 0


def test_bench_noise_modes_prints_its_keys(capsys):
    out = bench_noise_modes.main(["--grid", "16", "--nsims", "4", "--device",
                                  CPU])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"metric", "direct_s", "fft_s", "winner", "backend"}
    assert line["metric"] == "spectral_grf_noise_mode_s_4sims_16sq"
    assert line["winner"] in ("direct", "fft")
    assert line["backend"].startswith("cpu")


def test_lensing_calibration_study_prints_rows_and_summary(capsys):
    rows, summary = lensing_calibration_study.main(
        ["--n", "8", "--nsims", "2", "--reps", "2", "--maxsteps", "1",
         "--device", CPU])
    lines = [json.loads(s) for s in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == [*rows, summary]
    assert [r["rep"] for r in rows] == [0, 1]
    assert set(rows[0]) == {"rep", "theta_hat", "sigma", "z", "iters",
                            "wall_s"}
    assert set(summary) == {
        "summary", "n", "nsims", "reps", "theta_true", "theta_rtol",
        "grad_z_atol", "mean_theta", "std_theta", "max_abs_z",
        "coverage_1.96", "bias_over_se", "median_sigma",
        "sigma_over_scatter", "diverged"}
    assert all(np.isfinite(r["sigma"]) and r["sigma"] > 0 for r in rows)

