#!/usr/bin/env python3
"""Drive the PyTorch port (``muse_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. It builds the port's kernels from ``muse_tpu_torch/csrc/``, holds
each against its plain PyTorch version, and runs the port's main paths at
full width, each checked against an exact oracle. The paths:

  * slice 1, the field GRF: ``muse(grf_field_problem(n=1024,
    sigma_noise=0.01), 0.5, nsims=100, theta_rtol=1e-5,
    get_covariance=True)``;
  * slice 2, the north-star pipeline (examples/northstar_grf.py):
    ``grf_spectral_problem(n=1024, sigma_noise=0.01, solver="cg")``, a
    white-hoisted ``muse_fit`` of 512 sims in chunks of 128, ``get_J``
    reusing the fit's scores, and implicit-diff ``get_H`` of 51 sims;
  * slice 3, the generic L-BFGS MAP path:
    ``grf_spectral_problem(n=1024, sigma_noise=0.1, solver="lbfgs")``
    through ``muse_fit(0.5, nsims=100, max_batch=101, theta_rtol=1e-5)``,
    ``get_J`` and ``get_H(fd_order="adaptive")`` (the ``get_covariance``
    flow with adaptive FD), its solves cut at ``LBFGS_ITERS3`` iterations,
    and the user models (the funnel family and the PPL) through
    ``muse(..., get_covariance=True)``;
  * slice 4, the remaining field-model families: the lensing pipeline of
    examples/lensing_demo.py at n = 1024 (``lensing_problem(n=1024,
    theta_true=0.3)``, VarPro MAPs with the Newton-CG polish, a Broyden
    fit of 64 sims, reused J, implicit-diff H of 8 sims), the bandpower
    model with 12 bands and the pixel-space ``grf_problem``, both at
    1024² and σ_noise = 0.01.

The noise level and θ_rtol are the repo's 1024² north-star settings. At
the default σ = 1 the field is so faint that the marginal MLE of a draw
may run to θ → −∞, and then there is nothing to check against. The θ_rtol
test measures |Δθ|·σ_F, so with σ_F ≈ 0.008 it needs 1e-5 to stop within
~0.2σ_F of the root. Phases:

  1. the card's name and power limit (``nvidia-smi``);
  2. the kernel build and its seconds;
  3. spectrum_quadform vs plain at every lane count a main path gives it
     at n=1024 (``QUAD_LANES``: 1, 17, 20, 40, 101, 128), and at n=100 and
     n=33 (ragged tails, misaligned lanes): max relative error ≤ 1e-5, a
     bitwise-equal rerun, and the autograd gradients against the plain
     version's (rtol 1e-5, atol 1e-5 relative to the largest entry); then
     on the slices' own θ-score inputs at their own lane counts (slice 2:
     x̃ drawn by the problem's sampler and the weight C/(C+σ²)² at the
     fit's first θ and at the MLE, chunks of 128 lanes and the one-lane
     remainder of 513; slice 3: 101 and 40 lanes; slice 4's pixel GRF:
     packed maps and the weight w·C/((C+σ²)²n²), 101 and 20 lanes), held
     against the plain version in float64 (max relative error ≤ 1e-5) with
     a bitwise rerun;
  4. the slice 1 fit: |θ̂ − MLE| < 3σ_F/√100 + 0.02, 0.5 < σ/σ_F < 2, and
     every batched log-likelihood evaluation of the fit went through the
     kernel (launch count = evaluation count > 0);
  5. times: the quadform kernel and plain at B=101 × 1024² (CUDA events,
     median of 20 samples of 20 launches each), seconds per
     ``muse_step``, and the whole slice 1 fit + J + H;
  6. spectrum_quadform_and_grad vs plain at every lane count a main path
     gives it at n=1024 (``FUSED_LANES``: the fits' chunks of 128, 101 and
     1 lanes; the MAP solves of every get_H, 51, 40, 20, 10 and 5 lanes)
     on the GRF operator A = 1 + C/σ², at 101 and 5 lanes also on the
     bandpower model's 12-band operator, and at (3, 100) and (5, 33): quad
     max relative error ≤ 1e-5 against the plain version in float64 (the
     float32 plain's own rounding reaches 1.5e-5 at B=128), half_grad
     equal to the plain ``z*w`` (``torch.equal``), a bitwise-equal rerun;
  7. the slice 2 pipeline, run twice in one process (cold, then warm):
     |θ̂ − MLE| < max(1e-3, 2σ_F/√512) and 0.9 < σ/σ_F < 1.1
     (northstar_grf.py:116, 124-125); the fit went through
     ``muse_step_white`` and never ``muse_step``; quadform launches =
     batched θ-score evaluations = ``muse_step_white`` calls; fused-kernel
     launches = the CG steps that ``batched_cg`` counted, > 0;
  8. times beside the card's name and power limit: the fused kernel, its
     plain version and its bound at B=128 × 1024²; the quadform's one-call
     library route ``torch.einsum("bnm,bnm,nm->b", z, z, w)`` at B=101;
     the median warm ``muse_step_white`` at 128 lanes and a torch.profiler
     breakdown of it (device-busy share, top kernels); the cold and warm
     fit, J and H walls; the peak device memory;
  9. slice 3, run twice in one process (cold, then warm), then with
     ``solver="cg"`` on the same data and seeds: per ``muse_step_white``
     the L-BFGS loop iterations (and ms each), the lanes' iterations
     (min, median, max), the line-search evaluations, the host syncs and
     the converged and failed lanes; the adaptive-FD rounds and steps; the
     walls; the peak memory; a profile of one warm L-BFGS step. It fails
     unless |θ̂ − MLE| < 3σ_F/√100 + 0.02, 0.5 < σ/σ_F < 2,
     |θ̂_lbfgs − θ̂_cg| < 0.25σ_F, no lane failed, the fit went through
     ``muse_step_white`` only, and quadform launches = batched θ-score
     evaluations = fit steps + FD rounds (one launch per batched score);
 10. the user models, each ``muse(..., nsims=200, grad_z_atol=1e-3,
     get_covariance=True)``: ``funnel_problem(512)`` (|θ̂ − exact MLE
     log(Σx²/D − 1)| < 0.05 and H within 5% of ``funnel_analytic_H``: the
     H of 20 sims has a Monte-Carlo spread of ~1.7%),
     ``vector_funnel_problem(256, 4)`` (each block within 3σ of its exact
     MLE), the PPL funnel as a model function with ``observed=`` (within
     0.05 of the exact MLE) and a PPL model with a LogNormal scale hyper
     (Blockwise θ with the volume factor; within 3σ/√nsims + 0.02 of the
     exact MLE √(Σx²/D − 1)).

 11. the lensing operators on the card at n = 1024, B ∈ {1, 5}, θ = 0.5:
     the adjoint identity |⟨Gz, w⟩ − ⟨z, Gᵀw⟩| ≤ 1e-5·‖Gz‖‖w‖ of the explicit
     pair (sums in float64); the explicit Gᵀ against the AD transpose
     (≤ 1e-4 of its largest entry); one Hessian-vector product (the vjp of
     the gradient, as batched_newton_cg takes it) against a central
     difference of the gradient in float64 at n = 64 (≤ 1e-6 relative),
     and the milliseconds of the three HVP routes (vjp of the gradient,
     jvp of the gradient, torch.func.linearize) at n = 1024, B = 5; one
     lane's ``zhat_varpro`` in a batch of 5 against the same lane alone at
     θ = −1 (objectives within 1e-5 relative, both converged): the
     stand-in for the JAX package's batch-width certifier;
 12. the lensing pipeline at full width with the settings of
     examples/lensing_demo.py's n ≥ 1024 branch: ``muse_fit(θ₀ = 0,
     nsims=64, z0=prob.suggested_z0, alpha=0.3, Hinv_update="broyden",
     regularize=`` the ±0.3 step clamp``, grad_z_atol=3e-3,
     theta_rtol=3e-4, maxsteps=30)``, ``get_J(nsims=64, skip_errors=True,
     warn_reuse=False)``, ``get_H(nsims=8, implicit_diff=True,
     implicit_diff_precond=prob.suggested_h_precond,
     implicit_fit_atol=1e-3)``. The demo's ``max_batch=3`` is a TPU width
     rule: here one warm ``muse_step_white`` is timed at chunk widths 3,
     9, 17, 33 and 65 (seconds per lane, peak memory), and the fit runs at
     the fastest. Per step: the lanes' VarPro outer iterations (min,
     median, max), inner CG iterations, line-search trials, polish
     entries with their Newton and Steihaug counts, host syncs, seconds;
     then the fit, J and H walls, the peak memory and a profile of one
     warm step (busy share, top operators, the FFTs' share). It fails
     unless |θ̂ − 0.3| < 3σ (the demo's own assert), σ is finite and
     positive, the fit went through ``muse_step_white`` only and no lane
     is flagged ``failed`` (lanes frozen unconverged are the reference's
     designed behaviour: counted, not failed). The pipeline runs again
     with the MAPs solved to 1e-3 and 1e-4 (θ̂, σ, counts and walls,
     reported and not gated). Newton-CG, which that fit never enters, runs
     on the fit's chunk at full width: ``solver="newton"`` cut at 3 outer
     iterations, and VarPro cut at one iteration with the MAPs asked to
     1e-4, which hands its lanes to the polish, its Steihaug budget cut
     to 10 (walls, Newton iterations, Steihaug steps, HVPs, peak memory;
     the MAPs must be finite and the polish must run). Then at n = 256 and
     nsims = 16, on one data set and one set of seeds, with the MAPs
     solved to 1e-3, ``solver="varpro"``, ``"newton"`` and ``"lbfgs"``:
     the three θ̂ within 0.5σ of each other, and their walls;
 13. ``bandpower_problem(n=1024, nbands=12, sigma_noise=0.01)``:
     ``muse_fit(nsims=100)``, ``get_J``, implicit ``get_H`` with
     ``suggested_h_precond`` in chunks of 5 sims, against
     ``bandpower_mle``: each θ̂_b within 3σ_b/√100 + 0.02 of its MLE, diag Σ
     within a factor 0.5-2 of the Fisher diagonal, |off-diagonal
     correlations| < 0.3, fused-kernel launches = CG steps > 0, the band
     reduction within 1e-5 of a float64 sum and bitwise equal on a rerun.
     Then
     ``grf_problem(n=1024, sigma_noise=0.01, solver="cg")`` on phase 4's
     field through ``muse(nsims=100, get_covariance=True)`` with phase 4's
     gates, quadform launches = batched score evaluations, fused launches
     = CG steps, and its θ̂ within 0.25σ_F of ``grf_field_problem``'s on the
     same field (the whitened and the non-whitened latent define the same
     marginal model).

The wrappers record every input shape they launch at; after phase 13 the
run fails if a kernel ran at a shape that phases 3 and 6 did not hold
against the plain version. No phase's failure is caught: any failure exits
non-zero. The line before
last is ``{"kernels": [...]}``: each kernel's ``launches`` is its count on
slice 4's paths (the counters set to 0 just before each and read just
after), and ``launches_by_path`` holds the count of every slice's path. The
last line is ``{"ok": true, "device": …}``.
Without a card, or without the package beside it, it exits non-zero and
prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def phase(msg):
    print(msg, flush=True)


def cuda_ms(fn, samples=20, per_sample=20):
    """Median device milliseconds of one call of ``fn`` (CUDA events around
    ``per_sample`` back-to-back calls, so host overhead stays hidden)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    return statistics.median(times)


# the slice 2 pipeline's settings (examples/northstar_grf.py:72-108)
NSIMS2, MAX_BATCH2, H_NSIMS2 = 512, 128, 51
# the lane counts of its fit's chunks: nsims + 1 lanes (the data lane) in
# chunks of MAX_BATCH2, the last one smaller
FIT_CHUNKS2 = sorted({min(MAX_BATCH2, NSIMS2 + 1 - s0)
                      for s0 in range(0, NSIMS2 + 1, MAX_BATCH2)})

# slice 3 (examples of the generic L-BFGS path): the spectral GRF with
# solver="lbfgs" at σ_noise = 0.1, where float32 L-BFGS converges (at 0.01
# A = 1 + C/σ² is too ill-conditioned for it); 100 sims in one chunk of 101
# lanes, adaptive-FD H of 10 sims × 4 stencil offsets
SIGMA3, DATA_SEED3, NSIMS3, H_NSIMS3 = 0.1, 42, 100, 10
H_LANES3 = H_NSIMS3 * 4
# the depth cut of slice 3: L-BFGS iterations per solve (the solver's
# default is 500). A fifth to a quarter of the 1024² lanes stop short of
# g_atol = 1e-2 at the float32 resolution of their objective (JAX's own
# batched_lbfgs leaves 2 of 8 such lanes at max_iters) and would run out
# all 500, at ~0.2 s an iteration (~20 line-search trials each), in every
# fit step; the lanes that converge need 9-60
LBFGS_ITERS3 = 60

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores


def least_ms(nbytes, nops):
    """(least ms for the work on an H100 at its published peaks, what bounds
    it): bytes over the memory rate vs float32 operations over the peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_steps(step, card, label, nsteps=3, top=10, fft_share=False):
    """Where the time of a warm step goes: torch.profiler over ``nsteps``
    synchronised steps; prints the device-busy share of the host span and
    the kernels that take the most device time, and with ``fft_share`` the
    share of the FFT operators (cuFFT). Prints "not measured" when the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(nsteps):
            step()
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        phase(f"{label} [{card}] profile: no device time recorded (not "
              "measured)")
        return
    phase(f"{label} [{card}] profile of {nsteps} warm steps: device busy "
          f"{busy_ms:.2f} ms of a {span_ms:.2f} ms host span "
          f"({busy_ms / span_ms:.1%}); top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        phase(f"  {e.self_device_time_total / 1e3 / nsteps:8.3f} ms/step "
              f"{e.count / nsteps:5.1f} launches/step  {e.key[:110]}")
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    phase(f"{label} [{card}] the same by the operator that launched it:")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        phase(f"  {e.self_device_time_total / 1e3 / nsteps:8.3f} ms/step "
              f"{e.count / nsteps:5.1f} calls/step  {e.key[:60]}")
    if fft_share:
        fft = [e for e in ops if e.key.startswith("aten::_fft_")]
        fft_ms = sum(e.self_device_time_total for e in fft) / 1e3
        phase(f"{label} [{card}] FFT operators (cuFFT): {fft_ms / nsteps:.2f} "
              f"ms/step in {sum(e.count for e in fft) / nsteps:.0f} "
              f"calls/step, {fft_ms / busy_ms:.1%} of the device time")


def phase9(card, prob3, mle3, sig_F3):
    """Slice 3 at full width: the spectral GRF with solver="lbfgs", the
    get_covariance flow with adaptive FD (muse_fit, get_J, get_H), cold and
    warm, then the same fit with solver="cg" on the same data and seeds.
    Returns (the quadform's launches in the cold L-BFGS run, the fused
    kernel's in the CG run)."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import grf_spectral_problem
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg
    from muse_tpu_torch.ops.lbfgs import batched_lbfgs
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec

    B = NSIMS3 + 1
    comp3 = CompiledProblem(prob3, ThetaSpec.from_example(0.5),
                            np.array([0.5]), lbfgs_max_iters=LBFGS_ITERS3)
    step3 = comp3.muse_step_white
    per_step = []

    def counts():
        return (batched_lbfgs.iterations, batched_lbfgs.ls_evaluations,
                batched_lbfgs.host_syncs)

    def counted_step(*args, **kwargs):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step3(*args, **kwargs)
        torch.cuda.synchronize()
        after = counts()
        it = out["iterations"].cpu().numpy()
        open_lanes = ~out["converged"]
        per_step.append({
            "g_norm_open": [round(float(v), 4) for v in torch.quantile(
                out["g_norm"][open_lanes].double(),
                torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64,
                             device=open_lanes.device))]
            if bool(open_lanes.any()) else [],
            "s": time.perf_counter() - t0,
            "loop_iterations": after[0] - before[0],
            "ls_evaluations": after[1] - before[1],
            "host_syncs": after[2] - before[2],
            "lane_iterations": (int(it.min()), float(np.median(it)),
                                int(it.max())),
            "converged": int(out["converged"].sum()),
            "failed": int(out["failed"].sum())})
        return out

    def keyed_step(*args, **kwargs):
        raise AssertionError("the slice 3 fit called muse_step, not "
                             "muse_step_white")

    comp3.muse_step_white = counted_step
    comp3.muse_step = keyed_step
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        gs.reset_counts()
        batched_lbfgs.iterations = batched_lbfgs.ls_evaluations = 0
        batched_lbfgs.host_syncs = 0
        per_step.clear()
        t0 = time.perf_counter()
        res3 = muse_tpu_torch.MuseResult()
        muse_tpu_torch.muse_fit(res3, prob3, 0.5, nsims=NSIMS3, max_batch=B,
                                theta_rtol=1e-5, compiled=comp3, seed=1)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        muse_tpu_torch.get_J(res3, prob3, nsims=NSIMS3, max_batch=B,
                             compiled=comp3, warn_reuse=False)
        torch.cuda.synchronize()
        t_j = time.perf_counter() - t0 - t_fit
        fit_steps = len(per_step)
        muse_tpu_torch.get_H(res3, prob3, nsims=H_NSIMS3, fd_order="adaptive",
                             max_batch=B, compiled=comp3)
        torch.cuda.synchronize()
        t_h = time.perf_counter() - t0 - t_fit - t_j
        rounds = res3.metadata["fd_adaptive"]
        c = {"quad_launches": gs.spectrum_quadform_cuda.launches,
             "quad_evaluations": gs.SpectrumQuadform.evaluations,
             "muse_step_white_calls": fit_steps,
             "fd_rounds": len(rounds),
             "lbfgs_iterations": batched_lbfgs.iterations,
             "lbfgs_ls_evaluations": batched_lbfgs.ls_evaluations,
             "lbfgs_host_syncs": batched_lbfgs.host_syncs}
        th, sig = float(res3.theta[0]), float(res3.sigma[0])
        runs.append({"run": run, "fit_s": t_fit, "J_s": t_j, "H_s": t_h,
                     "theta": th, "sigma": sig, **c})
        bound = 3 * sig_F3 / np.sqrt(NSIMS3) + 0.02
        phase(f"phase 9 {run} [{card}] fit: {res3}  steps {fit_steps}; MLE "
              f"{mle3:.6f} σ_F {sig_F3:.6f}; |θ̂−MLE| {abs(th - mle3):.6f} "
              f"(< {bound:.6f}); σ/σ_F {sig / sig_F3:.4f}; J "
              f"{float(res3.J[0, 0]):.1f} H {float(res3.H[0, 0]):.1f}")
        for i, st in enumerate(per_step):
            phase(f"phase 9 {run} muse_step_white {i + 1}: {st['s']:.3f} s, "
                  f"{st['loop_iterations']} L-BFGS iterations "
                  f"({1e3 * st['s'] / max(st['loop_iterations'], 1):.2f} "
                  f"ms each), lanes min/median/max "
                  f"{st['lane_iterations']}, {st['ls_evaluations']} "
                  f"line-search evaluations, {st['host_syncs']} host syncs, "
                  f"{st['converged']}/{B} converged (the others' g_norm "
                  f"min/median/max {st['g_norm_open']}), {st['failed']} "
                  f"failed")
        phase(f"phase 9 {run} adaptive FD: {len(rounds)} rounds, steps "
              f"{[float(r['step'][0]) for r in rounds]}, trunc "
              f"{[float(r['trunc'][0]) for r in rounds]}, roundoff "
              f"{[float(r['roundoff'][0]) for r in rounds]}")
        phase(f"phase 9 {run} counts: {c}; walls fit {t_fit:.3f} s, J "
              f"{t_j:.4f} s, H {t_h:.3f} s")
        if not (np.isfinite(th) and np.isfinite(sig)):
            raise AssertionError("non-finite θ̂ or σ")
        if not abs(th - mle3) < bound:
            raise AssertionError(f"θ̂ {th} vs MLE {mle3}: off by more than "
                                 f"{bound}")
        if not 0.5 < sig / sig_F3 < 2:
            raise AssertionError(f"σ {sig} vs σ_F {sig_F3}")
        if any(h["map_failed"].any() for h in res3.history):
            raise AssertionError("an L-BFGS lane of the fit failed")
        # one launch per batched θ-score: each fit step, no new J sims
        # (the fit's scores are reused), one FD stencil batch per round
        if not (c["quad_launches"] > 0 and c["quad_launches"]
                == c["quad_evaluations"] == fit_steps + len(rounds)):
            raise AssertionError(f"quadform launches do not match the "
                                 f"θ-score evaluations: {c}")
    peak3 = torch.cuda.max_memory_allocated() / 2 ** 30

    # the same pipeline with the PCG MAPs, on the same data and seeds
    prob3cg = grf_spectral_problem(n=prob3.grf_config.n, sigma_noise=SIGMA3,
                                   solver="cg",
                                   data_seed=DATA_SEED3, device=prob3.device)
    if not torch.equal(prob3cg.x, prob3.x):
        raise AssertionError("data_seed gave other data for solver='cg'")
    gs.reset_counts()
    batched_cg.curvature_steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rescg = muse_tpu_torch.MuseResult()
    muse_tpu_torch.muse_fit(rescg, prob3cg, 0.5, nsims=NSIMS3, max_batch=B,
                            theta_rtol=1e-5, seed=1)
    muse_tpu_torch.get_J(rescg, prob3cg, nsims=NSIMS3, max_batch=B,
                         warn_reuse=False)
    muse_tpu_torch.get_H(rescg, prob3cg, nsims=H_NSIMS3, fd_order="adaptive",
                         max_batch=B)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    fused_cg = gs.spectrum_quadform_and_grad_cuda.launches
    th_l, th_c = runs[0]["theta"], float(rescg.theta[0])
    phase(f"phase 9 [{card}] solver='cg' on the same data: {rescg}  steps "
          f"{len(rescg.history)}, fit + J + H {t_cg:.3f} s; fused launches "
          f"{fused_cg} = CG steps {batched_cg.curvature_steps}; "
          f"|θ̂_lbfgs − θ̂_cg| {abs(th_l - th_c):.3e} (< 0.25σ_F = "
          f"{0.25 * sig_F3:.6f})")
    if not abs(th_l - th_c) < 0.25 * sig_F3:
        raise AssertionError(f"θ̂ L-BFGS {th_l} vs CG {th_c}")
    if not fused_cg == batched_cg.curvature_steps > 0:
        raise AssertionError("fused launches do not match the CG steps")

    # where the time of one warm L-BFGS step goes: from the MAPs at the
    # fit's second θ to its third
    seeds = list(range(B))
    W = comp3.sample_whites(seeds, x_only=True)
    lanes = torch.arange(B, device=W[0].device)
    th_a, th_b = (comp3.theta(res3.history[i]["theta"]) for i in (1, 2))
    Z_a = step3(th_a, th_a, W, torch.zeros((B, comp3.nz),
                                           device=W[0].device),
                lanes, 1e-2)["Z"]
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step3(th_b, th_b, W, Z_a, lanes, 1e-2)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t0
    n_it = batched_lbfgs.iterations - before[0]
    phase(f"phase 9 [{card}] warm muse_step_white ({B} lanes × 1024²): "
          f"{t_step:.3f} s, {n_it} L-BFGS iterations "
          f"({1e3 * t_step / max(n_it, 1):.2f} ms each), lanes "
          f"{int(out['iterations'].min())}-{int(out['iterations'].max())}")
    del out
    profile_steps(lambda: step3(th_b, th_b, W, Z_a, lanes, 1e-2), card,
                  "phase 9", nsteps=1)
    del W, Z_a
    phase(f"phase 9 [{card}] slice 3 walls: cold fit {runs[0]['fit_s']:.3f} "
          f"J {runs[0]['J_s']:.4f} H {runs[0]['H_s']:.3f} s; warm fit "
          f"{runs[1]['fit_s']:.3f} J {runs[1]['J_s']:.4f} H "
          f"{runs[1]['H_s']:.3f} s; peak device memory {peak3:.2f} GiB")
    return runs[0]["quad_launches"], fused_cg


def phase10(card, dev):
    """The user models, each a full muse(..., get_covariance=True) on the
    card: the 512-dim funnel, the vector funnel, the PPL funnel through
    model_problem, and a PPL model with a positive-support hyper."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch import distributions as dist
    from muse_tpu_torch import ppl, transforms
    from muse_tpu_torch.models import (funnel_analytic_H, funnel_problem,
                                       vector_funnel_problem)

    D, nsims = 512, 200
    kw = dict(nsims=nsims, theta_rtol=1e-3, grad_z_atol=1e-3,
              get_covariance=True, seed=1)

    def report(name, res, t, extra=""):
        phase(f"phase 10 [{card}] {name}: {res}  steps {len(res.history)}, "
              f"{t:.2f} s; θ̂ {np.round(res.theta, 5).tolist()} σ "
              f"{np.round(res.sigma, 5).tolist()}{extra}")
        if not (np.isfinite(res.theta).all() and np.isfinite(res.sigma).all()
                and not any(h["map_failed"].any() for h in res.history)):
            raise AssertionError(f"{name}: non-finite result or failed MAPs")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    pf = funnel_problem(D, device=dev)
    x = pf.x
    x64 = x.double().cpu().numpy()
    mle = float(np.log(np.sum(x64 ** 2) / D - 1))
    rf, t = timed(lambda: muse_tpu_torch.muse(pf, 1.0, **kw))
    th = float(rf.theta[0])
    H_exact = funnel_analytic_H(th, D)
    report("funnel_problem(512)", rf, t, f"; exact MLE {mle:.5f}, "
           f"|θ̂−MLE| {abs(th - mle):.5f} (< 0.05); H {rf.H[0, 0]:.3f} vs "
           f"analytic {H_exact:.3f} ({rf.H[0, 0] / H_exact - 1:+.2%})")
    if not abs(th - mle) < 0.05:
        raise AssertionError(f"funnel θ̂ {th} vs exact MLE {mle}")
    if not abs(rf.H[0, 0] / H_exact - 1) < 0.05:
        raise AssertionError(f"funnel H {rf.H[0, 0]} vs {H_exact}")

    pv = vector_funnel_problem(256, 4, device=dev)
    rv, t = timed(lambda: muse_tpu_torch.muse(pv, np.zeros(4), **kw))
    xb = pv.x.double().cpu().numpy().reshape(4, -1)
    mle_b = np.log(np.sum(xb ** 2, axis=1) / xb.shape[1] - 1)
    report("vector_funnel_problem(256, 4)", rv, t,
           f"; per-block exact MLEs {np.round(mle_b, 5).tolist()}")
    if not (np.abs(rv.theta - mle_b) < 3 * rv.sigma).all():
        raise AssertionError("vector funnel θ̂ off its per-block MLEs")

    def funnel():
        theta = ppl.sample("theta", dist.Normal(0.0, 3.0))
        z = ppl.sample("z", dist.Normal(0.0, torch.exp(theta / 2))
                       .expand((D,)))
        ppl.sample("x", dist.Normal(z, 1.0))

    rp, t = timed(lambda: muse_tpu_torch.muse(
        funnel, {"theta": 1.0}, observed={"x": x}, **kw))
    thp = float(rp.theta[0])
    report("PPL funnel (model function + observed)", rp, t,
           f"; |θ̂−MLE| {abs(thp - mle):.5f} (< 0.05); |θ̂ − "
           f"funnel_problem's θ̂| {abs(thp - th):.2e}")
    if not abs(thp - mle) < 0.05:
        raise AssertionError(f"PPL funnel θ̂ {thp} vs exact MLE {mle}")

    def scale_model():
        s = ppl.sample("s", dist.LogNormal(0.0, 1.0))
        z = ppl.sample("z", dist.Normal(0.0, s).expand((D,)))
        ppl.sample("x", dist.Normal(z, 1.0))

    ps = muse_tpu_torch.model_problem(scale_model, {"s": 1.0},
                                      observed={"x": x})
    if not isinstance(ps.theta_bijector, transforms.Blockwise):
        raise AssertionError("the positive hyper has no Blockwise bijector")
    rs, t = timed(lambda: muse_tpu_torch.muse(ps, {"s": 1.0}, **kw))
    s_mle = float(np.sqrt(np.sum(x64 ** 2) / D - 1))
    bound = 3 * float(rs.sigma[0]) / np.sqrt(nsims) + 0.02
    report("PPL LogNormal-scale model (Blockwise θ, volume factor)", rs, t,
           f"; exact MLE s {s_mle:.5f}, |ŝ−MLE| "
           f"{abs(float(rs.theta[0]) - s_mle):.5f} (< {bound:.5f})")
    if not abs(float(rs.theta[0]) - s_mle) < bound:
        raise AssertionError(f"ŝ {rs.theta[0]} vs exact MLE {s_mle}")


# slice 4, the lensing pipeline (examples/lensing_demo.py:87-124, the
# n >= 1024 branch): data at θ = 0.3 from a fixed seed, 64 sims, implicit H
# of 8 sims; the chunk widths of the survey; the fit's settings
N4, THETA_TRUE4, DATA_SEED4, NSIMS4, H_NSIMS4 = 1024, 0.3, 7, 64, 8
WIDTHS4 = (3, 9, 17, 33, 65)
LENS_FIT4 = dict(alpha=0.3, Hinv_update="broyden", grad_z_atol=3e-3,
                 theta_rtol=3e-4, maxsteps=30)
ATOLS4_TIGHT = (1e-3, 1e-4)     # the MAP tolerances of the reported reruns
# the three-solver comparison, its MAPs solved to 1e-3: at the demo's 3e-3
# the L-BFGS fit's failed lanes (line searches at the float32 floor) feed
# its score and took its θ̂ to −0.05 against 0.28 for the other two
# (σ 0.22); at 1e-3 the three agree to 0.003. L-BFGS lanes flagged failed
# are printed and not gated: the plain Armijo test of batched_lbfgs has no
# float32 floor in either package, and on the same data and whites
# muse_tpu's own L-BFGS fit flags more lanes than the port's does
# (tests/test_torch_lensing.py holds the two side by side)
N4_SMALL, NSIMS4_SMALL, ATOL4_SMALL = 256, 16, 1e-3
# bandpower and the pixel GRF: 100 sims in one chunk of 101 lanes; the
# bandpower implicit H solves its fiducial MAPs in chunks of 5 sims; the
# pixel GRF's get_covariance flow solves 10 fiducial MAPs and a ±ε stencil
# batch of 20
NBANDS4, NSIMS4_GRF, H_CHUNK4_BAND = 12, 100, 5
H_LANES4_PIXEL = (NSIMS4_GRF // 10, 2 * (NSIMS4_GRF // 10))

# every lane count at which a main path launches a kernel at n = 1024.
# Phases 3 and 6 hold the kernels against their plain versions at each, and
# the run fails at its end if a kernel was launched at a shape they did
# not hold. The quadform: the fit chunks of slices 1, 3 and 4 (101 lanes)
# and of slice 2, the ±ε stencil batches of slices 1 and 4 (20 lanes) and
# slice 3's adaptive stencil (40). The fused kernel: the PCG of every fit
# chunk and of every get_H's fiducial and stencil MAP solves
QUAD_LANES = sorted({1, 17, 101, *FIT_CHUNKS2, NSIMS3 + 1, H_LANES3,
                     NSIMS4_GRF + 1, H_LANES4_PIXEL[1]})
FUSED_LANES = sorted({1, 17, H_NSIMS2, *FIT_CHUNKS2, NSIMS3 + 1, H_NSIMS3,
                      H_LANES3, NSIMS4_GRF + 1, H_CHUNK4_BAND,
                      *H_LANES4_PIXEL})


def timed(fn):
    """(fn(), its wall seconds), the device drained before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def clamp_steps(theta0, width=0.3):
    """The demo's trust-region guard for a log-amplitude: each θ-step is
    clamped to ±``width`` around the last θ (examples/lensing_demo.py:56-61)."""
    import numpy as np
    prev = {"v": np.array(theta0, np.float64)}

    def regularize(th_t):
        th_t = np.clip(th_t, prev["v"] - width, prev["v"] + width)
        prev["v"] = np.asarray(th_t)
        return th_t
    return regularize


def lensing_counts():
    """The counters of the lensing MAP solvers, as a dict."""
    from muse_tpu_torch.ops.newton_cg import batched_newton_cg as nc
    from muse_tpu_torch.ops.varpro import batched_varpro as vp
    return {"outer": vp.iterations, "ls_trials": vp.ls_trials,
            "inner_steps": vp.inner_steps,
            "syncs": vp.host_syncs + nc.host_syncs,
            "newton": nc.iterations, "steihaug": nc.cg_steps,
            "hvps": nc.hvps}


def phase11(card, dev):
    """The lensing operators on the card: the explicit (G, Gᵀ) pair, the
    Hessian-vector product and the batch-of-5 against B=1 MAP."""
    import torch
    from torch.func import jvp, linearize, vjp

    from muse_tpu_torch.models import lensing_problem

    n = N4
    L = 2 * n * (n // 2 + 1)
    prob = lensing_problem(n=n, theta_true=THETA_TRUE4, data_seed=DATA_SEED4,
                           device=dev)
    ops = prob.varpro_ops(torch.tensor([0.5], device=dev))
    for B in (1, 5):
        g = torch.Generator(device=dev).manual_seed(B)
        Up = 0.5 * torch.randn((B, n * n), generator=g, device=dev)
        Zt = torch.randn((B, L), generator=g, device=dev)
        W = torch.randn((B, n, n), generator=g, device=dev)
        G, Gt = ops["lin_ops"](Up)
        Gz, Gtw = G(Zt), Gt(W)
        lhs = (Gz.double() * W.double()).sum((-2, -1))
        rhs = (Zt.double() * Gtw.double()).sum(-1)
        scale = (Gz.double().flatten(1).norm(dim=-1)
                 * W.double().flatten(1).norm(dim=-1))
        adj = ((lhs - rhs).abs() / scale).max().item()
        vjp_fn = vjp(lambda V: ops["obs_op"](Up, V), torch.zeros_like(Zt))[1]
        Gt_ad = vjp_fn(W)[0]
        rel_t = ((Gtw - Gt_ad).abs().max() / Gt_ad.abs().max()).item()
        obs = ops["obs_op"](Up, Zt)
        rel_g = ((Gz - obs).abs().max() / obs.abs().max()).item()
        ms = {"G": cuda_ms(lambda: G(Zt), samples=5, per_sample=4),
              "Gt": cuda_ms(lambda: Gt(W), samples=5, per_sample=4),
              "Gt_ad": cuda_ms(lambda: vjp_fn(W), samples=5, per_sample=4),
              "obs_op": cuda_ms(lambda: ops["obs_op"](Up, Zt), samples=5,
                                per_sample=4)}
        phase(f"phase 11 [{card}] n={n} B={B}: adjoint identity "
              f"|<Gz,w> - <z,Gtw>|/(|Gz||w|) {adj:.3e} (<= 1e-5); explicit Gt "
              f"vs AD transpose {rel_t:.3e} (<= 1e-4); G vs obs_op "
              f"{rel_g:.3e}; ms: G {ms['G']:.3f}, Gt {ms['Gt']:.3f}, AD "
              f"transpose {ms['Gt_ad']:.3f}, obs_op {ms['obs_op']:.3f}")
        if not (adj <= 1e-5 and rel_t <= 1e-4 and rel_g <= 1e-4):
            raise AssertionError(f"the explicit operator pair fails at B={B}")
        del G, Gt, Gz, Gtw, vjp_fn, Gt_ad, obs, Up, Zt, W

    # one HVP against a central difference of the gradient, in float64
    p64 = lensing_problem(n=64, theta_true=THETA_TRUE4, data_seed=DATA_SEED4,
                          device=dev)
    th = torch.tensor([THETA_TRUE4], device=dev)
    g = torch.Generator(device=dev).manual_seed(64)
    xs = torch.stack([p64.sample_x_z(g, THETA_TRUE4)[0] for _ in range(3)])
    fn = p64.value_and_grad(xs.double(), th)
    U = 0.3 * torch.randn((3, 2 * 64 * 64), generator=g, device=dev,
                          dtype=torch.float64)
    V = torch.randn(U.shape, generator=g, device=dev, dtype=torch.float64)
    hv = vjp(lambda u: fn(u)[1], U)[1](V)[0]
    eps = 1e-5
    fd = (fn(U + eps * V)[1] - fn(U - eps * V)[1]) / (2 * eps)
    err = ((hv - fd).abs().max() / fd.abs().max()).item()
    phase(f"phase 11 [{card}] HVP (vjp of the gradient) vs a central "
          f"difference of the gradient, float64, n=64: relative error "
          f"{err:.3e} (<= 1e-6)")
    if not err <= 1e-6:
        raise AssertionError("the Hessian-vector product is wrong")

    # the three HVP routes at full width (forward-mode AD through the FFT
    # chain is what jvp and linearize need, and implicit-diff H too)
    B = 5
    g = torch.Generator(device=dev).manual_seed(5)
    xs = torch.stack([prob.sample_x_z(g, THETA_TRUE4)[0] for _ in range(B)])
    fn = prob.value_and_grad(xs, th)

    def grad_only(u):
        return fn(u)[1]

    U = 0.3 * torch.randn((B, 2 * n * n), generator=g, device=dev)
    V = torch.randn(U.shape, generator=g, device=dev)
    (_, vjp_fn), t_vjp = timed(lambda: vjp(grad_only, U))
    (_, lin_fn), t_lin = timed(lambda: linearize(grad_only, U))
    h_vjp = vjp_fn(V)[0]
    h_jvp = jvp(grad_only, (U,), (V,))[1]
    h_lin = lin_fn(V)
    scale = h_jvp.abs().max()
    d_vj = ((h_vjp - h_jvp).abs().max() / scale).item()
    d_lj = ((h_lin - h_jvp).abs().max() / scale).item()
    ms = {"gradient": cuda_ms(lambda: fn(U), samples=5, per_sample=3),
          "vjp": cuda_ms(lambda: vjp_fn(V), samples=5, per_sample=3),
          "jvp": cuda_ms(lambda: jvp(grad_only, (U,), (V,)), samples=5,
                         per_sample=3),
          "linearize": cuda_ms(lambda: lin_fn(V), samples=5, per_sample=3)}
    phase(f"phase 11 [{card}] HVP routes at n={n} B={B}: value and gradient "
          f"{ms['gradient']:.2f} ms; vjp of the gradient (the one that "
          f"runs) {ms['vjp']:.2f} ms per product after {1e3 * t_vjp:.1f} ms "
          f"to build; jvp of the gradient {ms['jvp']:.2f} ms per product; "
          f"linearize {ms['linearize']:.2f} ms per product after "
          f"{1e3 * t_lin:.1f} ms to build; vjp vs jvp {d_vj:.3e}, linearize "
          f"vs jvp {d_lj:.3e} of the largest entry")
    if not (d_vj <= 1e-3 and d_lj <= 1e-3):
        raise AssertionError("the HVP routes disagree")
    del vjp_fn, lin_fn, h_vjp, h_jvp, h_lin, U, V, xs, fn

    # a lane in a batch of 5 against the same lane alone
    th = torch.tensor([-1.0], device=dev)
    g = torch.Generator(device=dev).manual_seed(11)
    xs = torch.stack([prob.sample_x_z(g, -1.0)[0] for _ in range(5)])
    (Z5, a5), t5 = timed(lambda: prob.custom_zhat(
        xs, torch.zeros((5, 2 * n * n), device=dev), th, 1e-2))
    (Z1, a1), t1 = timed(lambda: prob.custom_zhat(
        xs[2:3], torch.zeros((1, 2 * n * n), device=dev), th, 1e-2))
    f5, f1 = float(a5["neg_logp"][2]), float(a1["neg_logp"][0])
    rel = abs(f5 - f1) / abs(f1)
    dz = ((Z5[2] - Z1[0]).abs().max() / Z1.abs().max()).item()
    phase(f"phase 11 [{card}] zhat_varpro at θ=-1, lane 2 of 5 vs alone: "
          f"objective {f5:.3f} vs {f1:.3f} (relative {rel:.3e} <= 1e-5), "
          f"max |ΔZ|/max|Z| {dz:.3e}; iterations "
          f"{a5['iterations'].tolist()} vs {a1['iterations'].tolist()}; "
          f"g_norm {[round(float(v), 5) for v in a5['g_norm']]}; "
          f"{t5:.2f} s and {t1:.2f} s")
    if not (rel <= 1e-5 and bool(a5["converged"].all())
            and bool(a1["converged"].all())):
        raise AssertionError("a lane's MAP depends on its batch")


def phase12(card, dev):
    """The lensing pipeline at full width, then the three solvers at 256²."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import lensing_problem
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec
    from muse_tpu_torch.utils.keys import dummy_seed, sim_seeds

    atol = LENS_FIT4["grad_z_atol"]
    prob = lensing_problem(n=N4, theta_true=THETA_TRUE4,
                           data_seed=DATA_SEED4, device=dev)
    held = torch.cuda.memory_allocated() / 2 ** 30
    phase(f"phase 12 [{card}] lensing_problem(n={N4}, theta_true="
          f"{THETA_TRUE4}): budgets {prob.solver_budgets}; {held:.2f} GiB "
          f"of device memory are held by the phases before (the peaks below "
          f"include them)")
    comp = CompiledProblem(prob, ThetaSpec.from_example(0.0), np.array([0.0]))
    step_white = comp.muse_step_white
    seeds_all = [dummy_seed(1)] + sim_seeds(1, NSIMS4)     # the fit's lanes
    z0_flat = comp.zspec.flatten(prob.suggested_z0)

    # the chunk-width survey: the fit's first step (θ₀ = 0 from z0) and a
    # warm one a θ-step of 0.1 on, at each width
    th_a, th_b = comp.theta(np.array([0.0])), comp.theta(np.array([0.1]))
    survey = {}
    for w in WIDTHS4:
        W = comp.sample_whites(seeds_all[:w], x_only=True)
        lanes = torch.arange(w, device=dev)
        Z0 = z0_flat.expand(w, comp.nz).clone()
        torch.cuda.reset_peak_memory_stats()
        c0 = lensing_counts()
        out_a, t_a = timed(lambda: step_white(th_a, th_a, W, Z0, lanes, atol))
        c1 = lensing_counts()
        out_b, t_b = timed(lambda: step_white(th_b, th_b, W, out_a["Z"],
                                              lanes, atol))
        c2 = lensing_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        survey[w] = t_b / w
        phase(f"phase 12 [{card}] width {w}: first step {t_a:.2f} s "
              f"({t_a / w:.3f} s/lane; {c1['outer'] - c0['outer']} VarPro "
              f"iterations, {c1['inner_steps'] - c0['inner_steps']} inner "
              f"steps, {c1['newton'] - c0['newton']} polish iterations, "
              f"{int(out_a['converged'].sum())}/{w} converged), warm step "
              f"{t_b:.2f} s ({t_b / w:.3f} s/lane; "
              f"{c2['outer'] - c1['outer']} VarPro iterations, "
              f"{c2['inner_steps'] - c1['inner_steps']} inner steps, "
              f"{c2['newton'] - c1['newton']} polish iterations, "
              f"{int(out_b['converged'].sum())}/{w} converged); peak "
              f"{peak:.2f} GiB")
        del W, Z0, out_a, out_b
    width = min(survey, key=survey.get)
    phase(f"phase 12 [{card}] warm seconds per lane by width "
          f"{ {w: round(s, 4) for w, s in survey.items()} }: the fit runs "
          f"at max_batch={width}")

    # the fit, J and H
    nchunks = -(-(NSIMS4 + 1) // width)
    calls, kept = [], {}

    def counted_step(*args, **kwargs):
        c0, polish0 = lensing_counts(), prob.zhat_varpro.polish_entries
        out, t = timed(lambda: step_white(*args, **kwargs))
        c1 = lensing_counts()
        it = out["iterations"].cpu().numpy()
        calls.append({
            "s": t, "lanes": len(it),
            "lane_iterations": (int(it.min()), float(np.median(it)),
                                int(it.max())),
            "inner_cg": int(out["cg_iterations"].sum()),
            "polish": prob.zhat_varpro.polish_entries - polish0,
            "converged": int(out["converged"].sum()),
            "failed": int(out["failed"].sum()),
            **{k: c1[k] - c0[k] for k in c0}})
        if len(calls) == 2 * nchunks + 1:     # the third step's first chunk
            kept["args"] = args
        return out

    def keyed_step(*args, **kwargs):
        raise AssertionError("the lensing fit called muse_step, not "
                             "muse_step_white")

    comp.muse_step_white = counted_step
    comp.muse_step = keyed_step
    torch.cuda.reset_peak_memory_stats()
    res = muse_tpu_torch.MuseResult()
    _, t_fit = timed(lambda: muse_tpu_torch.muse_fit(
        res, prob, 0.0, nsims=NSIMS4, z0=prob.suggested_z0,
        regularize=clamp_steps([0.0]), max_batch=width, compiled=comp,
        seed=1, **LENS_FIT4))
    fit_calls = len(calls)
    _, t_j = timed(lambda: muse_tpu_torch.get_J(
        res, prob, nsims=NSIMS4, grad_z_atol=atol, max_batch=width,
        warn_reuse=False, skip_errors=True, compiled=comp))
    _, t_h = timed(lambda: muse_tpu_torch.get_H(
        res, prob, nsims=H_NSIMS4, implicit_diff=True,
        implicit_diff_precond=prob.suggested_h_precond,
        implicit_fit_atol=1e-3, max_batch=width, compiled=comp))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, c in enumerate(calls[:fit_calls]):
        phase(f"phase 12 step {i // nchunks + 1} chunk {i % nchunks + 1} "
              f"({c['lanes']} lanes): {c['s']:.3f} s; VarPro outer "
              f"iterations min/median/max {c['lane_iterations']} "
              f"({c['outer']} run), inner CG iterations {c['inner_cg']} "
              f"({c['inner_steps']} steps run), {c['ls_trials']} "
              f"line-search trials, {c['polish']} polish entries "
              f"({c['newton']} Newton iterations, {c['steihaug']} Steihaug "
              f"steps, {c['hvps']} HVPs), {c['syncs']} host syncs, "
              f"{c['converged']}/{c['lanes']} converged, {c['failed']} "
              f"failed")
    th, sig = float(res.theta[0]), float(res.sigma[0])
    unconv = [int((~h["map_converged"]).sum()) for h in res.history]
    failed = [int(h["map_failed"].sum()) for h in res.history]
    phase(f"phase 12 [{card}] fit: {res}  steps {len(res.history)}; J/H is "
          f"{float(res.J[0, 0]) / float(res.H[0, 0]):.4f} (the covariance "
          f"warns below 0.01: the scores' scatter at this MAP tolerance is "
          f"far below the curvature); θ by "
          f"step {[round(float(h['theta'][0]), 4) for h in res.history]}; "
          f"|θ̂ − {THETA_TRUE4}| {abs(th - THETA_TRUE4):.4f} (< 3σ = "
          f"{3 * sig:.4f}; z-score {(th - THETA_TRUE4) / sig:+.2f}); J "
          f"{float(res.J[0, 0]):.2f} ({len(res.gs)} scores) H "
          f"{float(res.H[0, 0]):.2f}; lanes frozen unconverged by step "
          f"{unconv}, failed by step {failed}")
    phase(f"phase 12 [{card}] walls: fit {t_fit:.2f} s, J {t_j:.4f} s, H "
          f"{t_h:.2f} s; peak device memory {peak:.2f} GiB; max CG resid of "
          f"H {max(float(np.max(r)) for r in res.metadata['implicit_diff_cg_resid']):.3e}")
    if not (np.isfinite(th) and np.isfinite(sig) and sig > 0):
        raise AssertionError("non-finite θ̂, or σ not finite and positive")
    if not abs(th - THETA_TRUE4) < 3 * sig:
        raise AssertionError(f"θ̂ {th} is more than 3σ ({sig}) from "
                             f"{THETA_TRUE4}")
    if any(failed):
        raise AssertionError(f"lanes flagged failed, by step: {failed}")

    # the same pipeline with the MAPs solved tighter than the demo's 3e-3,
    # which ends most 1024² solves within two VarPro iterations: what the
    # tolerance does to θ̂, σ and the walls (reported, not gated)
    comp.muse_step_white = step_white
    for tight in ATOLS4_TIGHT:
        c0 = lensing_counts()
        r = muse_tpu_torch.MuseResult()
        _, t_f = timed(lambda: muse_tpu_torch.muse_fit(
            r, prob, 0.0, nsims=NSIMS4, z0=prob.suggested_z0,
            regularize=clamp_steps([0.0]), max_batch=width, compiled=comp,
            seed=1, **dict(LENS_FIT4, grad_z_atol=tight)))
        c1 = lensing_counts()
        muse_tpu_torch.get_J(r, prob, nsims=NSIMS4, grad_z_atol=tight,
                             max_batch=width, warn_reuse=False,
                             skip_errors=True, compiled=comp)
        _, t_hh = timed(lambda: muse_tpu_torch.get_H(
            r, prob, nsims=H_NSIMS4, implicit_diff=True,
            implicit_diff_precond=prob.suggested_h_precond,
            implicit_fit_atol=tight, max_batch=width, compiled=comp))
        phase(f"phase 12 [{card}] the same with grad_z_atol={tight}: {r}  "
              f"steps {len(r.history)}; VarPro iterations "
              f"{c1['outer'] - c0['outer']}, inner steps "
              f"{c1['inner_steps'] - c0['inner_steps']}, polish iterations "
              f"{c1['newton'] - c0['newton']}; J {float(r.J[0, 0]):.5f} H "
              f"{float(r.H[0, 0]):.4f}; fit {t_f:.2f} s, H {t_hh:.2f} s; "
              f"lanes unconverged by step "
              f"{[int((~h['map_converged']).sum()) for h in r.history]}")

    # where the time of a warm step goes: the third fit step's first chunk
    step_args = kept["args"]
    _, t_step = timed(lambda: step_white(*step_args))
    phase(f"phase 12 [{card}] the third fit step's first chunk again "
          f"({step_args[4].numel()} lanes): {t_step:.3f} s")
    profile_steps(lambda: step_white(*step_args), card, "phase 12", nsteps=1,
                  fft_share=True)
    del step_args, kept

    # Newton-CG at full width, which the fit above never entered: the
    # fit's chunk at θ₀ = 0 from the Wiener start, first through
    # solver="newton" cut at 3 outer iterations, then through VarPro cut at
    # one iteration with the MAPs asked to 1e-4, which leaves lanes for the
    # polish. Walls, counts and peak memory (reported; gated on finite
    # values and the polish having run)
    xs = comp._xs_of_whites(
        comp.sample_whites(seeds_all[:width], x_only=True), th_a)
    Z0 = z0_flat.expand(width, -1).clone()
    for label, solver_kw, tol in (
            ("solver='newton', 3 outer iterations",
             dict(solver="newton", gn_max_outer=3), atol),
            ("VarPro cut at 1 iteration, then the polish (20 outer "
             "iterations of at most 10 Steihaug steps), MAPs to 1e-4",
             dict(solver="varpro", gn_max_outer=1, gn_cg_maxiter=10), 1e-4)):
        p = lensing_problem(n=N4, x_obs=prob.x, device=dev, **solver_kw)
        torch.cuda.reset_peak_memory_stats()
        c0 = lensing_counts()
        (Z, aux), t = timed(lambda: p.custom_zhat(xs, Z0, th_a, tol))
        c1 = lensing_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        phase(f"phase 12 [{card}] Newton-CG at {width} lanes × {N4}², "
              f"{label}: {t:.2f} s; {c1['newton'] - c0['newton']} Newton "
              f"iterations, {c1['steihaug'] - c0['steihaug']} Steihaug "
              f"steps, {c1['hvps'] - c0['hvps']} HVPs "
              f"({1e3 * t / max(c1['hvps'] - c0['hvps'], 1):.1f} ms of wall "
              f"each), {c1['outer'] - c0['outer']} VarPro iterations, "
              f"{p.zhat_varpro.polish_entries} polish entries; "
              f"{int(aux['converged'].sum())}/{width} converged, "
              f"{int(aux['failed'].sum())} failed, sup|g| max "
              f"{float(aux['g_norm'].max()):.3e}; peak {peak:.2f} GiB")
        if not (torch.isfinite(Z).all()
                and torch.isfinite(aux["neg_logp"]).all()):
            raise AssertionError("Newton-CG at full width: non-finite MAPs")
        if solver_kw["solver"] == "varpro" and not (
                p.zhat_varpro.polish_entries == 1
                and c1["hvps"] > c0["hvps"]):
            raise AssertionError("the polish did not run")
        del p, Z, aux
    del xs, Z0, comp

    # the three solvers at 256², one data set and one set of seeds
    x_small = lensing_problem(n=N4_SMALL, theta_true=THETA_TRUE4,
                              data_seed=DATA_SEED4, device=dev).x
    found = {}
    fit_small = dict(LENS_FIT4, grad_z_atol=ATOL4_SMALL)
    for solver in ("varpro", "newton", "lbfgs"):
        p = lensing_problem(n=N4_SMALL, solver=solver, x_obs=x_small,
                            device=dev)
        r = muse_tpu_torch.MuseResult()
        _, t = timed(lambda: muse_tpu_torch.muse_fit(
            r, p, 0.0, nsims=NSIMS4_SMALL, z0=p.suggested_z0,
            regularize=clamp_steps([0.0]), seed=1, **fit_small))
        if solver == "varpro":
            muse_tpu_torch.get_J(r, p, nsims=NSIMS4_SMALL,
                                 grad_z_atol=ATOL4_SMALL, warn_reuse=False,
                                 skip_errors=True)
            muse_tpu_torch.get_H(r, p, nsims=H_NSIMS4, implicit_diff=True,
                                 implicit_diff_precond=p.suggested_h_precond,
                                 implicit_fit_atol=1e-3)
            found["sigma"] = float(r.sigma[0])
        found[solver] = float(r.theta[0])
        phase(f"phase 12 [{card}] n={N4_SMALL} nsims={NSIMS4_SMALL} "
              f"grad_z_atol={ATOL4_SMALL} solver={solver}: θ̂ "
              f"{found[solver]:.5f} in {len(r.history)} steps, fit {t:.2f} "
              f"s; lanes unconverged by step "
              f"{[int((~h['map_converged']).sum()) for h in r.history]}, "
              f"failed by step "
              f"{[int(h['map_failed'].sum()) for h in r.history]}")
    spread = max(found[s] for s in ("varpro", "newton", "lbfgs")) - min(
        found[s] for s in ("varpro", "newton", "lbfgs"))
    phase(f"phase 12 [{card}] the three θ̂ span {spread:.5f} (< 0.5σ = "
          f"{0.5 * found['sigma']:.5f}, σ {found['sigma']:.5f} from the "
          f"VarPro run's J and implicit H)")
    if not spread < 0.5 * found["sigma"]:
        raise AssertionError(f"the solvers disagree: {found}")


def phase13(card, dev, field):
    """Bandpower (vector θ) and the pixel GRF at 1024², σ_noise = 0.01.
    ``field`` is (the field GRF problem, its fitted result) of phase 4.
    Returns the kernels' launch counts on the two paths."""
    import numpy as np
    import torch

    import muse_tpu_torch
    from muse_tpu_torch.models import (bandpower_mle, bandpower_problem,
                                       grf_marginal_mle, grf_problem)
    from muse_tpu_torch.models.bandpower import _k_grid64, band_edges
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg

    n, nb = N4, NBANDS4
    pb = bandpower_problem(n=n, nbands=nb, sigma_noise=0.01, data_seed=42,
                           device=dev)
    mle, cov = bandpower_mle(pb.x_real, n, nb, sigma_noise=0.01)
    sig_F = np.sqrt(np.diag(cov))

    # the band reduction (sorted slices, each summed by torch.sum) on 101
    # lanes of score terms, against a float64 sum
    B = NSIMS4_GRF + 1
    band = torch.tensor(np.tile(np.searchsorted(
        band_edges(n, nb), _k_grid64(n), side="right").reshape(-1), 2),
        device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((B, band.numel()), generator=g, device=dev) ** 2
    want = torch.stack([(q.double() * (band == b)).sum(-1)
                        for b in range(nb)], -1)

    def reduce():
        return torch.func.vmap(pb.band_sum)(q)

    got, again = reduce(), reduce()
    rel = ((got.double() - want).abs() / want).max().item()
    phase(f"phase 13 [{card}] band reduction (B={B}, {nb} bands × 1024²): "
          f"{cuda_ms(reduce, samples=5, per_sample=5):.3f} ms, max relative "
          f"error vs float64 {rel:.3e} (<= 1e-5), rerun bitwise equal: "
          f"{bool(torch.equal(got, again))}")
    if not (rel <= 1e-5 and torch.equal(got, again)):
        raise AssertionError("the band reduction is off or not reproducible")
    del q, want, got, again

    gs.reset_counts()
    batched_cg.curvature_steps = 0
    torch.cuda.reset_peak_memory_stats()
    res = muse_tpu_torch.MuseResult()
    _, t_fit = timed(lambda: muse_tpu_torch.muse_fit(
        res, pb, np.zeros(nb), nsims=NSIMS4_GRF, theta_rtol=1e-5, alpha=1.0,
        seed=1))
    _, t_j = timed(lambda: muse_tpu_torch.get_J(
        res, pb, nsims=NSIMS4_GRF, warn_reuse=False))
    _, t_h = timed(lambda: muse_tpu_torch.get_H(
        res, pb, nsims=NSIMS4_GRF // 10, implicit_diff=True,
        implicit_diff_precond=pb.suggested_h_precond,
        max_batch=H_CHUNK4_BAND))
    fused_band = gs.spectrum_quadform_and_grad_cuda.launches
    cg_steps = batched_cg.curvature_steps
    Sigma = np.asarray(res.Sigma)
    ratio = np.diag(Sigma) / np.diag(cov)
    corr = Sigma / np.sqrt(np.outer(np.diag(Sigma), np.diag(Sigma)))
    off = np.abs(corr - np.eye(nb)).max()
    gap = np.abs(np.asarray(res.theta) - mle)
    bound = 3 * sig_F / np.sqrt(NSIMS4_GRF) + 0.02
    phase(f"phase 13 [{card}] bandpower fit: steps {len(res.history)}; θ̂ "
          f"{np.round(res.theta, 5).tolist()}; MLE "
          f"{np.round(mle, 5).tolist()}; σ_F {np.round(sig_F, 5).tolist()}; "
          f"max |θ̂−MLE| {gap.max():.5f} (each < 3σ_b/10 + 0.02: "
          f"{bool((gap < bound).all())}); diag Σ / Fisher "
          f"{np.round(ratio, 3).tolist()}; max |off-diagonal correlation| "
          f"{off:.3f}; fused launches {fused_band} = CG steps {cg_steps}; "
          f"walls fit {t_fit:.3f} s, J {t_j:.4f} s, implicit H {t_h:.3f} s "
          f"(max CG resid "
          f"{max(float(np.max(r)) for r in res.metadata['implicit_diff_cg_resid']):.3e}); "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not (gap < bound).all():
        raise AssertionError("a band's θ̂ is off its MLE")
    if not ((ratio > 0.5) & (ratio < 2.0)).all():
        raise AssertionError(f"diag Σ against the Fisher diagonal: {ratio}")
    if not off < 0.3:
        raise AssertionError(f"off-diagonal correlation {off}")
    if not fused_band == cg_steps > 0:
        raise AssertionError("fused launches do not match the CG steps")
    if any(h["map_failed"].any() for h in res.history):
        raise AssertionError("a bandpower MAP failed")
    del pb, res

    # the pixel GRF on the field GRF's data
    kw = dict(nsims=NSIMS4_GRF, theta_rtol=1e-5, maxsteps=20,
              get_covariance=True)
    pf, res_f = field
    pg = grf_problem(n=n, sigma_noise=0.01, solver="cg", x_obs=pf.x,
                     device=dev)
    mle_g, sig_g = grf_marginal_mle(pg.x, pg.grf_config)
    gs.reset_counts()
    batched_cg.curvature_steps = 0
    torch.cuda.reset_peak_memory_stats()
    res_g, t_g = timed(lambda: muse_tpu_torch.muse(pg, 0.5, **kw))
    quad, evals = gs.spectrum_quadform_cuda.launches, \
        gs.SpectrumQuadform.evaluations
    fused_grf = gs.spectrum_quadform_and_grad_cuda.launches
    th, sig = float(res_g.theta[0]), float(res_g.sigma[0])
    steps = len(res_g.history)
    bound = 3 * sig_g / np.sqrt(NSIMS4_GRF) + 0.02
    d_field = abs(th - float(res_f.theta[0]))
    phase(f"phase 13 [{card}] grf_problem(solver='cg') fit: {res_g}  steps "
          f"{steps}; MLE {mle_g:.6f} σ_F {sig_g:.6f}; |θ̂−MLE| "
          f"{abs(th - mle_g):.6f} (< {bound:.6f}); σ/σ_F {sig / sig_g:.4f}; "
          f"|θ̂ − θ̂ of grf_field_problem| {d_field:.6f} (< 0.25σ_F = "
          f"{0.25 * sig_g:.6f}); quadform launches {quad} = {evals} batched "
          f"score evaluations = {steps} steps + 1 get_H chunk; fused "
          f"launches {fused_grf} = CG steps {batched_cg.curvature_steps}; "
          f"fit + J + H {t_g:.3f} s, iterations "
          f"{[round(h['t'], 4) for h in res_g.history]} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not (np.isfinite(th) and np.isfinite(sig)):
        raise AssertionError("non-finite θ̂ or σ")
    if not abs(th - mle_g) < bound:
        raise AssertionError(f"θ̂ {th} vs MLE {mle_g}")
    if not 0.5 < sig / sig_g < 2:
        raise AssertionError(f"σ {sig} vs σ_F {sig_g}")
    if not d_field < 0.25 * sig_g:
        raise AssertionError("the whitened and the field latent disagree")
    if not (quad > 0 and quad == evals == steps + 1):
        raise AssertionError(f"{quad} quadform launches, {evals} score "
                             f"evaluations, {steps + 1} chunks")
    if not fused_grf == batched_cg.curvature_steps > 0:
        raise AssertionError("fused launches do not match the CG steps")
    return {"fused_bandpower": fused_band, "fused_grf_pixel": fused_grf,
            "quad_grf_pixel": quad}


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import muse_tpu_torch
    from muse_tpu_torch.models import (grf_field_problem, grf_marginal_mle,
                                       grf_spectral_problem)
    from muse_tpu_torch.ops import grf_spectrum as gs
    from muse_tpu_torch.ops.cg import batched_cg
    from muse_tpu_torch.ops.kernels import build_library
    from muse_tpu_torch.solver import CompiledProblem
    from muse_tpu_torch.theta import ThetaSpec

    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    phase(card)
    phase(f"phase 1 card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    # 2. build
    info = build_library()
    phase(f"phase 2 build: {info['seconds']:.2f} s (cached={info['cached']}) "
          f"{os.path.relpath(info['path'])}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            phase("  ptxas: " + line.strip())

    # 3. kernel vs plain at the main path's shapes, on realistic values:
    # packed spectra of random fields and the weights w/C at θ = 0.5
    def inputs(B, n, seed):
        cfg = muse_tpu_torch.models.GrfConfig(n, device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        z = gs.pack_rfft2(torch.randn((B, n, n), generator=g, device=dev))
        w = gs.pack_weights(cfg.herm_weight / cfg.spectrum(0.5))
        return z.contiguous(), w.contiguous()

    held = {"spectrum_quadform": set(), "spectrum_quadform_and_grad": set()}
    for B, n in [(B, 1024) for B in QUAD_LANES] + [(3, 100), (5, 33)]:
        z, w = inputs(B, n, seed=B + n)
        held["spectrum_quadform"].add(tuple(z.shape))
        got = gs.spectrum_quadform_cuda(z, w)
        again = gs.spectrum_quadform_cuda(z, w)
        want = gs.spectrum_quadform_plain(z, w)
        rel = ((got - want).abs() / want.abs()).max().item()
        abs_err = (got - want).abs().max().item()
        bitwise = bool(torch.equal(got, again))
        phase(f"phase 3 B={B} n={n}: max rel err {rel:.3e}, max abs err "
              f"{abs_err:.3e}, rerun bitwise equal: {bitwise}")
        if not (rel <= 1e-5 and bitwise and torch.isfinite(got).all()):
            raise AssertionError(f"kernel disagrees at B={B}, n={n}")
        del z, w, got, again, want

    z, w = inputs(17, 1024, seed=7)
    ct = torch.linspace(0.5, 1.5, 17, device=dev)
    grads = []
    for f in (gs.spectrum_quadform, gs.spectrum_quadform_plain):
        zz, ww = z.clone().requires_grad_(True), w.clone().requires_grad_(True)
        (f(zz, ww) * ct).sum().backward()
        grads.append((zz.grad, ww.grad))
    for name, a, b in (("dz", grads[0][0], grads[1][0]),
                       ("dinvCw2", grads[0][1], grads[1][1])):
        err = ((a - b).abs().max() / b.abs().max()).item()
        phase(f"phase 3 autograd {name}: max abs err / max |grad| {err:.3e}")
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * b.abs().max().item())
    del z, w, grads, zz, ww

    def check_theta_score(label, score_inputs, lane_counts, thetas):
        """The quadform kernel vs plain (float64) on a slice's own θ-score
        inputs, ``score_inputs(B, θ) -> (z, w)``, at each lane count the
        slice gives it."""
        worst = 0.0
        for B in lane_counts:
            for th in thetas:
                z, w = score_inputs(B, th)
                held["spectrum_quadform"].add(tuple(z.shape))
                got = gs.spectrum_quadform_cuda(z, w)
                again = gs.spectrum_quadform_cuda(z, w)
                want = gs.spectrum_quadform_plain(z.double(), w.double())
                rel = ((got.double() - want).abs() / want.abs()).max().item()
                abs_err = (got.double() - want).abs().max().item()
                bitwise = bool(torch.equal(got, again))
                phase(f"phase 3 {label} θ-score B={B} n={z.shape[1]} "
                      f"θ={th:.6f}: max rel err {rel:.3e} (vs float64), max "
                      f"abs err {abs_err:.3e}, rerun bitwise equal: "
                      f"{bitwise}")
                if not (rel <= 1e-5 and bitwise
                        and torch.isfinite(got).all()):
                    raise AssertionError(f"kernel disagrees on {label}'s "
                                         f"inputs at B={B}, θ={th}")
                worst = max(worst, abs_err)
                del z, w, got, again, want
        return worst

    def spectral_score_inputs(prob):
        """x̃ drawn by the spectral problem's sampler and the weight
        C/(C+σ²)²."""
        cfg = prob.grf_config
        grid = (cfg.n, 2 * (cfg.n // 2 + 1))

        def make(B, th):
            g = torch.Generator(device=dev).manual_seed(B)
            w1 = torch.stack([prob.sample_white(g)[0] for _ in range(B)])
            C2 = cfg.spectrum(th).reshape(-1).repeat(2)
            z = prob.x_of_white((w1, None), th)[0].reshape((B,) + grid)
            return z, (C2 / (C2 + cfg.sigma_noise ** 2) ** 2).reshape(grid)
        return make

    def pixel_score_inputs(prob):
        """The pixel GRF's: packed rfft2 of maps drawn by its sampler and
        the weight w·C/((C+σ²)²n²)."""
        cfg = prob.grf_config

        def make(B, th):
            g = torch.Generator(device=dev).manual_seed(B)
            x = torch.stack([prob.sample_x_z(g, th)[0] for _ in range(B)])
            C = cfg.spectrum(th)
            wq = cfg.herm_weight * C / ((C + cfg.sigma_noise ** 2) ** 2
                                        * cfg.n ** 2)
            return gs.pack_rfft2(x).contiguous(), gs.pack_weights(wq)
        return make

    # slice 2's θ-score inputs at the lane counts of its fit, slice 3's at
    # its fit's chunk and its adaptive-FD stencil batch, slice 4's pixel
    # GRF's at its fit's chunk and its ±ε stencil batch
    prob2 = grf_spectral_problem(n=1024, sigma_noise=0.01, solver="cg",
                                 data_seed=42, device=dev)
    mle2, sig_F2 = grf_marginal_mle(prob2.x_real, prob2.grf_config)
    prob3 = grf_spectral_problem(n=1024, sigma_noise=SIGMA3, solver="lbfgs",
                                 data_seed=DATA_SEED3, device=dev)
    mle3, sig_F3 = grf_marginal_mle(prob3.x_real, prob3.grf_config)
    abs_err_path = max(
        check_theta_score("slice 2", spectral_score_inputs(prob2),
                          FIT_CHUNKS2, (0.5, mle2)),
        check_theta_score("slice 3", spectral_score_inputs(prob3),
                          (NSIMS3 + 1, H_LANES3), (0.5, mle3)),
        check_theta_score("slice 4 pixel GRF", pixel_score_inputs(
            muse_tpu_torch.models.grf_problem(n=1024, sigma_noise=0.01,
                                              device=dev)),
            (NSIMS4_GRF + 1, H_LANES4_PIXEL[1]), (0.5, 0.0)))

    # 4. the main path at full width
    prob = grf_field_problem(n=1024, sigma_noise=0.01, device=dev)
    mle, sig_F = grf_marginal_mle(prob.x, prob.grf_config)
    torch.cuda.synchronize()
    gs.reset_counts()
    t0 = time.perf_counter()
    res = muse_tpu_torch.muse(prob, 0.5, nsims=100, theta_rtol=1e-5,
                              maxsteps=20, get_covariance=True)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launches = gs.spectrum_quadform_cuda.launches
    evaluations = gs.SpectrumQuadform.evaluations
    th, sig = float(res.theta[0]), float(res.sigma[0])
    steps = len(res.history)
    h_chunks = 1                      # get_H: one chunk of 10 sims × ±ε
    bound = 3 * sig_F / np.sqrt(100) + 0.02
    phase(f"phase 4 fit: {res}  steps {steps}; MLE {mle:.6f} σ_F "
          f"{sig_F:.6f}; |θ̂−MLE| {abs(th - mle):.6f} (< {bound:.6f}); "
          f"σ/σ_F {sig / sig_F:.4f}")
    phase(f"phase 4 launches: {launches} kernel launches for {evaluations} "
          f"batched log-likelihood evaluations = {steps} muse_step chunks "
          f"+ {h_chunks} get_H chunk → "
          f"{launches / (steps + h_chunks):.2f} per chunk")
    if not (np.isfinite(th) and np.isfinite(sig)):
        raise AssertionError("non-finite θ̂ or σ")
    if not abs(th - mle) < bound:
        raise AssertionError(f"θ̂ {th} vs MLE {mle}: off by more than {bound}")
    if not 0.5 < sig / sig_F < 2:
        raise AssertionError(f"σ {sig} vs σ_F {sig_F}")
    if not (launches > 0 and launches == evaluations == steps + h_chunks):
        raise AssertionError(f"{launches} launches, {evaluations} "
                             f"evaluations, {steps + h_chunks} chunks")

    # 5. times
    z, w = inputs(101, 1024, seed=5)
    ms_plain = [cuda_ms(lambda: gs.spectrum_quadform_plain(z, w))]
    ms_kernel = [cuda_ms(lambda: gs.spectrum_quadform_cuda(z, w))
                 for _ in range(2)]
    ms_plain.append(cuda_ms(lambda: gs.spectrum_quadform_plain(z, w)))
    ms, plain_ms = statistics.median(ms_kernel), statistics.median(ms_plain)
    gbps = (z.numel() + w.numel()) * 4 / (ms * 1e-3) / 1e9
    del z, w
    phase(f"phase 5 [{card}] spectrum_quadform B=101 n=1024: kernel {ms:.4f} "
          f"ms ({gbps:.0f} GB/s), plain {plain_ms:.4f} ms "
          f"(runs {ms_kernel}, {ms_plain})")

    spec = ThetaSpec.from_example(0.5)
    comp = CompiledProblem(prob, spec, np.array([res.theta[0]]))
    thd = comp.theta(res.theta)
    seeds = list(range(101))
    lanes = torch.arange(101, device=dev)
    Z = torch.zeros((101, comp.nz), device=dev)
    step_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp.muse_step(thd, thd, seeds, Z, lanes, 1e-2)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    phase(f"phase 5 [{card}] muse_step (101 lanes × 1024²): median "
          f"{statistics.median(step_s[1:]):.4f} s (runs {step_s}); whole fit "
          f"+ J + H {t_fit:.2f} s, of which the fit's iterations "
          f"{[round(h['t'], 4) for h in res.history]} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    launches_slice1 = launches
    del comp, Z

    # 6. the fused kernel vs plain, on the PCG operators of the packed
    # models: random packed vectors p and the weight A = 1 + C/σ², with the
    # GRF spectrum at θ = 0.5 or the 12-band spectrum P0·exp(θ_band) of the
    # bandpower model at a θ spread over ±0.5
    def pcg_inputs(B, n, seed, bands=0):
        cfg = muse_tpu_torch.models.GrfConfig(n, sigma_noise=0.01,
                                              device=dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        grid = (n, 2 * (n // 2 + 1))
        C = cfg.spectrum(0.0 if bands else 0.5)
        if bands:
            from muse_tpu_torch.models.bandpower import _k_grid64, band_edges
            band = np.searchsorted(band_edges(n, bands), _k_grid64(n),
                                   side="right")
            C = C * torch.tensor(np.exp(np.linspace(-0.5, 0.5, bands))[band],
                                 dtype=C.dtype, device=dev)
        A = 1.0 + C.reshape(-1).repeat(2) / 0.01 ** 2
        p = torch.randn((B,) + grid, generator=g, device=dev)
        return p, A.reshape(grid).contiguous()

    abs_err_fused = 0.0
    shapes = [(B, 1024, 0) for B in FUSED_LANES] + [
        (B, 1024, NBANDS4) for B in (NSIMS4_GRF + 1, H_CHUNK4_BAND)]
    for B, n, bands in shapes + [(3, 100, 0), (5, 33, 0)]:
        p, A = pcg_inputs(B, n, seed=B + n, bands=bands)
        held["spectrum_quadform_and_grad"].add(tuple(p.shape))
        q, hg = gs.spectrum_quadform_and_grad_cuda(p, A)
        q2, hg2 = gs.spectrum_quadform_and_grad_cuda(p, A)
        qp, hgp = gs.spectrum_quadform_and_grad_plain(p, A)
        # the quad is held against the plain version in float64: the
        # float32 plain einsum is a ~1e6-term dot product whose own
        # rounding reaches ~1e-5 relative here (measured 1.5e-5 at B=128)
        q64, _ = gs.spectrum_quadform_and_grad_plain(p.double(), A.double())
        rel = ((q.double() - q64).abs() / q64.abs()).max().item()
        rel32 = ((qp.double() - q64).abs() / q64.abs()).max().item()
        abs_err = (q.double() - q64).abs().max().item()
        exact = bool(torch.equal(hg, hgp))
        bitwise = bool(torch.equal(q, q2) and torch.equal(hg, hg2))
        phase(f"phase 6 B={B} n={n} "
              f"{f'{bands}-band' if bands else 'GRF'} weight: quad max rel err {rel:.3e} (the "
              f"float32 plain's own {rel32:.3e}), max abs err "
              f"{abs_err:.3e}; half_grad == z*w: {exact}; rerun bitwise "
              f"equal: {bitwise}")
        if not (rel <= 1e-5 and exact and bitwise
                and torch.isfinite(q).all()):
            raise AssertionError(f"fused kernel disagrees at B={B}, n={n}")
        if n == 1024:
            abs_err_fused = max(abs_err_fused, abs_err)
        del p, A, q, hg, q2, hg2, qp, hgp, q64

    # 7. the slice 2 main path at full width, twice in one process
    comp2 = CompiledProblem(prob2, ThetaSpec.from_example(0.5),
                            np.array([0.5]))
    white_calls = [0]
    step_white = comp2.muse_step_white

    def counted_step_white(*args, **kwargs):
        white_calls[0] += 1
        return step_white(*args, **kwargs)

    def keyed_step(*args, **kwargs):
        raise AssertionError("the slice 2 fit called muse_step, not "
                             "muse_step_white")

    comp2.muse_step_white = counted_step_white
    comp2.muse_step = keyed_step
    target = max(1e-3, 2.0 * sig_F2 / np.sqrt(NSIMS2))
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        gs.reset_counts()
        batched_cg.curvature_steps = 0
        white_calls[0] = 0
        t0 = time.perf_counter()
        res2 = muse_tpu_torch.MuseResult()
        muse_tpu_torch.muse_fit(res2, prob2, 0.5, nsims=NSIMS2,
                                max_batch=MAX_BATCH2,
                                theta_rtol=1e-5, alpha=1.0,
                                Hinv_update="sims", compiled=comp2, seed=1)
        torch.cuda.synchronize()
        t_fit2 = time.perf_counter() - t0
        muse_tpu_torch.get_J(res2, prob2, nsims=NSIMS2, max_batch=MAX_BATCH2,
                             compiled=comp2, warn_reuse=False)
        torch.cuda.synchronize()
        t_j2 = time.perf_counter() - t0 - t_fit2
        muse_tpu_torch.get_H(res2, prob2, nsims=H_NSIMS2, implicit_diff=True,
                             implicit_diff_precond=prob2.suggested_h_precond,
                             max_batch=MAX_BATCH2, compiled=comp2)
        torch.cuda.synchronize()
        t_h2 = time.perf_counter() - t0 - t_fit2 - t_j2
        counts = {"quad_launches": gs.spectrum_quadform_cuda.launches,
                  "quad_evaluations": gs.SpectrumQuadform.evaluations,
                  "fused_launches": gs.spectrum_quadform_and_grad_cuda.launches,
                  "cg_steps": batched_cg.curvature_steps,
                  "muse_step_white_calls": white_calls[0]}
        th2, sig2 = float(res2.theta[0]), float(res2.sigma[0])
        runs.append({"run": run, "fit_s": t_fit2, "J_s": t_j2, "H_s": t_h2,
                     "steps": len(res2.history), **counts})
        phase(f"phase 7 {run} [{card}] fit: {res2}  steps "
              f"{len(res2.history)}; MLE {mle2:.6f} σ_F {sig_F2:.6f}; "
              f"|θ̂−MLE| {abs(th2 - mle2):.6f} (< {target:.6f}); σ/σ_F "
              f"{sig2 / sig_F2:.4f}; J {float(res2.J[0, 0]):.1f} H "
              f"{float(res2.H[0, 0]):.1f}; max CG resid "
              f"{max(float(np.max(r)) for r in res2.metadata['implicit_diff_cg_resid']):.3e}")
        phase(f"phase 7 {run} counts: {counts}; walls fit {t_fit2:.3f} s, "
              f"J {t_j2:.4f} s, H {t_h2:.3f} s; fit iterations "
              f"{[round(h['t'], 4) for h in res2.history]} s")
        if not (np.isfinite(th2) and np.isfinite(sig2)):
            raise AssertionError("non-finite θ̂ or σ")
        if not abs(th2 - mle2) < target:
            raise AssertionError(f"θ̂ {th2} vs MLE {mle2}: off by more than "
                                 f"{target}")
        if not 0.9 < sig2 / sig_F2 < 1.1:
            raise AssertionError(f"σ {sig2} vs σ_F {sig_F2}: ratio "
                                 f"{sig2 / sig_F2}")
        if not (counts["muse_step_white_calls"] > 0 and
                counts["quad_launches"] == counts["quad_evaluations"]
                == counts["muse_step_white_calls"]):
            raise AssertionError(f"quadform launches do not match the "
                                 f"θ-score evaluations: {counts}")
        if not (counts["fused_launches"] > 0 and
                counts["fused_launches"] == counts["cg_steps"]):
            raise AssertionError(f"fused launches do not match the CG "
                                 f"steps: {counts}")
    peak2 = torch.cuda.max_memory_allocated() / 2 ** 30
    launches_slice2 = runs[0]["quad_launches"]
    fused_launches = runs[0]["fused_launches"]
    phase(f"phase 7 [{card}] peak device memory {peak2:.2f} GiB")

    # 8. times
    z, w = inputs(101, 1024, seed=5)
    lib_ms = [cuda_ms(lambda: torch.einsum("bnm,bnm,nm->b", z, z, w))]
    lib_ms.append(cuda_ms(lambda: torch.einsum("bnm,bnm,nm->b", z, z, w)))
    library_ms = statistics.median(lib_ms)
    L = z.shape[1] * z.shape[2]
    quad_bound, quad_by = least_ms((101 * L + L + 101) * 4, 3 * 101 * L)
    del z, w
    phase(f"phase 8 [{card}] spectrum_quadform B=101 n=1024: library "
          f"einsum {library_ms:.4f} ms (runs {lib_ms}); bound "
          f"{quad_bound:.4f} ms ({quad_by})")

    p, A = pcg_inputs(128, 1024, seed=9)
    f_plain = [cuda_ms(lambda: gs.spectrum_quadform_and_grad_plain(p, A))]
    f_kernel = [cuda_ms(lambda: gs.spectrum_quadform_and_grad_cuda(p, A))
                for _ in range(2)]
    f_plain.append(cuda_ms(lambda: gs.spectrum_quadform_and_grad_plain(p, A)))
    f_ms, f_plain_ms = statistics.median(f_kernel), statistics.median(f_plain)
    L = p.shape[1] * p.shape[2]
    f_bytes = (2 * 128 * L + L + 128) * 4
    fused_bound, fused_by = least_ms(f_bytes, 3 * 128 * L)
    del p, A
    phase(f"phase 8 [{card}] spectrum_quadform_and_grad B=128 n=1024: "
          f"kernel {f_ms:.4f} ms ({f_bytes / (f_ms * 1e-3) / 1e9:.0f} GB/s),"
          f" plain {f_plain_ms:.4f} ms, bound {fused_bound:.4f} ms "
          f"({fused_by}; {fused_bound / f_ms:.0%} of it) (runs {f_kernel}, "
          f"{f_plain})")

    seeds = list(range(128))
    W = comp2.sample_whites(seeds, x_only=True)
    lanes = torch.arange(1, 129, device=dev)
    Z = torch.zeros((128, comp2.nz), device=dev)
    thd = comp2.theta(np.array([mle2]))
    step_s = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_white(thd, thd, W, Z, lanes, 1e-2)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    phase(f"phase 8 [{card}] muse_step_white (128 lanes × 1024²): median "
          f"{statistics.median(step_s[1:]):.4f} s (runs {step_s})")
    profile_steps(lambda: step_white(thd, thd, W, Z, lanes, 1e-2), card,
                  "phase 8")
    del W, Z
    phase(f"phase 8 [{card}] slice 2 walls: cold fit {runs[0]['fit_s']:.3f} "
          f"J {runs[0]['J_s']:.4f} H {runs[0]['H_s']:.3f} s; warm fit "
          f"{runs[1]['fit_s']:.3f} J {runs[1]['J_s']:.4f} H "
          f"{runs[1]['H_s']:.3f} s; peak device memory {peak2:.2f} GiB")

    phase(f"phases 1-8 took {time.perf_counter() - t_start:.1f} s")
    launches_slice3, fused_cg3 = phase9(card, prob3, mle3, sig_F3)
    phase(f"phases 1-9 took {time.perf_counter() - t_start:.1f} s")
    phase10(card, dev)
    phase(f"phases 1-10 took {time.perf_counter() - t_start:.1f} s")
    phase11(card, dev)
    phase(f"phases 1-11 took {time.perf_counter() - t_start:.1f} s")
    phase12(card, dev)
    phase(f"phases 1-12 took {time.perf_counter() - t_start:.1f} s")
    slice4 = phase13(card, dev, field=(prob, res))
    phase(f"phases 1-13 took {time.perf_counter() - t_start:.1f} s")

    # every shape a kernel was launched at in this run was held against
    # the plain version in phase 3 or 6
    for name, wrapper in (
            ("spectrum_quadform", gs.spectrum_quadform_cuda),
            ("spectrum_quadform_and_grad", gs.spectrum_quadform_and_grad_cuda)):
        missed = sorted(wrapper.shapes - held[name])
        phase(f"{name}: launched at {len(wrapper.shapes)} shapes, lane "
              f"counts at n=1024 "
              f"{sorted(s[0] for s in wrapper.shapes if s[1] == 1024)}; "
              f"not held against the plain version: {missed}")
        if missed:
            raise AssertionError(f"{name} ran at shapes that no phase held "
                                 f"against its plain version: {missed}")

    print(json.dumps({"kernels": [{
        "name": "spectrum_quadform", "route": "cuda",
        "source": "muse_tpu_torch/csrc/spectrum_quadform.cu",
        "replaces": "muse_tpu/ops/pallas_grf.py:137",
        "launches": slice4["quad_grf_pixel"], "max_abs_err": abs_err_path,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": quad_bound,
        "bound_by": quad_by, "library_ms": library_ms,
        "launches_by_path": {"slice1_field_grf": launches_slice1,
                             "slice2_northstar": launches_slice2,
                             "slice3_lbfgs": launches_slice3,
                             "slice4_grf_pixel": slice4["quad_grf_pixel"]}}, {
        "name": "spectrum_quadform_and_grad", "route": "cuda",
        "source": "muse_tpu_torch/csrc/spectrum_quadform.cu",
        "replaces": "muse_tpu/ops/pallas_grf.py:73",
        "launches": slice4["fused_bandpower"] + slice4["fused_grf_pixel"],
        "max_abs_err": abs_err_fused,
        "ms": f_ms, "plain_ms": f_plain_ms, "bound_ms": fused_bound,
        "bound_by": fused_by, "library_ms": None,
        "launches_by_path": {"slice2_northstar": fused_launches,
                             "slice3_cg_comparison": fused_cg3,
                             "slice4_bandpower": slice4["fused_bandpower"],
                             "slice4_grf_pixel": slice4["fused_grf_pixel"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
