#!/usr/bin/env python3
"""Drive the PyTorch port (``muse_tpu_torch``) once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit. It builds the port's kernels from ``muse_tpu_torch/csrc/``, holds
each against its plain PyTorch version, runs the port's main path — a full
MUSE fit with covariance, ``muse(grf_field_problem(n=1024,
sigma_noise=0.01), 0.5, nsims=100, theta_rtol=1e-5, get_covariance=True)``
— and checks the estimate against the exact marginal MLE. The noise level
and θ_rtol are the repo's 1024² north-star settings
(examples/northstar_grf.py). At the default σ = 1 the field is so faint
that the marginal MLE of a draw may run to θ → −∞, and then there is
nothing to check against. The θ_rtol test measures |Δθ|·σ_F, so with
σ_F ≈ 0.008 it needs 1e-5 to stop within ~0.2σ_F of the root. Phases:

  1. the card's name and power limit (``nvidia-smi``);
  2. the kernel build and its seconds;
  3. kernel vs plain at B ∈ {1, 17, 101} × n=1024, and at n=100 and n=33
     (ragged tails, misaligned lanes): max relative error ≤ 1e-5, a
     bitwise-equal rerun, and the autograd gradients against the plain
     version's (rtol 1e-5, atol 1e-5 relative to the largest entry);
  4. the fit at full width: |θ̂ − MLE| < 3σ_F/√100 + 0.02,
     0.5 < σ/σ_F < 2, and every batched log-likelihood evaluation of the
     fit went through the kernel (launch count = evaluation count > 0);
  5. times: kernel and plain at B=101 × 1024² (CUDA events, median of
     20 samples of 20 launches each), seconds per ``muse_step``, and the
     whole fit + J + H.

No phase's failure is caught: any failure exits non-zero. The line before
last is ``{"kernels": [...]}``; the last is ``{"ok": true, "device": …}``.
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import muse_tpu_torch
    from muse_tpu_torch.models import grf_field_problem, grf_marginal_mle
    from muse_tpu_torch.ops import grf_spectrum as gs
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

    abs_err_101 = None
    for B, n in ((1, 1024), (17, 1024), (101, 1024), (3, 100), (5, 33)):
        z, w = inputs(B, n, seed=B + n)
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
        if B == 101:
            abs_err_101 = abs_err
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

    print(json.dumps({"kernels": [{
        "name": "spectrum_quadform", "route": "cuda",
        "source": "muse_tpu_torch/csrc/spectrum_quadform.cu",
        "replaces": "muse_tpu/ops/pallas_grf.py:137",
        "launches": launches, "max_abs_err": abs_err_101,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
