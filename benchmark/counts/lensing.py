"""Bytes and operations that the lensing model's work needs, and the
port's counters that its per-layer metrics read.

Counted from shapes and the step's own counters, never from which kernels
ran: each input read once and each output written once, float32 (4 bytes;
complex64 8), a real FFT of an n×n plane 2.5·N·log₂N operations with
N = n². The latent a lane is 2·n² (u_φ, u_z); VarPro's linear block lives
in packed-Fourier coordinates, L = 2·n·(n//2+1) floats a lane.

``step`` counts, for one ``muse_step_white`` call on B lanes whose VarPro
took k inner elimination-PCG steps, only those steps' operator pair. A
step applies A = I + GᵀG/σ² once:

* G: read the packed z̃ (L) and the six pixel planes D (6·n²), the six
  spectral products with the derivative diagonals (6 complex multiplies of
  n·nr, 6 real operations each), one ``irfft2`` of six planes, the
  six-plane multiply-add (11·n²), write G z̃ (n²);
* Gᵀ: read W (n²) and D (6·n²), the six-plane multiply (6·n²), one
  ``rfft2`` of six planes, the spectral products and their sum (6 complex
  multiplies and 5 complex adds of n·nr), write the packed result (L).

It is a lower bound of the step's work: the outer L-BFGS, the line
search's reduced objective and gradient, the deflections of each inner
solve, the certificate, the polish and the θ-scores are not passed to it.
"""

from __future__ import annotations

import math

F32 = 4

#: no hand-written kernel runs on this model's path
KERNELS = {}
KERNEL_MODULE = "muse_tpu_torch.models.lensing"
FINALIZE = None


def packed_length(cfg: dict) -> int:
    n = cfg["n"]
    return 2 * n * (n // 2 + 1)


def inner_step(cfg: dict) -> tuple:
    """(bytes, operations) of one inner PCG step's G and Gᵀ on one lane."""
    n = cfg["n"]
    N, half, L = n * n, n * (n // 2 + 1), packed_length(cfg)
    fft = 2.5 * N * math.log2(N)
    nbytes = F32 * ((L + 6 * N + N) + (N + 6 * N + L))
    ops = (6 * 6 * half + 6 * fft + 11 * N) + (6 * N + 6 * fft
                                                + (6 * 6 + 5 * 2) * half)
    return nbytes, ops


def step(cfg: dict, lanes: int, inner_steps: int, ntheta: int = 1) -> tuple:
    """(bytes, operations) of one step call on ``lanes`` lanes whose VarPro
    took ``inner_steps`` inner PCG steps (a lower bound, above)."""
    b, f = inner_step(cfg)
    return lanes * inner_steps * b, lanes * inner_steps * f


def counters() -> dict:
    """The port's counters that the per-layer metrics read, by the name of
    the record they go in: VarPro's inner PCG steps (``cg_steps``, the fit
    step's PCG), implicit H's HVP-CG steps, the lanes handed to the
    Newton-CG polish and the lanes returned unconverged. A counter the
    program does not keep is left out, and its metric reads nothing."""
    from muse_tpu_torch.ops.varpro import batched_varpro
    from muse_tpu_torch.utils import trace
    c = trace.counters()
    out = {"cg_steps": batched_varpro.inner_steps}
    for key, name in (("h_cg_steps", "batched_cg.steps"),
                      ("polished_lanes", "zhat_varpro.polished_lanes"),
                      ("frozen_lanes", "zhat_varpro.frozen_lanes")):
        if name in c:
            out[key] = c[name]
    return out
