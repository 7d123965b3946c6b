"""Bytes and operations that the field GRF's keyed step needs, and the
port's counters that its per-layer metrics read.

Counted from shapes, never from which kernels ran: each input read once
and each output written once, float32 (4 bytes; complex64 8), a real FFT
of an n×n plane (forward or inverse) 2.5·N·log₂N operations with N = n²,
and a spectral plane n·(n//2+1) = h complex values.

One keyed step (``CompiledProblem.muse_step``) on B lanes:

* the draws: u and ε, two normal planes a lane (write 2·N);
* x = F⁻¹(√C·F u) + σε: an ``rfft2`` (read N, write h), the spectral
  multiply (read h, write h; 2 operations a value), an ``irfft2`` (read h,
  write N), the noise's multiply-add (read 2·N, write N; 2 operations);
  the per-lane stack of x (read N, write N);
* the data lane mixed in (read N, write N);
* the Wiener MAP F⁻¹(C·x̂/(C+σ²)): an ``rfft2``, the spectral multiply,
  an ``irfft2`` (the same traffic and operations as √C's pair);
* the θ-score: ``pack_rfft2`` of the MAP (an ``rfft2``, then the ``cat``
  of its real and imaginary parts: read 2·h, write 2·h), and the quadform
  (read 2·h; 3 operations a value: square, weigh, add).

The weights (C, the score's) are (n, n//2+1) constants and left out beside
B planes.
"""

from __future__ import annotations

import math

from . import grf_spectral

F32 = 4


def _planes(cfg: dict) -> tuple:
    n = cfg["n"]
    N = n * n
    return N, n * (n // 2 + 1), 2.5 * N * math.log2(N)


def step(cfg: dict, lanes: int, cg_steps: int = 0, ntheta: int = 1) -> tuple:
    """(bytes, operations) of one keyed step call on ``lanes`` lanes; the
    step has no PCG, so ``cg_steps`` counts nothing."""
    N, h, fft = _planes(cfg)
    cplx = 2 * F32
    # an rfft2 → spectral multiply → irfft2 pair: (bytes, operations)
    pair = (F32 * N + cplx * h + 2 * cplx * h + cplx * h + F32 * N,
            2 * fft + 2 * 2 * h)
    draw = (2 * F32 * N, 0)
    noise = (3 * F32 * N, 2 * N)
    stack = (2 * F32 * N, 0)
    mix = (2 * F32 * N, 0)
    score = (F32 * N + cplx * h + 2 * (2 * F32 * h) + 2 * F32 * h,
             fft + 3 * 2 * h * ntheta)
    parts = (draw, pair, noise, stack, mix, pair, score)
    return (lanes * sum(p[0] for p in parts),
            lanes * sum(p[1] for p in parts))


def counters() -> dict:
    """The port's counters that the per-layer metrics read, by the name of
    the record they go in: the fit step's PCG steps (none on this path,
    ``cg_steps`` 0), the lanes the keyed route drew one generator at a time
    (``looped_lanes``) and the stencil's MAP solves (``h_fd_lanes``). A
    counter the program does not keep is left out, and its metric reads
    nothing."""
    from muse_tpu_torch.utils import trace
    c = trace.counters()
    out = {"cg_steps": 0}
    for key, name in (("looped_lanes", "sample_batch.looped_lanes"),
                      ("h_fd_lanes", "h_fd.lanes")):
        if name in c:
            out[key] = c[name]
    return out


#: the program's kernels whose launches the profiled run records: the
#: θ-score's quadforms, counted as the packed GRF's counting file counts them
KERNELS = {"quadforms": grf_spectral.KERNELS["quadforms"]}
KERNEL_MODULE = grf_spectral.KERNEL_MODULE
FINALIZE = grf_spectral.FINALIZE
launch_shape = grf_spectral.launch_shape
kernel_bytes = grf_spectral.kernel_bytes
