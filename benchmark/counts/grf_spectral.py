"""Bytes and operations that the packed spectral GRF's work needs.

Counted from shapes and the step's own counters, never from which kernels
ran: each input read once and each output written once, float32 (4 bytes).
L = 2·n·(n//2+1) packed coordinates a lane.

One outer iteration's step on B lanes with k PCG steps (``muse_step_white``,
``noise="marginal"``, ``solver="cg"``; the per-coordinate constants C, A
and the score weights are (L,) vectors and left out beside B·L):

* x̃ = √(C+σ²)·w₁: read w₁, write x̃ (2 vectors; 1 operation a coordinate);
* the solve's start: b = √C·x̃/σ², r₀ = b − A·z₀, p₀ = r₀/A, ‖b‖, ‖r₀‖:
  read x̃ and z₀, write r₀ and p₀ (4 vectors; 7 operations);
* a PCG step with the curvature pᵀAp and the two reductions it needs in
  two passes over the state: p = r/A + βp with pᵀAp (read r, p; write p),
  then x += αp, r −= αAp with rᵀM⁻¹r and ‖r‖ (read x, p, r; write x, r):
  8 vectors and 14 operations a coordinate (Ap 1, pᵀAp 2, the two updates
  4, M⁻¹r 1, two dot products 4, the new direction 2);
* the θ-score ½Σ x̃²·wₐ for nθ weights: read x̃ (1 vector; 1 + 2·nθ
  operations).
"""

from __future__ import annotations

F32 = 4


def packed_length(cfg: dict) -> int:
    n = cfg["n"]
    return 2 * n * (n // 2 + 1)


def step(cfg: dict, lanes: int, cg_steps: int, ntheta: int = 1) -> tuple:
    """(bytes, operations) of one step call on ``lanes`` lanes that took
    ``cg_steps`` PCG steps."""
    BL = lanes * packed_length(cfg)
    vectors = 2 + 4 + 8 * cg_steps + 1
    ops = 1 + 7 + 14 * cg_steps + 1 + 2 * ntheta
    return F32 * BL * vectors, BL * ops


def counters() -> dict:
    """The port's counters that the per-layer metrics read, by the name of
    the record they go in: PCG steps (``ops/cg.py``)."""
    from muse_tpu_torch.ops.cg import batched_cg
    return {"cg_steps": batched_cg.curvature_steps}


#: the program's kernels whose share of the bandwidth bound is read, by the
#: wrapper that launches them and the device names of their first pass;
#: ``FINALIZE`` is the second pass that both share
KERNELS = {
    "quadform_and_grad": {
        "wrappers": ("spectrum_quadform_and_grad_cuda",),
        "device_names": ("quadgrad_partial_kernel",)},
    "quadforms": {
        "wrappers": ("spectrum_quadforms_cuda", "spectrum_quadform_cuda"),
        "device_names": ("quad_partial_kernel",)},
}
KERNEL_MODULE = "muse_tpu_torch.ops.grf_spectrum"
FINALIZE = "quad_finalize_kernel"


def launch_shape(wrapper: str, args) -> tuple:
    """The shape a launch is counted at: (B, n, 2m) for the fused kernel,
    (B, K, n, 2m) for the quadforms (K = 1 for the one-weight wrapper)."""
    z = args[0]
    if wrapper == "spectrum_quadforms_cuda":
        return (z.shape[0], args[1].shape[0]) + tuple(z.shape[1:])
    if wrapper == "spectrum_quadform_cuda":
        return (z.shape[0], 1) + tuple(z.shape[1:])
    return tuple(z.shape)


def kernel_bytes(kind: str, shape: tuple) -> int:
    """Bytes one launch needs. The fused kernel reads z (B·L) and w (L) and
    writes the half-gradient (B·L) and the values (B); the quadforms read z
    (B·L) and K weights (K·L) and write B·K values."""
    if kind == "quadform_and_grad":
        B, n, m2 = shape
        L = n * m2
        return F32 * (2 * B * L + L + B)
    B, K, n, m2 = shape
    L = n * m2
    return F32 * (B * L + K * L + B * K)
