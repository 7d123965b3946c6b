"""The GRF spectrum quadforms, Σ_k w_k|ẑ_k|²/C_k per lane, on CUDA kernels.

Counterpart of ``muse_tpu/ops/pallas_grf.py``:

  * ``spectrum_quadforms`` — K = 1..4 weights at once, one read of z —
    runs in the hand-written kernel ``csrc/spectrum_quadform.cu`` (which
    replaces the TPU kernel ``_quad_only_kernel``, pallas_grf.py:137) for
    CUDA tensors, and in :func:`spectrum_quadforms_plain` for CPU tensors.
    ``spectrum_quadform`` is its K = 1 launch. A GRF's analytic θ-score
    takes every θ component's quadform from one ``spectrum_quadforms``
    call: one weight per component;
  * ``spectrum_quadform_and_grad`` — the value and the half-gradient z·w in
    one pass — runs in the same source's fused kernel (which replaces
    ``_quadform_kernel``, pallas_grf.py:73) for CUDA tensors, and in
    :func:`spectrum_quadform_and_grad_plain` for CPU tensors. Like the JAX
    function it has no VJP: its consumer, the packed GRF's PCG
    (``models/grf.py``, through ``ops/cg.py``), runs outside autograd.

A CUDA tensor never falls back to a plain version: the kernel launches or
the call raises.

Layout as in the JAX package: spectra are packed re|im along the last
axis, ``z_ri`` of shape (B, n, 2m) with m = n//2 + 1 (:func:`pack_rfft2`),
and the weights ``invCw2`` of shape (n, 2m) (:func:`pack_weights`).

Per-lane θ-scores run under ``torch.func.vmap`` over lanes that each call
the quadform with B=1. The ``vmap`` rules of :class:`SpectrumQuadform`
(value with a recomputing backward, for ``vmap(grad(log_like))``) and of
:class:`SpectrumQuadforms` (no VJP, for the analytic θ-scores) fold the
vmapped axis into the kernel's B axis, so one batched evaluation is ONE
kernel launch for all lanes.
"""

from __future__ import annotations

import torch

__all__ = ["spectrum_quadform", "spectrum_quadform_plain",
           "spectrum_quadform_cuda", "SpectrumQuadform",
           "spectrum_quadforms", "spectrum_quadforms_plain",
           "spectrum_quadforms_cuda", "SpectrumQuadforms",
           "spectrum_quadform_and_grad", "spectrum_quadform_and_grad_plain",
           "spectrum_quadform_and_grad_cuda", "pack_rfft2", "pack_weights",
           "reset_counts"]


def pack_rfft2(z: torch.Tensor) -> torch.Tensor:
    """(…, n, n) real field → (…, n, 2m) packed rfft2 spectrum."""
    zf = torch.fft.rfft2(z, dim=(-2, -1))
    return torch.cat([zf.real, zf.imag], dim=-1)


def pack_weights(a: torch.Tensor) -> torch.Tensor:
    """(n, m) per-mode weights → (n, 2m) matching the packed layout."""
    return torch.cat([a, a], dim=-1)


def spectrum_quadform_plain(z_ri: torch.Tensor,
                            invCw2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, n, 2m), (n, 2m) → (B,)."""
    return torch.einsum("bnm,nm->b", z_ri * z_ri, invCw2)


def spectrum_quadforms_plain(z_ri: torch.Tensor,
                             W: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (B, n, 2m), (K, n, 2m) → (B, K)."""
    return torch.einsum("bnm,knm->bk", z_ri * z_ri, W)


def _check_kernel_args(name, z_ri, w, stacked=False):
    """Raise on what the kernels do not take; return (B, L, slab count S).
    ``w`` is one (n, 2m) weight, or with ``stacked`` a (K, n, 2m) stack."""
    if not (z_ri.is_cuda and w.is_cuda):
        raise ValueError(f"{name} takes CUDA tensors, got {z_ri.device} and "
                         f"{w.device}")
    if z_ri.device != w.device:
        raise ValueError(f"z_ri on {z_ri.device} but the weights on "
                         f"{w.device}")
    if z_ri.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {z_ri.dtype} and "
                        f"{w.dtype}")
    if z_ri.dim() != 3 or w.dim() != 2 + stacked or \
            tuple(w.shape[stacked:]) != tuple(z_ri.shape[1:]):
        raise ValueError(f"shapes (B, n, 2m) and "
                         f"{'(K, n, 2m)' if stacked else '(n, 2m)'} expected, "
                         f"got {tuple(z_ri.shape)} and {tuple(w.shape)}")
    if not (z_ri.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    B = z_ri.shape[0]
    L = z_ri.shape[1] * z_ri.shape[2]
    if not 1 <= B <= 65535 or L == 0:
        raise ValueError(f"need 1 <= B <= 65535 lanes and L > 0, got B={B}, "
                         f"L={L}")
    from .kernels import load_library
    lib = load_library()
    if stacked and not 1 <= w.shape[0] <= \
            lib.muse_spectrum_quadforms_max_weights():
        raise ValueError(f"{name} takes 1 to "
                         f"{lib.muse_spectrum_quadforms_max_weights()} "
                         f"weights, got {w.shape[0]}")
    return B, L, -(-L // int(lib.muse_spectrum_quadform_slab()))


def _launch_quadforms(z_ri, W, B, L, S):
    """Both passes of the quadforms kernel on checked (B, n, 2m) and
    (K, n, 2m) tensors → (B, K)."""
    from .kernels import load_library

    K = W.shape[0]
    partial = torch.empty((B, K, S), dtype=torch.float32, device=z_ri.device)
    out = torch.empty((B, K), dtype=torch.float32, device=z_ri.device)
    stream = torch.cuda.current_stream(z_ri.device).cuda_stream
    rc = load_library().muse_spectrum_quadforms_f32(
        z_ri.data_ptr(), W.data_ptr(), partial.data_ptr(), out.data_ptr(),
        B, K, L, S, stream)
    if rc != 0:
        raise RuntimeError(f"spectrum_quadforms kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def spectrum_quadforms_cuda(z_ri: torch.Tensor,
                            W: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: (B, n, 2m), (K, n, 2m) f32 on one card, 1 ≤
    K ≤ 4 → (B, K), reading z once. Column k is bitwise
    ``spectrum_quadform_cuda(z_ri, W[k])``.

    ``spectrum_quadforms_cuda.launches`` counts the launches."""
    B, L, S = _check_kernel_args("spectrum_quadforms_cuda", z_ri, W,
                                 stacked=True)
    out = _launch_quadforms(z_ri, W, B, L, S)
    spectrum_quadforms_cuda.launches += 1
    return out


spectrum_quadforms_cuda.launches = 0


def spectrum_quadform_cuda(z_ri: torch.Tensor,
                           invCw2: torch.Tensor) -> torch.Tensor:
    """The quadforms kernel's K = 1 launch: (B, n, 2m), (n, 2m) f32 on one
    card → (B,).

    ``spectrum_quadform_cuda.launches`` counts these launches (apart from
    :func:`spectrum_quadforms_cuda`'s)."""
    B, L, S = _check_kernel_args("spectrum_quadform_cuda", z_ri, invCw2)
    out = _launch_quadforms(z_ri, invCw2[None], B, L, S)
    spectrum_quadform_cuda.launches += 1
    return out.reshape(B)


spectrum_quadform_cuda.launches = 0


def _quadform_value(z_ri, invCw2):
    if z_ri.is_cuda:
        return spectrum_quadform_cuda(z_ri.contiguous(), invCw2.contiguous())
    if z_ri.device.type == "cpu":
        return spectrum_quadform_plain(z_ri, invCw2)
    raise ValueError(f"spectrum_quadform has no kernel for {z_ri.device}")


class SpectrumQuadform(torch.autograd.Function):
    """quad_b = Σ z_ri[b]²·invCw2 with a recomputing backward.

    The backward is plain torch, as the JAX custom VJP's is
    (pallas_grf.py:192-196): dz = 2·ct·z·invCw2 and d invCw2 = Σ_b ct_b·z².
    It keeps the inputs and recomputes dz rather than storing a gradient
    tensor in the forward. ``SpectrumQuadform.evaluations`` counts forward
    evaluations on any device; on a card it equals the kernel's launches.
    """

    evaluations = 0

    @staticmethod
    def forward(z_ri, invCw2):
        SpectrumQuadform.evaluations += 1
        return _quadform_value(z_ri, invCw2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, ct):
        z_ri, invCw2 = ctx.saved_tensors
        dz = dic = None
        if ctx.needs_input_grad[0]:
            dz = (2.0 * ct)[:, None, None] * z_ri * invCw2[None]
        if ctx.needs_input_grad[1]:
            dic = torch.einsum("b,bnm->nm", ct, z_ri * z_ri)
        return dz, dic

    @staticmethod
    def vmap(info, in_dims, z_ri, invCw2):
        z_dim, w_dim = in_dims
        if z_dim is None:                  # only the weights are batched
            z_ri = z_ri.expand((info.batch_size,) + tuple(z_ri.shape))
        else:
            z_ri = z_ri.movedim(z_dim, 0)
        V, B = z_ri.shape[:2]
        if w_dim is None:
            # fold the vmapped axis into the kernel's lane axis: one launch
            out = SpectrumQuadform.apply(
                z_ri.reshape((V * B,) + tuple(z_ri.shape[2:])), invCw2)
            return out.reshape(V, B), 0
        invCw2 = invCw2.movedim(w_dim, 0)
        out = torch.stack([SpectrumQuadform.apply(z_ri[v], invCw2[v])
                           for v in range(V)])
        return out, 0


def spectrum_quadform(z_ri: torch.Tensor, invCw2: torch.Tensor) -> torch.Tensor:
    """Σ_k w_k|ẑ_k|²/C_k per lane: (B, n, 2m), (n, 2m) → (B,)."""
    return SpectrumQuadform.apply(z_ri, invCw2)


class SpectrumQuadforms(torch.autograd.Function):
    """quad_bk = Σ z_ri[b]²·W[k] for K weights, reading z once.

    The analytic θ-scores of the GRF models take every θ component's
    quadform from one call. It has no VJP, like
    ``spectrum_quadform_and_grad``: its callers do not differentiate it, and
    a backward through it raises. ``SpectrumQuadforms.evaluations`` counts
    forward evaluations on any device; on a card it equals the kernel's
    launches."""

    evaluations = 0

    @staticmethod
    def forward(z_ri, W):
        SpectrumQuadforms.evaluations += 1
        if z_ri.is_cuda:
            return spectrum_quadforms_cuda(z_ri.contiguous(), W.contiguous())
        if z_ri.device.type == "cpu":
            return spectrum_quadforms_plain(z_ri, W)
        raise ValueError(f"spectrum_quadforms has no kernel for "
                         f"{z_ri.device}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, ct):
        raise RuntimeError("spectrum_quadforms has no VJP: differentiate "
                           "spectrum_quadform (one weight) instead")

    @staticmethod
    def vmap(info, in_dims, z_ri, W):
        z_dim, w_dim = in_dims
        if z_dim is None:                  # only the weights are batched
            z_ri = z_ri.expand((info.batch_size,) + tuple(z_ri.shape))
        else:
            z_ri = z_ri.movedim(z_dim, 0)
        V, B = z_ri.shape[:2]
        if w_dim is None:
            # fold the vmapped axis into the kernel's lane axis: one launch
            out = SpectrumQuadforms.apply(
                z_ri.reshape((V * B,) + tuple(z_ri.shape[2:])), W)
            return out.reshape(V, B, -1), 0
        W = W.movedim(w_dim, 0)
        return torch.stack([SpectrumQuadforms.apply(z_ri[v], W[v])
                            for v in range(V)]), 0


def spectrum_quadforms(z_ri: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Σ_i z_ri[b,i]²·W[k,i] per lane and weight: (B, n, 2m), (K, n, 2m) →
    (B, K), 1 ≤ K ≤ 4, in one pass over z (the kernel for CUDA tensors, the
    plain version for CPU tensors)."""
    return SpectrumQuadforms.apply(z_ri, W)


def spectrum_quadform_and_grad_plain(z_ri: torch.Tensor, invCw2: torch.Tensor):
    """Plain PyTorch version: (B, n, 2m), (n, 2m) → ((B,), (B, n, 2m))."""
    g = z_ri * invCw2
    return torch.einsum("bnm,bnm->b", z_ri, g), g


def spectrum_quadform_and_grad_cuda(z_ri: torch.Tensor, invCw2: torch.Tensor):
    """Launch the fused CUDA kernel: (B, n, 2m), (n, 2m) f32 on one card →
    (quad (B,), half_grad (B, n, 2m)). ``half_grad`` is bitwise ``z_ri *
    invCw2``. ``spectrum_quadform_and_grad_cuda.launches`` counts the
    launches."""
    from .kernels import load_library

    B, L, S = _check_kernel_args("spectrum_quadform_and_grad_cuda", z_ri,
                                 invCw2)
    g = torch.empty_like(z_ri)
    partial = torch.empty((B, S), dtype=torch.float32, device=z_ri.device)
    out = torch.empty((B,), dtype=torch.float32, device=z_ri.device)
    stream = torch.cuda.current_stream(z_ri.device).cuda_stream
    rc = load_library().muse_spectrum_quadform_and_grad_f32(
        z_ri.data_ptr(), invCw2.data_ptr(), g.data_ptr(), partial.data_ptr(),
        out.data_ptr(), B, L, S, stream)
    if rc != 0:
        raise RuntimeError(f"spectrum_quadform_and_grad kernel launch failed: "
                           f"CUDA error {rc}")
    spectrum_quadform_and_grad_cuda.launches += 1
    return out, g


spectrum_quadform_and_grad_cuda.launches = 0


def spectrum_quadform_and_grad(z_ri: torch.Tensor, invCw2: torch.Tensor):
    """(quad_b = Σ z_ri[b]·(z_ri[b]·invCw2), half_grad = z_ri·invCw2) in one
    pass: the kernel for CUDA tensors, the plain version for CPU tensors."""
    if z_ri.is_cuda:
        return spectrum_quadform_and_grad_cuda(z_ri.contiguous(),
                                               invCw2.contiguous())
    if z_ri.device.type == "cpu":
        return spectrum_quadform_and_grad_plain(z_ri, invCw2)
    raise ValueError(f"spectrum_quadform_and_grad has no kernel for "
                     f"{z_ri.device}")


def reset_counts() -> None:
    """Zero every kernel wrapper's launch count and both quadform
    Functions' forward-evaluation counts."""
    spectrum_quadform_cuda.launches = 0
    spectrum_quadforms_cuda.launches = 0
    spectrum_quadform_and_grad_cuda.launches = 0
    SpectrumQuadform.evaluations = 0
    SpectrumQuadforms.evaluations = 0
