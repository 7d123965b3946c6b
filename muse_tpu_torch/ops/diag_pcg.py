"""The packed GRF's diagonal PCG: its loop and its three vector passes.

The packed-spectral models (``models/grf.py``: ``grf_spectral_problem``,
``bandpower_problem``, the pixel ``grf_problem``) solve A·z = b per lane
with A diagonal, one (L,) row shared by the lanes, preconditioned by its
exact inverse 1/A. The loop is ``ops/cg.py``'s masked lockstep with the
same stop rule and the same host reads of ``all(done)``; each step's
operator and curvature (A·p, pᵀA·p) come from the fused quadform kernel,
called through ``ops/grf_spectrum.py``'s module global as before, and every
other vector operation of the loop is one of three passes:

  * :func:`diag_pcg_start` (A, b, Z₀) → (r₀ = b − A·Z₀, p₀ = r₀/A, the
    lanes' state): with ``scale`` the right-hand side is scale·b/divisor,
    formed per coordinate and never stored; the state holds ‖r₀‖, r₀ᵀp₀,
    the stop threshold from ‖b‖, ``done`` and the iteration counts;
  * :func:`diag_pcg_update` (x, r, p, pᵀA·p) → x + α·p, r − α·(A·p) with
    α = rᵀz/pᵀA·p a lane (0 where the lane is done or its curvature is not
    positive), and the state after the step: rᵀ(r/A), ‖r‖, β, ``done``;
  * :func:`diag_pcg_direction` (r, p) → r/A + β·p, p kept where the lane
    was done before the step.

Each dispatches on its input's device: the hand-written kernels of
``csrc/diag_pcg.cu`` for a CUDA tensor (float32; they launch or the call
raises), the plain version (``*_plain``) for a CPU one. The plain versions
are ``batched_cg``'s expressions in its order, so on the CPU the loop is
bitwise what ``batched_cg`` gives with the same operator. On a card the
passes write x (after the first step), r and p in place; Z₀ and b are only
read. ``diag_pcg_*_cuda.launches`` count the launches: a solve launches the
start once, and every step the update and the direction once each.

``batched_cg``'s counters count this loop too: ``batched_cg.steps`` and
``batched_cg.curvature_steps`` its steps, ``batched_cg.host_syncs`` its
reads of ``all(done)``.

Under a field axis of a mesh each rank holds a slice of every lane and
``reduce`` sums a per-lane partial over the ranks: each pass's sums are
reduced, in one call a pass, before the lanes' state is formed from them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils import trace

__all__ = ["PcgLanes", "batched_diag_pcg", "diag_pcg_start",
           "diag_pcg_update", "diag_pcg_direction", "diag_pcg_start_plain",
           "diag_pcg_update_plain", "diag_pcg_direction_plain",
           "diag_pcg_start_cuda", "diag_pcg_update_cuda",
           "diag_pcg_direction_cuda"]


class PcgLanes(NamedTuple):
    """Each lane's scalars between the passes, all (B,)."""
    rz: torch.Tensor        # rᵀM⁻¹r
    r_norm: torch.Tensor    # ‖r‖
    thresh: torch.Tensor    # the stop: ‖r‖ < thresh
    beta: torch.Tensor      # the last step's β (0 where the lane was done)
    done: torch.Tensor      # bool
    keep: torch.Tensor      # bool: done before the last step (p kept)
    iters: torch.Tensor     # int32: the steps the lane took


# ---- plain versions -------------------------------------------------- #

def _norm(v, reduce):
    if reduce is None:
        return torch.linalg.vector_norm(v, dim=-1)
    return torch.sqrt(reduce(torch.sum(v * v, -1)))


def diag_pcg_start_plain(A, b, Z0, c: float, scale=None, divisor=1.0,
                         reduce=None):
    """(r₀, p₀, the lanes' state) of the solve from ``Z0``; the stop is
    ‖r‖ < c·‖b‖/‖b‖ (``c`` = atol·√nz, as ``batched_cg`` takes the relative
    tolerance c/‖b‖)."""
    if scale is not None:
        b = scale * b / divisor
    r0 = b - A * Z0
    z0 = r0 / A
    if reduce is None:
        b_norm = torch.linalg.vector_norm(b, dim=-1)
        rz, r_norm = torch.sum(r0 * z0, -1), _norm(r0, None)
    else:
        s = reduce(torch.stack([torch.sum(b * b, -1), torch.sum(r0 * z0, -1),
                                torch.sum(r0 * r0, -1)]))
        b_norm, rz, r_norm = torch.sqrt(s[0]), s[1], torch.sqrt(s[2])
    clamped = torch.clamp(b_norm, min=1e-30)
    thresh = c / clamped * clamped
    done = r_norm < thresh
    return r0, z0, PcgLanes(rz=rz, r_norm=r_norm, thresh=thresh,
                            beta=torch.zeros_like(rz), done=done, keep=done,
                            iters=torch.zeros(rz.shape, dtype=torch.int32,
                                              device=rz.device))


def diag_pcg_update_plain(x, r, p, A, pAp, lanes: PcgLanes, reduce=None,
                          in_place: bool = False):
    """(x + α·p, r − α·(A·p), the lanes' state after the step);
    ``in_place`` is the kernel's (the plain version writes new tensors)."""
    rz, done = lanes.rz, lanes.done
    alpha = rz / torch.where(pAp > 0, pAp, torch.ones_like(pAp))
    alpha = torch.where(done | (pAp <= 0), torch.zeros_like(alpha), alpha)
    x = x + alpha[:, None] * p
    r = r - alpha[:, None] * (p * A)
    z = r / A
    if reduce is None:
        rz1, r_norm = torch.sum(r * z, -1), _norm(r, None)
    else:
        s = reduce(torch.stack([torch.sum(r * z, -1), torch.sum(r * r, -1)]))
        rz1, r_norm = s[0], torch.sqrt(s[1])
    beta = torch.where(done, torch.zeros_like(rz1),
                       rz1 / torch.where(rz == 0, torch.ones_like(rz), rz))
    return x, r, PcgLanes(
        rz=rz1, r_norm=r_norm, thresh=lanes.thresh, beta=beta,
        done=done | (r_norm < lanes.thresh) | ~torch.isfinite(rz1),
        keep=done, iters=lanes.iters + (~done).to(torch.int32))


def diag_pcg_direction_plain(r, p, A, lanes: PcgLanes):
    """r/A + β·p, p where the lane was done before the step."""
    z = r / A
    return torch.where(lanes.keep[:, None], p, z + lanes.beta[:, None] * p)


# ---- the kernels ----------------------------------------------------- #

def _vector(name, t, shape, dev):
    if not (t.is_cuda and t.device == dev):
        raise ValueError(f"{name} must lie on {dev}, got {t.device}")
    if t.dtype != torch.float32 or t.numel() != torch.Size(shape).numel():
        raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t.reshape(shape).contiguous()


def _slabs(B: int, L: int) -> int:
    from .kernels import load_library

    if not (1 <= B <= 65535 and L > 0):
        raise ValueError(f"the diagonal PCG's kernels take 1 <= B <= 65535 "
                         f"lanes and L > 0, got B={B}, L={L}")
    return -(-L // int(load_library().muse_diag_pcg_slab()))


def _launched(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"diag_pcg {name} kernel launch failed: CUDA "
                           f"error {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _finalize(nq: int, partial, lanes: PcgLanes, c: float, reduce) -> None:
    """Each lane's ``nq`` sums over the (B, nq, S) partials, then its state
    (``lanes``, written in place); under ``reduce`` the sums are reduced
    in between."""
    from .kernels import load_library

    lib = load_library()
    B, _, S = partial.shape
    dev = partial.device

    def launch(part, S, sums):
        _launched(lib.muse_diag_pcg_finalize_f32(
            nq, part.data_ptr(), S, None if sums is None else sums.data_ptr(),
            c, lanes.rz.data_ptr(), lanes.r_norm.data_ptr(),
            lanes.thresh.data_ptr(), lanes.beta.data_ptr(),
            lanes.done.data_ptr(), lanes.keep.data_ptr(),
            lanes.iters.data_ptr(), B, _stream(dev)), "finalize")
    if reduce is None:
        launch(partial, S, None)
        return
    sums = torch.empty((B, nq), dtype=torch.float32, device=dev)
    launch(partial, S, sums)
    launch(reduce(sums).contiguous(), 1, None)


def diag_pcg_start_cuda(A, b, Z0, c: float, scale=None, divisor=1.0,
                        reduce=None):
    """The kernel of :func:`diag_pcg_start`: float32 on one card."""
    from .kernels import load_library

    dev = Z0.device
    B, L = Z0.shape
    S = _slabs(B, L)
    Z0 = _vector("Z0", Z0, (B, L), dev)
    b = _vector("b", b, (B, L), dev)
    A = _vector("A", A, (L,), dev)
    if scale is not None:
        scale = _vector("scale", scale, (L,), dev)
    r, p = torch.empty_like(Z0), torch.empty_like(Z0)
    partial = torch.empty((B, 3, S), dtype=torch.float32, device=dev)
    f = torch.empty((4, B), dtype=torch.float32, device=dev)
    flags = torch.empty((2, B), dtype=torch.bool, device=dev)
    lanes = PcgLanes(rz=f[0], r_norm=f[1], thresh=f[2], beta=f[3],
                     done=flags[0], keep=flags[1],
                     iters=torch.empty((B,), dtype=torch.int32, device=dev))
    _launched(load_library().muse_diag_pcg_start_f32(
        b.data_ptr(), None if scale is None else scale.data_ptr(),
        float(divisor), A.data_ptr(), Z0.data_ptr(), r.data_ptr(),
        p.data_ptr(), partial.data_ptr(), B, L, S, _stream(dev)), "start")
    _finalize(3, partial, lanes, float(c), reduce)
    diag_pcg_start_cuda.launches += 1
    return r, p, lanes


def diag_pcg_update_cuda(x, r, p, A, pAp, lanes: PcgLanes, reduce=None,
                         in_place: bool = False):
    """The kernel of :func:`diag_pcg_update`: float32 on one card; r and,
    with ``in_place``, x are written in place."""
    from .kernels import load_library

    dev = r.device
    B, L = r.shape
    S = _slabs(B, L)
    _vector("r", r, (B, L), dev)
    if not (r.is_contiguous() and (x.is_contiguous() or not in_place)):
        raise ValueError("diag_pcg_update_cuda writes r (and x in place): "
                         "they must be contiguous")
    x_in = _vector("x", x, (B, L), dev)
    p = _vector("p", p, (B, L), dev)
    A = _vector("A", A, (L,), dev)
    pAp = _vector("pAp", pAp, (B,), dev)
    x_out = x if in_place else torch.empty_like(x_in)
    partial = torch.empty((B, 2, S), dtype=torch.float32, device=dev)
    _launched(load_library().muse_diag_pcg_update_f32(
        x_in.data_ptr(), x_out.data_ptr(), r.data_ptr(), p.data_ptr(),
        A.data_ptr(), pAp.data_ptr(), lanes.rz.data_ptr(),
        lanes.done.data_ptr(), partial.data_ptr(), B, L, S, _stream(dev)),
        "update")
    _finalize(2, partial, lanes, 0.0, reduce)
    diag_pcg_update_cuda.launches += 1
    return x_out, r, lanes


def diag_pcg_direction_cuda(r, p, A, lanes: PcgLanes):
    """The kernel of :func:`diag_pcg_direction`: float32 on one card; p is
    written in place."""
    from .kernels import load_library

    dev = r.device
    B, L = r.shape
    S = _slabs(B, L)
    _vector("p", p, (B, L), dev)
    if not p.is_contiguous():
        raise ValueError("diag_pcg_direction_cuda writes p in place: it "
                         "must be contiguous")
    r = _vector("r", r, (B, L), dev)
    A = _vector("A", A, (L,), dev)
    _launched(load_library().muse_diag_pcg_direction_f32(
        r.data_ptr(), p.data_ptr(), A.data_ptr(), lanes.beta.data_ptr(),
        lanes.keep.data_ptr(), B, L, S, _stream(dev)), "direction")
    diag_pcg_direction_cuda.launches += 1
    return p


for _fn in (diag_pcg_start_cuda, diag_pcg_update_cuda,
            diag_pcg_direction_cuda):
    trace.declare(_fn, "launches")


# ---- the dispatch ---------------------------------------------------- #

def _route(cuda, plain, t: torch.Tensor):
    if t.device.type == "cuda":
        return cuda
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"the diagonal PCG has no kernel for {t.device}")


def diag_pcg_start(A, b, Z0, c: float, scale=None, divisor=1.0,
                   reduce=None):
    """The solve's start from the (B, L) warm start ``Z0`` for the (1, L)
    or (L,) diagonal ``A``: (r₀, p₀, :class:`PcgLanes`). The right-hand
    side is the (B, L) ``b``, or with the (L,) ``scale`` scale·b/divisor.
    ``c`` = atol·√nz sets the stop ‖r‖ < c (taken as ``batched_cg`` takes
    the relative tolerance c/‖b‖)."""
    return _route(diag_pcg_start_cuda, diag_pcg_start_plain, Z0)(
        A, b, Z0, c, scale, divisor, reduce)


def diag_pcg_update(x, r, p, A, pAp, lanes: PcgLanes, reduce=None,
                    in_place: bool = False):
    """A step's x and r from its direction ``p`` and curvature ``pAp`` (the
    whole sum, after any ``reduce``): (x, r, the lanes' state). On a card
    r, and x where ``in_place``, are overwritten."""
    return _route(diag_pcg_update_cuda, diag_pcg_update_plain, r)(
        x, r, p, A, pAp, lanes, reduce, in_place)


def diag_pcg_direction(r, p, A, lanes: PcgLanes):
    """The next direction r/A + β·p (p kept where the lane was done before
    the step); on a card p is overwritten."""
    return _route(diag_pcg_direction_cuda, diag_pcg_direction_plain, r)(
        r, p, A, lanes)


# ---- the loop -------------------------------------------------------- #

def batched_diag_pcg(A, b, Z0, grid: tuple, c: float, maxiter: int, *,
                     scale=None, divisor=1.0,
                     reduce: Optional[Callable[[torch.Tensor],
                                               torch.Tensor]] = None):
    """Batched PCG on the diagonal system A·z = b (or scale·b/divisor) from
    ``Z0``, preconditioned by 1/A, stopping a lane at ‖r‖ < c (see
    :func:`diag_pcg_start`). ``grid`` is the fused kernel's view of a (L,)
    vector. Returns ``ops.cg.BatchedCgResult``: x is ``Z0`` itself where no
    step was taken, else a new tensor."""
    from . import grf_spectrum
    from .cg import _CHECK_EVERY, BatchedCgResult, batched_cg

    A_grid = A.reshape(grid)
    r, p, lanes = diag_pcg_start(A, b, Z0, c, scale, divisor, reduce)
    x = Z0
    next_check = 0
    for k in range(maxiter):
        if k == next_check:
            batched_cg.host_syncs += 1
            if bool(lanes.done.all()):
                break
            next_check = max(1, k + min(k, _CHECK_EVERY))
        batched_cg.steps += 1
        pAp = grf_spectrum.spectrum_quadform_and_grad(
            p.reshape((p.shape[0],) + tuple(grid)), A_grid)[0]
        batched_cg.curvature_steps += 1
        if reduce is not None:
            pAp = reduce(pAp)
        x, r, lanes = diag_pcg_update(x, r, p, A, pAp, lanes, reduce,
                                      in_place=x is not Z0)
        p = diag_pcg_direction(r, p, A, lanes)
    return BatchedCgResult(x=x, r_norm=lanes.r_norm, converged=lanes.done,
                           iterations=lanes.iters)
