"""Batched L-BFGS with masked lockstep convergence.

Counterpart of ``muse_tpu/ops/lbfgs.py``: the latent MAP solver of every
problem without its own ``custom_zhat``. One loop advances a (B, N) state
for all lanes at once; a lane that has converged or failed freezes while
the others go on. The semantics are the JAX function's:

  * per-lane ring buffers of (s, y) pairs with a per-lane ``head``: a lane
    advances its write index only when it stores a pair, so its history
    stays in true recency order when lanes store raggedly;
  * a pair is stored only when it passes the curvature check
    ``s·y > 1e-10·y·y``;
  * a non-descent direction falls back to steepest descent;
  * the first step is scaled by ``min(1, 1/‖g‖)``;
  * backtracking Armijo line search (``c1``), halving only the step sizes
    of the lanes that have not accepted yet;
  * a lane that meets NaN or Inf freezes and is marked ``failed``, as is an
    unconverged lane whose line search ran out of trials;
  * convergence is the gradient sup-norm below ``g_atol`` (scalar or (B,)).

The loop is eager. The history is written in place at ``[slot, lanes]``
(an out-of-place select over the (m, B, N) history would copy all of it at
every iteration: 8.5 GB at 101 lanes × 1024²). The done-mask stays on the
device: the host reads ``all(converged | failed)`` after iterations 1, 2,
4, … and from then on every ``_CHECK_EVERY`` iterations, and the line
search reads its all-accepted flag on the same schedule. A frozen lane
makes every iteration between two reads a bitwise no-op, and a trial after
every active lane has accepted changes nothing, so the result is that of
the JAX loop, which tests before every iteration and every trial.

A lane can stall: in float32 an accepted step may leave z, f and g exactly
as they were (the direction is below z's precision and f cannot tell the
difference). From iteration 2 on, such a lane is a fixed point: every later
iteration repeats it bit for bit, and the JAX loop runs on to
``max_iters`` for it alone. Here the loop may end once every lane is
converged, failed or stalled; a stalled lane's iteration count is then
raised by the iterations the JAX loop would still have run, so the result
is the same.

``batched_lbfgs.iterations``, ``.ls_evaluations`` and ``.host_syncs``
count the loop iterations run, the objective evaluations of the line
search and the host's reads of a device flag, over all calls.

:func:`_two_loop_chrono` is the two-loop recursion of the global-clock
history layout that ``ops/varpro.py`` keeps.

Under the gathered route of a mesh's field axis (``solver/compiled.py``)
each rank holds a block of columns of every lane's vectors: z, g, the
history S and Y. ``reduce`` then sums every per-lane partial sum over the
axis and ``reduce_max`` takes every per-lane maximum (the sup-norm, the
finiteness and stall tests), so every rank reaches the same masks and
takes the same branches. The two-loop recursion then runs in coefficient
space (:func:`_two_loop_gram`, the vector-free L-BFGS of Chen, Wang and
Zhou 2014): one reduce of the lanes' Gram matrix of [S; Y; g] gives every
inner product the recursion needs, where the sequential recursion would
take 2m + 2 dependent reductions. With neither hook the loop is the one
above, bit for bit.

This module minimizes; callers pass the negative log-likelihood.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils import trace
from .cg import _CHECK_EVERY

__all__ = ["LbfgsResult", "batched_lbfgs"]


class LbfgsResult(NamedTuple):
    z: torch.Tensor            # (B, N) final iterates
    f: torch.Tensor            # (B,)  final objective values
    g: torch.Tensor            # (B, N) final gradients
    converged: torch.Tensor    # (B,)  bool: sup-norm(g) < g_atol
    failed: torch.Tensor       # (B,)  bool: NaN/Inf met or line search spent
    iterations: torch.Tensor   # (B,)  int32 iterations each lane took
    g_norm: torch.Tensor       # (B,)  final sup-norm of the gradient


def _take_slot(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane slot gather: ``A`` is (m, B, …), ``idx`` (B,) → the (B, …)
    rows ``A[idx[b], b]``."""
    return A[idx, torch.arange(A.shape[1], device=A.device)]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane dot product, (B, N) × (B, N) → (B,)."""
    return (a * b).sum(-1)


def _two_loop_gram(g, S, Y, rho, valid, idx, reduce) -> tuple:
    """The two-loop recursion of lanes whose vectors are this rank's
    columns: (−H⁻¹g on those columns, the reduced ‖g‖² per lane).

    ``idx`` is the (m, B) slot of step j (newest first) of each lane. Every
    inner product of the recursion is an entry of the per-lane Gram matrix
    of [S; Y; g], all of them summed over the field axis by ONE ``reduce``;
    q and r are carried as coefficients on g and the slots of S and Y, and
    the direction is assembled from this rank's columns at the end. An
    invalid slot gets the coefficient 0, as the sequential recursion skips
    it."""
    m, B = S.shape[0], g.shape[0]
    lanes = torch.arange(B, device=g.device)
    gram = torch.cat([torch.einsum("mbn,bn->bm", S, g),
                      torch.einsum("mbn,bn->bm", Y, g),
                      torch.einsum("ibn,jbn->bij", S, Y).reshape(B, -1),
                      torch.einsum("ibn,jbn->bij", Y, Y).reshape(B, -1),
                      _dot(g, g)[:, None]], 1)
    gram = reduce(gram)
    Sg, Yg = gram[:, :m], gram[:, m:2 * m]
    SY = gram[:, 2 * m:2 * m + m * m].reshape(B, m, m)      # S_i·Y_j
    YY = gram[:, 2 * m + m * m:-1].reshape(B, m, m)
    gg = gram[:, -1]
    c_y = torch.zeros((B, m), dtype=g.dtype, device=g.device)
    c_s = torch.zeros_like(c_y)
    alphas = []
    for j in range(m):
        i = idx[j]
        sq = Sg[lanes, i] + (c_y * SY[lanes, i]).sum(-1)       # S_i·q
        a = torch.where(valid[i, lanes], rho[i, lanes] * sq, 0.0)
        c_y[lanes, i] = c_y[lanes, i] - a
        alphas.append(a)
    i = idx[0]
    yy = YY[lanes, i, i]
    gamma = torch.where(valid[i, lanes] & (yy > 0),
                        SY[lanes, i, i] / torch.clamp(yy, min=1e-30), 1.0)
    c_y = c_y * gamma[:, None]
    for j in reversed(range(m)):
        i = idx[j]
        yr = (gamma * Yg[lanes, i] + (c_y * YY[lanes, i]).sum(-1)
              + (c_s * SY[lanes, :, i]).sum(-1))                # Y_i·r
        b = torch.where(valid[i, lanes], rho[i, lanes] * yr, 0.0)
        c_s[lanes, i] = c_s[lanes, i] + alphas[j] - b
    r = gamma[:, None] * g + torch.einsum("bm,mbn->bn", c_y, Y) \
        + torch.einsum("bm,mbn->bn", c_s, S)
    return r.neg_(), gg


def _two_loop(g, S, Y, rho, valid, head, m: int) -> torch.Tensor:
    """Batched two-loop recursion → the direction −H⁻¹g, each lane over its
    own ring newest to oldest (slot ``(head − 1 − j) % m`` for step j)."""
    q = g.clone()
    alphas, newest = [], None
    for j in range(m):
        idx = (head - 1 - j) % m
        v = _take_slot(valid, idx)
        Sj, Yj = _take_slot(S, idx), _take_slot(Y, idx)
        a = torch.where(v, _take_slot(rho, idx) * _dot(Sj, q), 0.0)
        q.addcmul_(a[:, None], Yj, value=-1.0)
        alphas.append(a)
        if j == 0:
            newest = (v, Sj, Yj)

    # γ = s·y / y·y of the newest pair; 1 where it is not a valid pair
    v, Sn, Yn = newest
    yy = _dot(Yn, Yn)
    gamma = torch.where(v & (yy > 0), _dot(Sn, Yn) / torch.clamp(yy, min=1e-30),
                        1.0)
    del newest, Sn, Yn
    r = gamma[:, None] * q
    del q

    for j in reversed(range(m)):
        idx = (head - 1 - j) % m
        v = _take_slot(valid, idx)
        b = torch.where(v, _take_slot(rho, idx) * _dot(_take_slot(Y, idx), r),
                        0.0)
        r.addcmul_((alphas[j] - b)[:, None], _take_slot(S, idx))
    return r.neg_()


def _two_loop_chrono(g, S, Y, rho, valid, head: int, m: int) -> torch.Tensor:
    """Two-loop recursion for the global-clock history layout.

    ``head`` is one host integer for all lanes: every iteration writes (or,
    per lane, invalidates) the same slot, so slot order is time order for
    every lane and the slots are taken by plain indexing, ``S[idx]`` a
    (B, N) view, with no per-lane gather. The caller keeps the expiry
    contract: a lane that skips a store has the overwritten slot's
    ``valid`` cleared and never keeps an m-iterations-old pair, which is
    what makes slot ``(head − 1) % m`` the true newest pair for the γ
    scaling. ``ops/varpro.py`` uses it (its history rows are field-sized);
    :func:`batched_lbfgs` keeps the exact per-lane heads."""
    q = g.clone()
    alphas = []
    for j in range(m):
        idx = (head - 1 - j) % m
        a = torch.where(valid[idx], rho[idx] * _dot(S[idx], q), 0.0)
        q.addcmul_(a[:, None], Y[idx], value=-1.0)
        alphas.append(a)

    newest = (head - 1) % m
    yy = _dot(Y[newest], Y[newest])
    gamma = torch.where(valid[newest] & (yy > 0),
                        _dot(S[newest], Y[newest]) / torch.clamp(yy, min=1e-30),
                        1.0)
    r = q.mul_(gamma[:, None])

    for j in reversed(range(m)):
        idx = (head - 1 - j) % m
        b = torch.where(valid[idx], rho[idx] * _dot(Y[idx], r), 0.0)
        r.addcmul_((alphas[j] - b)[:, None], S[idx])
    return r.neg_()


def batched_lbfgs(
    fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    z0: torch.Tensor,
    *,
    g_atol=1e-2,
    m: int = 10,
    max_iters: int = 500,
    max_ls: int = 25,
    c1: float = 1e-4,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> LbfgsResult:
    """Minimize ``fn`` over a batch of lanes in lockstep.

    Args:
      fn: batched value and gradient, ``(B, N) -> ((B,), (B, N))``.
      z0: ``(B, N)`` initial iterates (warm starts); not modified.
      g_atol: sup-norm gradient tolerance, a scalar or ``(B,)``.
      m: history pairs per lane; max_iters: most loop iterations;
      max_ls: most line-search trials per iteration; c1: Armijo constant.
      reduce / reduce_max: the field-axis hooks (module docstring), given
        together: the lanes' vectors are then this rank's columns, ``fn``
        returns the whole f and this rank's columns of g, ``reduce`` sums
        a (k, B) or (B, k) stack of per-lane partial sums over the axis and
        ``reduce_max`` takes the maximum of one. The result's ``g_norm``
        is then the whole sup-norm.
    """
    B, N = z0.shape
    dev, dtype = z0.device, z0.dtype
    g_atol = torch.broadcast_to(torch.as_tensor(g_atol, dtype=dtype,
                                                device=dev), (B,))
    hooked = reduce is not None
    if hooked != (reduce_max is not None):
        raise ValueError("batched_lbfgs: give reduce and reduce_max together")

    def sup_finite(g):
        """(sup-norm, all-finite) of the whole lanes: one reduce_max."""
        if not hooked:
            return g.abs().amax(-1), torch.isfinite(g).all(-1)
        t = reduce_max(torch.stack([g.abs().amax(-1),
                                    (~torch.isfinite(g)).any(-1).to(dtype)]))
        return t[0], t[1] == 0

    z = z0
    f, g = fn(z)
    g_sup, g_fin = sup_finite(g)
    converged = g_sup < g_atol
    failed = ~(torch.isfinite(f) & g_fin)
    S = torch.zeros((m, B, N), dtype=dtype, device=dev)
    Y = torch.zeros((m, B, N), dtype=dtype, device=dev)
    rho = torch.zeros((m, B), dtype=dtype, device=dev)
    valid = torch.zeros((m, B), dtype=torch.bool, device=dev)
    head = torch.zeros((B,), dtype=torch.int64, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    stalled = torch.zeros((B,), dtype=torch.bool, device=dev)
    lanes = torch.arange(B, device=dev)

    next_check, k_run = 0, max_iters
    for k in range(max_iters):
        if k == next_check:
            batched_lbfgs.host_syncs += 1
            if bool((converged | failed | stalled).all()):
                k_run = k
                break
            next_check = max(1, k + min(k, _CHECK_EVERY))
        batched_lbfgs.iterations += 1
        active = ~(converged | failed)

        if hooked:
            idx = (head[None] - 1 - torch.arange(m, device=dev)[:, None]) % m
            d, gg = _two_loop_gram(g, S, Y, rho, valid, idx, reduce)
            dg = reduce(_dot(d, g))
        else:
            d = _two_loop(g, S, Y, rho, valid, head, m)
            dg = _dot(d, g)
        # safeguard: steepest descent where d is not a descent direction
        descent = dg < 0
        d = torch.where(descent[:, None], d, -g)
        dg = torch.where(descent, dg, -gg if hooked else -_dot(g, g))

        # first step scaled to a unit-ish move (Optim's alphaguess role)
        if k == 0:
            gnorm = (torch.sqrt(gg) if hooked
                     else torch.linalg.vector_norm(g, dim=-1))
            alpha = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0)
        else:
            alpha = torch.ones((B,), dtype=dtype, device=dev)

        # backtracking Armijo line search, lockstep with accept masks
        accepted = torch.zeros((B,), dtype=torch.bool, device=dev)
        z_new, f_new, g_new = z, f, g
        ls_check = 1
        for t in range(1, max_ls + 1):
            z_try = z + alpha[:, None] * d
            f_try, g_try = fn(z_try)
            batched_lbfgs.ls_evaluations += 1
            ok = (f_try <= f + c1 * alpha * dg) & torch.isfinite(f_try)
            take = ok & ~accepted
            z_new = torch.where(take[:, None], z_try, z_new)
            f_new = torch.where(take, f_try, f_new)
            g_new = torch.where(take[:, None], g_try, g_new)
            del z_try, g_try
            accepted = accepted | ok
            alpha = torch.where(accepted, alpha, alpha * 0.5)
            if t == ls_check:
                batched_lbfgs.host_syncs += 1
                if bool((accepted | ~active).all()):
                    break
                ls_check = t + min(t, _CHECK_EVERY)
        del d

        bad = ~(torch.isfinite(f_new) & sup_finite(g_new)[1])
        step_ok = accepted & active & ~bad
        z1 = torch.where(step_ok[:, None], z_new, z)
        f1 = torch.where(step_ok, f_new, f)
        g1 = torch.where(step_ok[:, None], g_new, g)
        del z_new, g_new

        # curvature-checked store into each lane's own ring slot, in place
        s = z1 - z
        y = g1 - g
        if hooked:
            sy, yy = reduce(torch.stack([_dot(s, y), _dot(y, y)]))
            # one reduce_max: g1's sup-norm and whether s or y moved
            moved_sup = reduce_max(torch.stack([
                g1.abs().amax(-1),
                ((s != 0).any(-1) | (y != 0).any(-1)).to(dtype)]))
            g1_sup, unmoved = moved_sup[0], moved_sup[1] == 0
        else:
            sy, yy = _dot(s, y), _dot(y, y)
            g1_sup = g1.abs().amax(-1)
            unmoved = (s == 0).all(-1) & (y == 0).all(-1)
        store = step_ok & (sy > 1e-10 * yy)
        if k > 0:
            stalled = stalled | (step_ok & (f1 == f) & unmoved)
        slot = head % m
        S[slot, lanes] = torch.where(store[:, None], s, S[slot, lanes])
        Y[slot, lanes] = torch.where(store[:, None], y, Y[slot, lanes])
        del s, y
        rho[slot, lanes] = torch.where(store, 1.0 / torch.clamp(sy, min=1e-30),
                                       rho[slot, lanes])
        valid[slot, lanes] = valid[slot, lanes] | store

        conv = converged | (active & (g1_sup < g_atol))
        # a lane whose line search spent every trial cannot make progress
        failed = failed | (active & bad) | (active & ~accepted & ~conv)
        converged = conv
        head = head + store.to(head.dtype)
        iters = iters + active.to(torch.int32)
        z, f, g = z1, f1, g1

    # the iterations the JAX loop runs on a stalled lane after this one ends
    iters = iters + torch.where(stalled & ~(converged | failed),
                                max_iters - k_run, 0).to(torch.int32)
    return LbfgsResult(z=z, f=f, g=g, converged=converged, failed=failed,
                       iterations=iters, g_norm=sup_finite(g)[0])


trace.declare(batched_lbfgs, "iterations", "ls_evaluations", "host_syncs")
