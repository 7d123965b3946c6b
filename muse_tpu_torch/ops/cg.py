"""Batched conjugate gradients — masked lockstep over lanes.

Counterpart of ``muse_tpu/ops/cg.py``: one loop advances all lanes of a
batch of SPD systems ``A x = b``; a lane that has converged freezes
(α = 0, its x, r and p kept) while the others go on. The done-mask stays
on the device. The host reads ``all(done)`` before the first step, after
steps 1, 2, 4, … and from then on every ``_CHECK_EVERY`` steps: frozen
lanes make the steps between two reads no-ops, so the result is bitwise
the same as reading after every step, with O(log k + k/_CHECK_EVERY)
device→host syncs for k steps. (The packed GRF's preconditioned solves
converge in one step, which the doubling schedule reads at once.)

Two consumers, as in the JAX package: the packed GRF's latent MAP
(``models/grf.py`` ``zhat_cg``, a diagonal operator) and implicit-diff
``get_H``'s per-column solves (``solver/compiled.py``, a Hessian-vector
product). ``matvec_and_curvature`` lets a caller hand over ``(A p, pᵀA p)``
from one fused evaluation (the GRF's ``spectrum_quadform_and_grad``
kernel) in place of ``matvec`` plus a separate ``sum(p·Ap)``.

Under the field axis of a mesh (``parallel/mesh.py``) each rank holds a
slice of every lane's vector. ``reduce`` turns each per-lane sum over that
slice into the sum over the whole vector (``SimsMesh.reduce_field``): the
loop's dot products and squared norms are reduced, two of them stacked
into one call where they fall together, so every rank of a field group
reaches the same done-mask and runs the same number of steps.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["BatchedCgResult", "batched_cg"]

# most loop steps between two of the host's reads of all(done); the reads
# double their spacing up to it
_CHECK_EVERY = 8


class BatchedCgResult(NamedTuple):
    x: torch.Tensor            # (B, N) solutions
    r_norm: torch.Tensor       # (B,)  final residual norms
    converged: torch.Tensor    # (B,)  bool
    iterations: torch.Tensor   # (B,)  int32


def batched_cg(
    matvec: Optional[Callable[[torch.Tensor], torch.Tensor]],
    b: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    *,
    tol=1e-6,
    maxiter: int = 500,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    r0: Optional[torch.Tensor] = None,
    z0: Optional[torch.Tensor] = None,
    b_norm: Optional[torch.Tensor] = None,
    matvec_and_curvature: Optional[Callable] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> BatchedCgResult:
    """Solve SPD systems ``A x = b`` for a batch of lanes in lockstep.

    Args:
      matvec: batched SPD operator, ``(B, N) -> (B, N)``; may be None when
        ``matvec_and_curvature`` and ``r0`` are given.
      b: ``(B, N)`` right-hand sides; may be omitted when ``r0`` and
        ``b_norm`` are given.
      x0: optional warm starts.
      tol: relative residual tolerance ‖r‖/‖b‖, a scalar or ``(B,)``.
      maxiter: most loop steps.
      precond: optional SPD preconditioner M⁻¹, ``(B, N) -> (B, N)``.
      r0 / z0 / b_norm: optional precomputed initial residual ``b − A x0``,
        preconditioned residual ``M⁻¹ r0`` and ‖b‖ per lane.
      matvec_and_curvature: optional ``p -> (A p, Σ p·A p per lane)``, used
        by the loop in place of ``matvec`` and the separate dot product.
      reduce: optional hook applied to every per-lane sum over the latent
        axis (``rz``, ``pAp``, the squared norms behind ‖r‖ and ‖b‖): a
        rank's partial sum in, the global sum out. With None the lanes'
        vectors are whole and the loop is what it always was. A given
        ``b_norm`` must already be global.

    ``batched_cg.steps`` counts the loop steps, whatever the operator,
    ``batched_cg.curvature_steps`` those that called
    ``matvec_and_curvature``, and ``batched_cg.host_syncs`` the host's
    blocking reads of ``all(done)``: one at each check point the loop
    reaches (steps 0, 1, 2, 4, 8, then every ``_CHECK_EVERY``).
    """
    if r0 is None:
        if b is None:
            raise ValueError("batched_cg: need b (or a precomputed r0)")
        r0 = b - matvec(torch.zeros_like(b) if x0 is None else x0)
    if reduce is None:
        def norm(v):
            return torch.linalg.vector_norm(v, dim=-1)

        def dot_and_norm(a, b, v):
            return torch.sum(a * b, -1), norm(v)
    else:
        def norm(v):
            return torch.sqrt(reduce(torch.sum(v * v, -1)))

        def dot_and_norm(a, b, v):
            s = reduce(torch.stack([torch.sum(a * b, -1),
                                    torch.sum(v * v, -1)]))
            return s[0], torch.sqrt(s[1])

    if b_norm is None:
        if b is None:
            raise ValueError("batched_cg: need b_norm when r0 is given")
        b_norm = norm(b)
    if matvec is None and matvec_and_curvature is None:
        raise ValueError("batched_cg: need matvec or matvec_and_curvature")
    B = r0.shape[0]
    x = torch.zeros_like(r0) if x0 is None else x0
    tol = torch.broadcast_to(torch.as_tensor(tol, dtype=r0.dtype,
                                             device=r0.device), (B,))
    Minv = (lambda v: v) if precond is None else precond
    z = Minv(r0) if z0 is None else z0
    thresh = tol * torch.clamp(b_norm, min=1e-30)

    r, p = r0, z
    rz, r_norm = dot_and_norm(r0, z, r0)
    done = r_norm < thresh
    iters = torch.zeros((B,), dtype=torch.int32, device=r0.device)
    next_check = 0
    for k in range(maxiter):
        if k == next_check:
            batched_cg.host_syncs += 1
            if bool(done.all()):
                break
            next_check = max(1, k + min(k, _CHECK_EVERY))
        batched_cg.steps += 1
        if matvec_and_curvature is not None:
            Ap, pAp = matvec_and_curvature(p)
            batched_cg.curvature_steps += 1
        else:
            Ap = matvec(p)
            pAp = torch.sum(p * Ap, -1)
        if reduce is not None:
            pAp = reduce(pAp)
        alpha = rz / torch.where(pAp > 0, pAp, torch.ones_like(pAp))
        alpha = torch.where(done | (pAp <= 0), torch.zeros_like(alpha), alpha)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = Minv(r)
        rz1, r_norm = dot_and_norm(r, z, r)
        beta = torch.where(done, torch.zeros_like(rz1),
                           rz1 / torch.where(rz == 0, torch.ones_like(rz), rz))
        p = torch.where(done[:, None], p, z + beta[:, None] * p)
        iters = iters + (~done).to(torch.int32)
        done = done | (r_norm < thresh) | ~torch.isfinite(rz1)
        rz = rz1
    return BatchedCgResult(x=x, r_norm=r_norm, converged=done,
                           iterations=iters)


batched_cg.steps = 0
batched_cg.curvature_steps = 0
batched_cg.host_syncs = 0
