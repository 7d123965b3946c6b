"""Batched trust-region Newton-CG (Steihaug-Toint): the second-order latent
MAP solver.

Counterpart of ``muse_tpu/ops/newton_cg.py``. The lensing objective
½‖x − F(u)‖²/σ² + ½‖u‖² has indefinite Hessians away from its optimum (the
bilinear z×φ coupling of the remap), where quasi-Newton models built from
secant pairs crawl. Here curvature comes from exact Hessian-vector
products, and the Steihaug CG leaves along a direction of negative
curvature instead of stalling on it. Where F is linear the method is exact
preconditioned CG on the normal equations.

The semantics are the JAX function's, to the letter: Eisenstat-Walker
forcing ``‖r‖ ≤ min(cg_rtol_cap, √‖g‖)·‖g‖`` in the inner solve, the
Conn-Gould-Toint radius schedule, the float32 floor ``8·eps·|f|`` on the
actual reduction, the dead-radius test (Δ < 1e-10 fails the lane, checked
before the refresh) and the refresh of Δ every ``tr_refresh`` iterations:
they are why lanes at the float32 resolution of their objective end.
Convergence is the gradient's sup-norm below ``g_atol``, as in every solver
here.

The Hessian-vector product is reverse over reverse: ``torch.func.vjp`` of
the gradient function at the fixed iterate, built once per outer iteration
and applied tens of times by the Steihaug solve (the Hessian is symmetric,
so the vector-Jacobian product of the gradient is the HVP). Its graph
keeps what depends on the iterate alone, so an application pays only for
the part that depends on the vector, which is what JAX's
``jax.linearize`` buys there. ``torch.func.linearize`` computes the same
product by forward over reverse, but traces the function with ``make_fx``
at every call (0.6 s for a 32² lensing objective on a CPU, against 3 ms
for ``vjp``), once per outer iteration.

Both loops are host loops over device state. The done-masks stay on the
device and the host reads them on ``ops/cg.py``'s schedule: before the
first step, after steps 1, 2, 4, … and then every ``_CHECK_EVERY`` steps.
A frozen lane makes every step between two reads a bitwise no-op, so the
result is that of the JAX loops, which test before every step.

``batched_newton_cg.iterations``, ``.cg_steps``, ``.hvps`` and
``.host_syncs`` count the outer iterations run, the Steihaug steps, the
Hessian-vector products and the host's reads of a device flag, over all
calls.

This module minimizes; callers pass the negative log-likelihood.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .cg import _CHECK_EVERY

__all__ = ["NewtonCgResult", "batched_newton_cg"]


class NewtonCgResult(NamedTuple):
    z: torch.Tensor            # (B, N) final iterates
    f: torch.Tensor            # (B,)  final objective values
    g: torch.Tensor            # (B, N) final gradients
    converged: torch.Tensor    # (B,)  bool: sup-norm(g) < g_atol
    failed: torch.Tensor       # (B,)  bool: NaN/Inf or dead trust region
    iterations: torch.Tensor   # (B,)  int32 outer trust-region iterations
    cg_iterations: torch.Tensor  # (B,) int32 cumulative inner CG iterations
    g_norm: torch.Tensor       # (B,)  final sup-norm of the gradient


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _steihaug(hvp, g, delta, Minv, maxiter: int, rtol_cap: float,
              active=None):
    """Batched preconditioned Steihaug-Toint CG for H d = −g, ‖d‖ ≤ Δ.

    Preconditioned search directions, Euclidean trust-region norm. The
    inner tolerance is the Eisenstat-Walker forcing
    ‖r‖ ≤ min(rtol_cap, √‖g‖)·‖g‖. ``active`` masks the lanes the outer
    loop has frozen, so that they do not hold the lockstep loop to their
    tiny forcing tolerance for results that are thrown away. Returns
    (d, boundary_hit, iterations used per lane)."""
    B = g.shape[0]
    g_norm = _norm(g)
    tol = torch.clamp(torch.sqrt(g_norm), max=rtol_cap) * g_norm

    d = torch.zeros_like(g)
    r = -g
    z = Minv(r)
    p = z
    rz = _dot(r, z)
    done = g_norm <= 0.0
    if active is not None:
        done = done | ~active
    bhit = torch.zeros((B,), dtype=torch.bool, device=g.device)
    iters = torch.zeros((B,), dtype=torch.int32, device=g.device)

    def to_boundary(d, p):
        """τ ≥ 0 with ‖d + τp‖ = Δ (d inside the ball, p ≠ 0)."""
        a = _dot(p, p)
        b = 2.0 * _dot(d, p)
        c = _dot(d, d) - delta ** 2
        disc = torch.sqrt(torch.clamp(b * b - 4 * a * c, min=0.0))
        return (-b + disc) / torch.clamp(2 * a, min=1e-30)

    next_check = 0
    for k in range(maxiter):
        if k == next_check:
            batched_newton_cg.host_syncs += 1
            if bool(done.all()):
                break
            next_check = max(1, k + min(k, _CHECK_EVERY))
        batched_newton_cg.cg_steps += 1
        Hp = hvp(p)
        pHp = _dot(p, Hp)
        neg = pHp <= 0

        alpha = rz / torch.where(pHp != 0, pHp, 1.0)
        d_try = d + alpha[:, None] * p
        crossed = _norm(d_try) >= delta
        d_bnd = d + to_boundary(d, p)[:, None] * p

        exit_bnd = (neg | crossed) & ~done
        d = torch.where(done[:, None], d,
                        torch.where(exit_bnd[:, None], d_bnd, d_try))
        del d_try, d_bnd
        r = torch.where((done | exit_bnd)[:, None], r, r - alpha[:, None] * Hp)
        del Hp
        z = Minv(r)
        rz1 = _dot(r, z)
        small = _norm(r) <= tol
        done1 = done | exit_bnd | small | ~torch.isfinite(rz1)
        beta = torch.where(done1, 0.0, rz1 / torch.where(rz != 0, rz, 1.0))
        p = torch.where(done1[:, None], p, z + beta[:, None] * p)
        iters = iters + (~done).to(torch.int32)
        bhit = bhit | exit_bnd
        rz, done = rz1, done1
    return d, bhit, iters


def batched_newton_cg(
    fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    z0: torch.Tensor,
    *,
    g_atol=1e-2,
    max_outer: int = 100,
    cg_maxiter: int = 50,
    cg_rtol_cap: float = 0.25,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    delta_max: float = 1e6,
    eta: float = 0.01,
    tr_refresh: int = 25,
) -> NewtonCgResult:
    """Minimize ``fn`` over a batch of lanes in lockstep (second order).

    Args:
      fn: batched value and gradient, ``(B, N) -> ((B,), (B, N))``, built
        from ``torch.func`` transforms so that its gradient can be
        differentiated once more (the HVP is ``torch.func.vjp`` of it).
      z0: ``(B, N)`` initial iterates (warm starts); not modified.
      g_atol: sup-norm gradient tolerance, a scalar or ``(B,)``.
      cg_maxiter / cg_rtol_cap: the inner Steihaug budget. The outer loop
        owns convergence, so a loose inner tolerance costs outer
        iterations, never correctness.
      precond: optional SPD approximation of H⁻¹ on flat lanes.
      eta: least actual/predicted reduction ratio to accept a step.
      tr_refresh: every this many outer iterations, the lanes still open
        get their radius raised to the preconditioned-gradient scale (the
        initial-radius rule). Repeated rejections can shrink Δ to where the
        predicted reduction lies below the float32 resolution of f; the
        ratio is then rounding noise and the lane cycles without progress.
    """
    B, N = z0.shape
    dev, dtype = z0.device, z0.dtype
    g_atol = torch.broadcast_to(torch.as_tensor(g_atol, dtype=dtype,
                                                device=dev), (B,))
    Minv = (lambda v: v) if precond is None else precond
    eps = torch.finfo(dtype).eps

    def grad_only(U):
        return fn(U)[1]

    def radius(g):
        """The preconditioned-gradient (quasi-Newton) step length."""
        return torch.clamp(_norm(Minv(g)), 1.0, 1e4)

    U = z0
    f, g = fn(U)
    converged = g.abs().amax(-1) < g_atol
    failed = ~(torch.isfinite(f) & torch.isfinite(g).all(-1))
    delta = radius(g)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    cg_iters = torch.zeros((B,), dtype=torch.int32, device=dev)

    next_check = 0
    for k in range(max_outer):
        if k == next_check:
            batched_newton_cg.host_syncs += 1
            if bool((converged | failed).all()):
                break
            next_check = max(1, k + min(k, _CHECK_EVERY))
        batched_newton_cg.iterations += 1
        active = ~(converged | failed)

        # the Hessian at the fixed iterate, applied tens of times: one vjp
        # of the gradient function, whose graph is built here once
        _, vjp_fn = torch.func.vjp(grad_only, U)

        def hvp(v):
            batched_newton_cg.hvps += 1
            return vjp_fn(v)[0]

        d, bhit, cg_its = _steihaug(hvp, g, delta, Minv, cg_maxiter,
                                    cg_rtol_cap, active)

        # predicted reduction of the quadratic model (one more HVP)
        pred = -(_dot(g, d) + 0.5 * _dot(d, hvp(d)))
        del vjp_fn, hvp
        U_try = U + d
        f_try, g_try = fn(U_try)
        # float32-resolution floor on the actual reduction: at large |f| a
        # true small improvement cannot be resolved in f (|f|·eps), which
        # would reject every step and stall the lane
        f_floor = 8.0 * eps * f.abs()
        rho = (f - f_try + f_floor) / torch.where(pred > 0, pred, 1e-30)
        ok = (pred > 0) & (rho > eta) & torch.isfinite(f_try)
        take = ok & active

        U = torch.where(take[:, None], U_try, U)
        f = torch.where(take, f_try, f)
        g = torch.where(take[:, None], g_try, g)
        bad = take & ~torch.isfinite(g_try).all(-1)
        del U_try, g_try

        # trust-radius update (the Conn-Gould-Toint schedule)
        grow = ok & bhit & (rho > 0.75)
        shrink = ~ok | (rho < 0.25)
        delta1 = torch.where(
            grow, torch.clamp(2.0 * delta, max=delta_max),
            torch.where(shrink, 0.25 * torch.clamp(_norm(d), min=1e-30),
                        delta))
        delta1 = torch.where(active, delta1, delta)
        del d

        conv = converged | (take & ~bad & (g.abs().amax(-1) < g_atol))
        # a radius below any representable step is a stall; tested before
        # the refresh, so that a lane whose every direction is rejected
        # until collapse still fails fast
        dead = active & (delta1 < 1e-10)
        failed = failed | (active & bad) | dead

        # the periodic refresh of the radius for lanes that cycle
        if k % tr_refresh == tr_refresh - 1:
            delta1 = torch.where(active & ~conv & ~failed,
                                 torch.maximum(delta1, radius(g)), delta1)

        iters = iters + active.to(torch.int32)
        cg_iters = cg_iters + torch.where(active, cg_its, 0)
        converged, delta = conv, delta1

    return NewtonCgResult(z=U, f=f, g=g, converged=converged, failed=failed,
                          iterations=iters, cg_iterations=cg_iters,
                          g_norm=g.abs().amax(-1))


batched_newton_cg.iterations = 0
batched_newton_cg.cg_steps = 0
batched_newton_cg.hvps = 0
batched_newton_cg.host_syncs = 0
