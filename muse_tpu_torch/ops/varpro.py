"""Batched variable projection (VarPro): the separable nonlinear MAP solver.

Counterpart of ``muse_tpu/ops/varpro.py``. The lensing-style joint MAP

    min_{u_nl, z}  ½‖x − G(u_nl) z‖²/σ² + ½‖u_nl‖² + ½‖z‖²

is separable: the observation is strictly linear in the large block z (the
unlensed field) for any fixed nonlinear block u_nl (the potential). Joint
quasi-Newton over both fights a curved valley, since moving u_nl shifts
the best z. Variable projection removes the valley:

  * inner: for fixed u_nl, z*(u_nl) solves the SPD system
    (I + GᵀG/σ²) z = Gᵀx/σ² by masked lockstep PCG, warm-started across
    outer iterations, with an ABSOLUTE sup-norm stop: the residual b − Az
    is exactly −∇_z f, so sup|r| ≤ ρ certifies the z-block gradient;
  * outer: L-BFGS on the reduced objective f(u_nl, z*(u_nl)), whose
    gradient is, by the envelope theorem, ∂f/∂u_nl at the solved z, taken
    with the value in one autograd pass.

Convergence is certified in the full space, sup|∇f| < g_atol over both
blocks, as in every solver here. The Armijo search re-solves the inner
problem for every trial step and accepts at the float32 floor
``8·eps·|f|``. The curvature history runs on a global clock with per-lane
expiry (:func:`~muse_tpu_torch.ops.lbfgs._two_loop_chrono`): every outer
iteration writes one shared slot of S, Y, ρ and ``valid`` in place, and a
lane that skips the store has that slot invalidated.

Three nested host loops over device state: outer iterations, line-search
trials, inner PCG steps. The masks stay on the device; the host reads
``all(done)`` of each loop before each of its steps, as the JAX loops
test. One inner step here is two batched operator applications of a
dozen field-sized FFTs each, far more than a host read costs, so a step
run past the end (``ops/cg.py``'s sparser schedule) would waste more than
a read saves. One outer iteration costs 1 + Σ_trials (1 + inner steps + 1)
reads.

Under the gathered route of a mesh's field axis (``solver/compiled.py``,
``models/lensing.py``) each rank holds a block of columns of every lane's
u_nl and z vectors and of the history. ``reduce`` sums every per-lane
partial sum (the inner PCG's dot products, the outer dot products and the
two-loop recursion's Gram matrix, :func:`~muse_tpu_torch.ops.lbfgs._two_loop_gram`)
over the axis and ``reduce_max`` takes every sup-norm and finiteness test
as a maximum over it; the caller hands over the operators on those
columns and ``f_and_g``, the whole objective with this rank's columns of
its gradient. With none of them the loops are the ones above, bit for bit.

``batched_varpro.iterations``, ``.ls_trials``, ``.inner_steps`` and
``.host_syncs`` count the outer iterations run, the line-search trials,
the inner PCG steps and the host's reads of a device flag, over all calls.

No reference analog: MuseInference.jl solves every MAP with generic L-BFGS.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..utils import trace
from .lbfgs import _dot, _two_loop_chrono, _two_loop_gram

__all__ = ["VarproResult", "batched_varpro"]

class VarproResult(NamedTuple):
    u_nl: torch.Tensor         # (B, Nnl) nonlinear block at the MAP
    z_lin: torch.Tensor        # (B, Nlin) linear block at the MAP
    f: torch.Tensor            # (B,)  final objective values
    converged: torch.Tensor    # (B,)  bool: full-space sup|∇f| < g_atol
    failed: torch.Tensor       # (B,)  bool: NaN/Inf or line-search stall
    iterations: torch.Tensor   # (B,)  int32 outer (reduced) iterations
    inner_iterations: torch.Tensor  # (B,) int32 cumulative inner CG iters
    g_norm: torch.Tensor       # (B,)  final full-space sup-norm of ∇f


def _sup(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(-1)


def reduced_value_and_grad(obs_op, xs, sigma2: float):
    """``(Unl, Zlin) -> (f, ∂f/∂u_nl)``: the per-lane objective and its
    envelope gradient at the fixed (solved) Zlin, in one autograd pass. The
    lanes are independent, so the gradient of their sum is each lane's
    gradient."""
    B = xs.shape[0]

    def f_and_g(Unl, Z):
        def fval(U):
            res = (xs - obs_op(U, Z)).reshape(B, -1)
            f = 0.5 * (_dot(res, res) / sigma2 + _dot(U, U) + _dot(Z, Z))
            return f.sum(), f
        g, f = torch.func.grad(fval, has_aux=True)(Unl)
        return f, g
    return f_and_g


def batched_varpro(
    obs_op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    xs: torch.Tensor,
    Unl0: torch.Tensor,
    Zlin0: torch.Tensor,
    *,
    sigma2,
    g_atol=1e-2,
    m: int = 10,
    max_outer: int = 200,
    max_ls: int = 15,
    c1: float = 1e-4,
    inner_maxiter: int = 50,
    inner_kappa: float = 0.1,
    precond_lin: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    lin_sup: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    lin_ops: Optional[Callable[[torch.Tensor], Tuple[Callable, Callable]]]
    = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    reduce_max: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    f_and_g: Optional[Callable] = None,
) -> VarproResult:
    """Minimize ½‖x − obs_op(u, z)‖²/σ² + ½‖u‖² + ½‖z‖² in lockstep.

    Args:
      obs_op: batched observation operator ``((B, Nnl), (B, Nlin)) ->
        (B, *obs)``, strictly linear in its second argument
        (``obs_op(u, 0) = 0``) and differentiable by autograd in both.
      xs: (B, *obs) per-lane observations.
      Unl0 / Zlin0: initial iterates (warm starts); not modified.
      g_atol: FULL-space sup-norm gradient tolerance, a scalar or (B,).
      inner_kappa: inner forcing. Each inner solve stops at
        sup|r| ≤ max(κ·sup|g_nl|, 0.5·g_atol), so early solves are loose
        and the last ones certify the z-block gradient.
      precond_lin: optional SPD approximation of (I + GᵀG/σ²)⁻¹ on flat z
        lanes.
      lin_sup: per-lane effective sup-norm of a z-block residual,
        ``(B, Nlin) -> (B,)`` (default: the largest absolute entry). A
        caller whose linear block lives in a rotated basis passes the
        measure of the basis the tolerance was set for.
      lin_ops: optional explicit linearization ``(Unl) -> (G, Gt)``: the
        batched linear operator ``G: (B, Nlin) -> (B, *obs)``
        (= ``obs_op(Unl, ·)``) and its exact adjoint ``Gt: (B, *obs) ->
        (B, Nlin)`` under the Euclidean inner products of both spaces,
        ⟨G z, w⟩ = ⟨z, Gt w⟩. Without it G is ``obs_op(Unl, ·)`` itself and
        Gᵀ its ``torch.func.vjp``, built once per inner solve.
      reduce / reduce_max / f_and_g: the field-axis hooks (module
        docstring), given together with ``lin_ops``: Unl0 and Zlin0 are
        this rank's columns, ``lin_ops``' G takes columns to the whole
        observation and its Gt the whole observation to columns,
        ``precond_lin`` acts on columns, ``lin_sup`` returns the whole
        lane's measure, and ``f_and_g(Unl, Zlin) -> (f, ∂f/∂u_nl)`` the
        whole objective and this rank's columns of its gradient.
    """
    B, Nnl = Unl0.shape
    dev, dtype = Unl0.device, Unl0.dtype
    g_atol = torch.broadcast_to(torch.as_tensor(g_atol, dtype=dtype,
                                                device=dev), (B,))
    sigma2 = float(sigma2)
    Minv = (lambda v: v) if precond_lin is None else precond_lin
    hooked = reduce is not None
    if hooked and (reduce_max is None or f_and_g is None or lin_ops is None):
        raise ValueError("batched_varpro: the field hooks reduce, "
                         "reduce_max and f_and_g go with lin_ops")
    if hooked:
        def dot(a, b):
            return reduce(_dot(a, b))

        def sup(v):
            return reduce_max(_sup(v))

        def finite(f, g):
            bad = reduce_max((~torch.isfinite(g)).any(-1).to(dtype))
            return torch.isfinite(f) & (bad == 0)
    else:
        dot, sup = _dot, _sup

        def finite(f, g):
            return torch.isfinite(f) & torch.isfinite(g).all(-1)
    lsup = sup if lin_sup is None else lin_sup
    eps = torch.finfo(dtype).eps
    count = batched_varpro

    def _inner(Unl, Z0, rho, rho_from_r0=False):
        """PCG on (I + GᵀG/σ²) z = Gᵀx/σ², stopped at sup|r| ≤ rho; with
        ``rho_from_r0`` at max(rho, κ·sup|r₀|), the cold-start forcing
        scaled off the solve's own first residual. Everything that depends
        on u_nl alone (the deflection fields) is computed once per solve,
        by ``lin_ops`` or in the vjp's graph. Returns (Z, sup|r|, the
        iterations each lane took)."""
        if lin_ops is not None:
            G, Gt = lin_ops(Unl)
        else:
            def G(V):
                return obs_op(Unl, V)
            vjp_fn = torch.func.vjp(G, torch.zeros_like(Zlin0))[1]

            def Gt(W):
                return vjp_fn(W)[0]

        def A(V):
            return V + Gt(G(V)) / sigma2

        Z = Z0
        r = Gt(xs) / sigma2 - A(Z0)
        p = Minv(r)
        rz = dot(r, p)
        rs = lsup(r)
        if rho_from_r0:
            rho = torch.maximum(rho, inner_kappa * rs)
        done = rs <= rho
        its = torch.zeros((B,), dtype=torch.int32, device=dev)

        for _ in range(inner_maxiter):
            count.host_syncs += 1
            if bool(done.all()):
                break
            count.inner_steps += 1
            Ap = A(p)
            pAp = dot(p, Ap)
            alpha = rz / torch.where(pAp > 0, pAp, 1.0)
            alpha = torch.where(done | (pAp <= 0), 0.0, alpha)
            Z = Z + alpha[:, None] * p
            r = r - alpha[:, None] * Ap
            del Ap
            z = Minv(r)
            rz1 = dot(r, z)
            # a frozen lane's r does not change, so this is also the
            # sup-norm the solve returns
            rs = lsup(r)
            done1 = done | (rs <= rho) | ~torch.isfinite(rz1)
            beta = torch.where(done1, 0.0,
                               rz1 / torch.where(rz != 0, rz, 1.0))
            p = torch.where(done1[:, None], p, z + beta[:, None] * p)
            its = its + (~done).to(torch.int32)
            rz, done = rz1, done1
        return Z, rs, its

    _f_and_g = (reduced_value_and_grad(obs_op, xs, sigma2)
                if f_and_g is None else f_and_g)

    # the first inner solve and the reduced gradient
    U = Unl0
    Z, rsup, inner_its = _inner(Unl0, Zlin0, 0.5 * g_atol, rho_from_r0=True)
    f, g = _f_and_g(U, Z)
    failed = ~finite(f, g)
    converged = (sup(g) < g_atol) & (rsup < g_atol)
    S = torch.zeros((m, B, Nnl), dtype=dtype, device=dev)
    Y = torch.zeros((m, B, Nnl), dtype=dtype, device=dev)
    rho_h = torch.zeros((m, B), dtype=dtype, device=dev)
    valid = torch.zeros((m, B), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)

    for k in range(max_outer):
        count.host_syncs += 1
        if bool((converged | failed).all()):
            break
        count.iterations += 1
        active = ~(converged | failed)

        if hooked:
            idx = ((k - 1 - torch.arange(m, device=dev)) % m)[:, None] \
                .expand(m, B)
            d, gg = _two_loop_gram(g, S, Y, rho_h, valid, idx, reduce)
        else:
            d = _two_loop_chrono(g, S, Y, rho_h, valid, k, m)
        # safeguard: steepest descent where d is not a descent direction
        dg = dot(d, g)
        descent = dg < 0
        d = torch.where(descent[:, None], d, -g)
        dg = torch.where(descent, dg, -gg if hooked else -_dot(g, g))

        if k == 0:
            gnorm = (torch.sqrt(gg) if hooked
                     else torch.linalg.vector_norm(g, dim=-1))
            alpha = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-12), max=1.0)
        else:
            alpha = torch.ones((B,), dtype=dtype, device=dev)

        # inner forcing for this outer step's trials
        rho_in = torch.maximum(inner_kappa * sup(g), 0.5 * g_atol)
        # Armijo at the float32 floor: at large |f| (field models, |f| ~ n²)
        # the decrease asked for, c1·α·dg, can lie below |f|·eps; the test
        # is then unresolvable, every trial is rejected and the lane
        # stalls. Accepting any non-increase within a few ulps lets such a
        # lane keep moving on its gradient, which float32 still resolves
        f_floor = 8.0 * eps * f.abs()

        # backtracking Armijo on the REDUCED objective: every trial
        # re-solves the inner problem, warm-started from the current Z
        accepted = torch.zeros((B,), dtype=torch.bool, device=dev)
        U_new, Z_new, f_new, g_new, rs_new = U, Z, f, g, rsup
        inner_used = torch.zeros((B,), dtype=torch.int32, device=dev)
        for _ in range(max_ls):
            count.host_syncs += 1
            if bool((accepted | ~active).all()):
                break
            count.ls_trials += 1
            U_try = U + alpha[:, None] * d
            Z_try, rs_try, its = _inner(U_try, Z, rho_in)
            # the gradient of the accepting trial is the next iterate's g
            f_try, g_try = _f_and_g(U_try, Z_try)
            ok = (f_try <= f + c1 * alpha * dg + f_floor) \
                & torch.isfinite(f_try)
            take = ok & ~accepted
            U_new = torch.where(take[:, None], U_try, U_new)
            Z_new = torch.where(take[:, None], Z_try, Z_new)
            f_new = torch.where(take, f_try, f_new)
            g_new = torch.where(take[:, None], g_try, g_new)
            rs_new = torch.where(take, rs_try, rs_new)
            del U_try, Z_try, g_try
            accepted = accepted | ok
            alpha = torch.where(accepted, alpha, alpha * 0.5)
            inner_used = inner_used + torch.where(active, its, 0)
        del d

        step_ok = accepted & active
        U1 = torch.where(step_ok[:, None], U_new, U)
        Z1 = torch.where(step_ok[:, None], Z_new, Z)
        f1 = torch.where(step_ok, f_new, f)
        rs1 = torch.where(step_ok, rs_new, rsup)
        g1 = torch.where(step_ok[:, None], g_new, g)
        del U_new, Z_new, g_new
        bad = ~finite(f1, g1)

        # curvature update on the global clock, in place at [slot]: every
        # iteration advances the one shared slot, and a lane that skips
        # the store has the slot invalidated rather than keeping a pair m
        # iterations old, so slot order stays time order for every lane
        s = U1 - U
        y = g1 - g
        if hooked:
            sy, yy = reduce(torch.stack([_dot(s, y), _dot(y, y)]))
        else:
            sy, yy = _dot(s, y), _dot(y, y)
        store = step_ok & (sy > 1e-10 * yy)
        slot = k % m
        S[slot] = torch.where(store[:, None], s, S[slot])
        Y[slot] = torch.where(store[:, None], y, Y[slot])
        del s, y
        rho_h[slot] = torch.where(store, 1.0 / torch.clamp(sy, min=1e-30),
                                  rho_h[slot])
        valid[slot] = store

        conv = converged | (active & ~bad & (sup(g1) < g_atol)
                            & (rs1 < g_atol))
        failed = failed | (active & bad) | (active & ~accepted & ~conv)
        converged = conv
        iters = iters + active.to(torch.int32)
        inner_its = inner_its + inner_used
        U, Z, f, g, rsup = U1, Z1, f1, g1, rs1

    return VarproResult(u_nl=U, z_lin=Z, f=f, converged=converged,
                        failed=failed, iterations=iters,
                        inner_iterations=inner_its,
                        g_norm=torch.maximum(sup(g), rsup))


trace.declare(batched_varpro, "iterations", "ls_trials", "inner_steps",
              "host_syncs")
