"""J and H estimators for the MUSE covariance.

Counterpart of ``muse_tpu/solver/jacobians.py`` (``get_J!``, reference
``src/muse.jl:484-532``; ``get_H!``, ``src/muse.jl:296-450``):

  * get_J: per-sim [sample at θ₀ → MAP warm-started from the TRUE z →
    ∇θ logLike] as one batch per chunk; J is the corrected sample
    covariance of the per-sim scores (src/muse.jl:529). Incremental: only
    ``nsims − len(result.gs)`` new sims run, and seeds come from the
    superset-prefix ``sim_seeds`` (src/muse.jl:499-506).
  * get_H, finite differences: sims × θ-columns × stencil in one batch per
    chunk (``CompiledProblem.h_fd``), ``fd_order`` 2, 4 or ``"adaptive"``
    (the 4-point stencil with up to two rounds that rebalance the step).
    The step defaults to 0.1σ estimated from ``result.gs``
    (src/muse.jl:411-414).
  * get_H, implicit differentiation (``implicit_diff=True``): per chunk of
    sims, ``CompiledProblem.h_implicit_with`` — jacfwd Jacobians, an HVP and
    one batched CG over sims × θ-columns (src/muse.jl:335-405). Needs the
    problem's CRN white split.

Both also take a PPL model function with ``observed=`` in place of the
problem (src/turing.jl:248-256), and a ``mesh=``
(:class:`~muse_tpu_torch.parallel.SimsMesh`): each chunk's sims are split
over its sims axis, each rank runs its block, and the per-sim results are
gathered to every rank before anything is reduced, so every rank holds
the same ``gs``, ``Hs``, J and H. Its field axis takes either route of
``solver/compiled.py``; the per-sim scores and Hs come out whole on every
rank of a field group. Only global rank 0 writes ``checkpoint_file`` and
draws progress.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..problem import MuseProblem
from ..result import MuseResult
from ..utils import trace
from ..utils.keys import sim_seeds
from ..utils.progress import ProgressReporter
from .compiled import CompiledProblem
from .covariance import finalize_result
from .muse import _as_problem, _host, check_mesh, gather_lanes, lead

__all__ = ["get_J", "get_H", "sample_covariance"]


def sample_covariance(gs: np.ndarray) -> np.ndarray:
    """Corrected sample covariance (src/muse.jl:495,529)."""
    return np.atleast_2d(np.cov(np.asarray(gs), rowvar=False, ddof=1))


def _seed_chunks(seeds, max_batch):
    """Yield the per-sim seeds in chunks of at most ``max_batch`` lanes."""
    step = len(seeds) if max_batch is None else max_batch
    for i in range(0, len(seeds), step):
        yield seeds[i:i + step]


def _setup(result: MuseResult, problem: MuseProblem, theta0, seed, dtype,
           compiled: Optional[CompiledProblem], mesh, site):
    from .muse import _as_seed, _host_flat, resolve_spec

    theta_start = theta0 if theta0 is not None else result.theta
    if theta_start is None:
        raise ValueError("θ₀ must be given (or present in result)")
    spec = resolve_spec(result, theta_start, dtype)
    th = _host_flat(spec, theta_start, site)
    if result.theta is None:
        result.theta = th
    if result.theta_struct is None:
        result.theta_struct = spec.to_user(th)
    result.key = seed = _as_seed(seed, result)
    comp = compiled or CompiledProblem(problem, spec, th, dtype=dtype,
                                       mesh=mesh)
    check_mesh(problem, comp, mesh)
    return spec, th, seed, comp


def _block(mesh, c: int) -> tuple:
    """This rank's block (lo, hi) of a chunk of ``c`` sims."""
    return (0, c) if mesh is None else mesh.lane_block(c)


def _chunk_table(mesh, c: int, width: int, columns) -> np.ndarray:
    """The (c, width) float64 table of a chunk's per-sim results on every
    rank: this rank runs ``columns(lo, hi)`` on its block of sims (arrays
    with hi − lo rows, laid side by side) and the blocks are gathered over
    the sims axis."""
    lo, hi = _block(mesh, c)
    local = np.zeros((hi - lo, width))
    if hi > lo:
        local = np.column_stack([
            np.asarray(v, np.float64).reshape(hi - lo, -1)
            for v in columns(lo, hi)])
    return gather_lanes(mesh, local, lo, c)


@trace.spanned("muse.get_J")
def get_J(
    result: MuseResult,
    problem: MuseProblem,
    theta0=None,
    *,
    seed: Optional[int] = None,
    nsims: int = 100,
    grad_z_atol: float = 1e-2,
    skip_errors: bool = False,
    covariance_method=sample_covariance,
    max_batch=None,
    dtype=torch.float32,
    compiled: Optional[CompiledProblem] = None,
    progress: bool = False,
    warn_reuse: bool = True,
    checkpoint_file: Optional[str] = None,
    observed=None,
    mesh=None,
) -> MuseResult:
    """Monte-Carlo covariance of MAP score gradients at θ₀ (``get_J!``).

    Scores already in ``result.gs`` — including the fit's own per-sim
    scores stored by ``muse_fit`` (src/muse.jl:231) — count toward
    ``nsims``; only the remainder is simulated. Scores are appended per
    device chunk, and ``checkpoint_file`` saves the result after each.
    ``problem`` may be a PPL model function with ``observed=``.
    ``get_J.host_syncs`` counts the blocking device→host reads: three a
    chunk of new sims.
    """
    problem = _as_problem(problem, theta0, observed, "get_J")
    spec, th, seed, comp = _setup(result, problem, theta0, seed, dtype,
                                  compiled, mesh, get_J)
    nth = th.shape[0]
    nsims_existing = len(result.gs)
    nsims_remaining = nsims - nsims_existing

    # reliability mask of reused fit scores (muse_fit stores the final
    # iteration's per-sim MAP convergence)
    drop_reused = np.zeros(nsims_existing, bool)
    gs_mask = result.metadata.get("gs_converged")
    if gs_mask is not None and len(gs_mask) != nsims_existing:
        warnings.warn(
            f"get_J: metadata['gs_converged'] has {len(gs_mask)} entries "
            f"but result.gs holds {nsims_existing} scores — the "
            "reliability mask is stale; discarding it and treating the "
            "existing scores as converged.")
        gs_mask = None
        result.metadata.pop("gs_converged", None)
    if nsims_existing and gs_mask is not None:
        bad = ~np.asarray(gs_mask, bool)
        if bad.any():
            if skip_errors:
                drop_reused = bad
                warnings.warn(
                    f"get_J: dropping {int(bad.sum())}/{nsims_existing} "
                    "reused fit scores whose MAP solves had not converged "
                    "(skip_errors=True).")
            else:
                warnings.warn(
                    f"get_J: {int(bad.sum())}/{nsims_existing} reused fit "
                    "scores come from MAP solves that did not converge — "
                    "J may be inflated. Pass skip_errors=True to drop "
                    "them, or clear result.gs for a fresh estimate.")

    if nsims_existing and warn_reuse:
        warnings.warn(
            f"get_J: reusing {nsims_existing} existing per-sim scores "
            f"(fit or previous get_J); only {max(nsims_remaining, 0)} new "
            "sims will run. Clear result.gs or use a fresh MuseResult for "
            "an independent re-estimate (reference resume semantics, "
            "src/muse.jl:499-506).")
    drop_new = []
    if nsims_remaining > 0:
        seeds = sim_seeds(seed, nsims)[nsims_existing:]
        n_dropped = n_nonconv = n_run = 0
        mask_list = (list(np.asarray(gs_mask, bool))
                     if gs_mask is not None
                     else [True] * nsims_existing)
        th_dev = comp.theta(th)
        pbar = ProgressReporter(nsims_remaining, "get_J",
                                enabled=progress and lead(mesh))
        try:
            for chunk in _seed_chunks(seeds, max_batch):
                c = len(chunk)

                def columns(lo, hi):
                    out = comp.j_sims(chunk[lo:hi], th_dev, grad_z_atol)
                    return (_host(out["g"], get_J),
                            _host(out["failed"], get_J),
                            _host(out["converged"], get_J))

                table = _chunk_table(mesh, c, nth + 2, columns)
                g_c = table[:, :nth]
                failed_c = table[:, nth] > 0
                nonconv_c = ~(table[:, nth + 1] > 0) & ~failed_c
                n_nonconv += int(nonconv_c.sum())
                n_run += c
                if failed_c.any():
                    if not skip_errors:
                        raise RuntimeError(
                            f"get_J: {int(failed_c.sum())}/{c} MAP solves "
                            "failed; pass skip_errors=True to drop them.")
                    n_dropped += int(failed_c.sum())
                    g_c = g_c[~failed_c]
                    nonconv_c = nonconv_c[~failed_c]
                result.gs.extend(list(g_c))
                mask_list.extend(list(~nonconv_c))
                result.metadata["gs_converged"] = np.asarray(mask_list, bool)
                drop_new.extend(list(nonconv_c if skip_errors
                                     else np.zeros(len(g_c), bool)))
                if checkpoint_file is not None and lead(mesh):
                    result.save(checkpoint_file)
                pbar.step(inc=c)
        finally:
            pbar.close()
        if n_nonconv:
            warnings.warn(
                f"get_J: {n_nonconv}/{n_run} MAP solves did not converge "
                "within tolerance; their scores feed J unconverged "
                "(reference semantics, src/interface.jl:168-171).")
        if n_dropped:
            warnings.warn(f"get_J: dropping {n_dropped} failed sims")

    gs = np.asarray(result.gs)
    drop = np.concatenate([drop_reused, np.asarray(drop_new, bool)]) \
        if (drop_reused.any() or any(drop_new)) else None
    if drop is not None and len(drop) == len(gs):
        if (~drop).sum() < 2:
            raise RuntimeError(
                "get_J: fewer than 2 reliable per-sim scores remain after "
                "dropping unconverged/failed MAPs — rerun with a larger "
                "nsims or looser grad_z_atol.")
        gs = gs[~drop]
    result.J = (np.atleast_2d(np.var(gs, ddof=1)) if gs.shape[1] == 1
                and gs.ndim == 2 else covariance_method(gs))
    finalize_result(result, comp)
    return result


get_J.host_syncs = 0


@trace.spanned("muse.get_H")
def get_H(
    result: MuseResult,
    problem: MuseProblem,
    theta0=None,
    *,
    seed: Optional[int] = None,
    nsims: int = 10,
    grad_z_atol: float = 1e-2,
    step=None,
    fd_order: int = 2,
    skip_errors: bool = False,
    implicit_diff: bool = False,
    implicit_diff_H1_is_zero: bool = False,
    implicit_diff_cg_maxiter: int = 100,
    implicit_diff_cg_tol: float = 1e-6,
    implicit_diff_precond=None,
    implicit_fit_atol: float = 1e-1,
    max_batch=None,
    dtype=torch.float32,
    compiled: Optional[CompiledProblem] = None,
    progress: bool = False,
    checkpoint_file: Optional[str] = None,
    observed=None,
    mesh=None,
) -> MuseResult:
    """Mean Jacobian of the MAP score wrt the sim-generation θ (``get_H!``).

    Finite differences: ``fd_order=2`` central differences, ``fd_order=4``
    the 5-point Richardson stencil. ``fd_order="adaptive"`` plays the role
    of the reference's adaptive ``central_fdm(3,1)`` (src/muse.jl:300): it
    runs the 4-offset stencil, estimates per θ-column the truncation error
    from the ε-vs-2ε discrepancy and the float32 roundoff floor from the
    score's scale, rebalances the step ε* = ε·(round/trunc)^⅓ (clipped to
    [0.05, 20]) and runs again, at most three rounds in all, until the two
    are within 10× of each other. The fiducial MAPs of round 1 are reused;
    each round's steps and estimates land in
    ``result.metadata["fd_adaptive"]``, and Hs land once, after the last
    round.

    ``implicit_diff=True``: the exact implicit-function estimator, with the
    fiducial MAPs at ``implicit_fit_atol`` (the reference's coarse 1e-1,
    src/muse.jl:344) and the A⁻¹ columns by CG at
    ``implicit_diff_cg_tol``/``implicit_diff_cg_maxiter``, preconditioned
    by ``implicit_diff_precond(w, x, θ_flat)`` (the ``Pl`` hook,
    src/muse.jl:312); the per-column CG residuals land in
    ``result.metadata["implicit_diff_cg_resid"]``. Otherwise per-sim
    Jacobians land in ``result.Hs`` per device chunk (``result.Hs`` counts
    toward ``nsims``, src/muse.jl:317-319). ``problem`` may be a PPL model
    function with ``observed=``. ``get_H.host_syncs`` counts the blocking
    device→host reads: two a chunk of sims (implicit-diff or a stencil
    pass)."""
    if not implicit_diff:
        if fd_order == 2:
            offsets = np.array([1.0, -1.0])
            weights = np.array([0.5, -0.5])
        elif fd_order == 4 or fd_order == "adaptive":
            offsets = np.array([1.0, -1.0, 2.0, -2.0])
            weights = np.array([8.0, -8.0, -1.0, 1.0]) / 12.0
        else:
            raise ValueError("fd_order must be 2, 4 or 'adaptive'")

    problem = _as_problem(problem, theta0, observed, "get_H")
    spec, th, seed, comp = _setup(result, problem, theta0, seed, dtype,
                                  compiled, mesh, get_H)
    ntheta = th.shape[0]
    nsims_existing = len(result.Hs)
    nsims_remaining = nsims - nsims_existing
    if nsims_remaining <= 0:
        _reduce_H(result, comp)
        return result

    seeds = sim_seeds(seed, nsims, salt=1)[nsims_existing:]
    th_dev = comp.theta(th)

    if implicit_diff:
        _implicit_H(result, comp, seeds, th_dev, implicit_fit_atol,
                    implicit_diff_cg_maxiter, implicit_diff_cg_tol,
                    implicit_diff_H1_is_zero, implicit_diff_precond,
                    skip_errors, max_batch, progress, checkpoint_file, mesh)
        _reduce_H(result, comp)
        return result

    # FD step ≈ 0.1σ from the J sims (src/muse.jl:411-414)
    if step is None:
        if not result.gs:
            raise ValueError(
                "get_H: no `step` given and result.gs is empty — run "
                "get_J first (src/muse.jl:284-286) or pass `step`.")
        step = 0.1 / np.std(np.asarray(result.gs), axis=0, ddof=1)
    step = np.array(np.broadcast_to(np.asarray(step, np.float64),
                                    (ntheta,)))

    def to_Hs(g, failed, step_used):
        # stale-stencil guard: bitwise-identical ±ε gradients mean the
        # perturbed MAP re-solves never moved ẑ, so H entries that flow
        # only through ẑ are exactly zero
        stale = np.all(g[:, :, 0, :] == g[:, :, 1, :], axis=0)
        if stale.any() and g.shape[0] > 0:
            cols = sorted({int(j) for j, _ in np.argwhere(stale)})
            warnings.warn(
                "get_H (FD mode): the ±ε stencil gradients are bitwise "
                f"identical for θ_sim column(s) {cols} on "
                f"{int(stale.sum())} (column, row) pairs — the perturbed "
                "MAP re-solves did not move ẑ, so H entries that flow "
                "only through ẑ are exactly zero and σθ will be wrong. "
                "Tighten grad_z_atol (e.g. 1e-4).")
        # H_sim[i,j] = d g_i / d θsim_j (columns = perturbed θ component)
        Hs = np.einsum("njsi,s->nji", g, weights) / step_used[None, :, None]
        Hs = np.swapaxes(Hs, 1, 2)       # → (n, nθ rows, nθ cols)
        bad = failed | ~np.isfinite(Hs).all(axis=(1, 2))
        if bad.any() and not skip_errors:
            raise RuntimeError(
                f"get_H: {int(bad.sum())}/{bad.size} FD sims failed; "
                "pass skip_errors=True to drop them.")
        return Hs[~bad], int(bad.sum())

    adaptive = fd_order == "adaptive"
    n_fd = ntheta * len(offsets)
    pbar = ProgressReporter(nsims_remaining * (1 + n_fd), "get_H",
                            enabled=progress and lead(mesh))
    # the fiducial MAPs do not depend on the step: later adaptive rounds
    # reuse round 1's, chunk by chunk
    fid = []

    def fd_pass(step_now, commit=None):
        """One stencil pass over every chunk of sims. ``commit(g_c,
        failed_c)`` takes each chunk as it completes; without it the pass
        returns every chunk's g and failed flags, concatenated."""
        g_parts, failed_parts = [], []
        g_shape = (ntheta, len(offsets), ntheta)
        for ci, chunk in enumerate(_seed_chunks(seeds, max_batch)):
            c = len(chunk)
            lo, hi = _block(mesh, c)
            if ci < len(fid):
                Zfid = fid[ci]
            else:
                # warm starts for every FD evaluation (src/muse.jl:417-423;
                # each sim uses its own seed)
                Zfid = (comp.h_fiducial(chunk[lo:hi], th_dev,
                                        grad_z_atol)["Z"] if hi > lo
                        else None)
                if adaptive:
                    fid.append(Zfid)
                pbar.step(inc=c, msg="fiducial fits")

            def columns(lo, hi):
                out = comp.h_fd(chunk[lo:hi], th_dev, step_now, Zfid,
                                grad_z_atol, offsets)
                return (_host(out["g"], get_H),
                        _host(out["failed"], get_H).any(axis=(1, 2)))

            table = _chunk_table(mesh, c, int(np.prod(g_shape)) + 1,
                                 columns)
            g_c = table[:, :-1].reshape((c,) + g_shape)
            failed_c = table[:, -1] > 0
            if commit is not None:
                commit(g_c, failed_c)
            else:
                g_parts.append(g_c)
                failed_parts.append(failed_c)
            pbar.step(inc=c * n_fd, msg="FD columns")
        if commit is None:
            return np.concatenate(g_parts), np.concatenate(failed_parts)

    n_dropped = 0
    try:
        if not adaptive:
            # a fixed step makes each chunk's Hs final: commit them at once
            def commit(g_c, failed_c):
                nonlocal n_dropped
                Hs_c, dropped = to_Hs(g_c, failed_c, step)
                n_dropped += dropped
                result.Hs.extend(list(Hs_c))
                if checkpoint_file is not None and lead(mesh):
                    result.save(checkpoint_file)

            fd_pass(step, commit)
        else:
            rounds = []
            for round_i in range(3):
                if round_i:
                    pbar.grow(nsims_remaining * n_fd)
                step_used = step.copy()
                g, failed = fd_pass(step)        # (nsims, nθ, 4, nθ)
                # per-column error balance: truncation of the ε estimate ≈
                # |d_ε − d_2ε|/3, roundoff ≈ eps_f32·scale(g)/ε; c·ε² = δ/ε
                # balances at ε* = ε·(round/trunc)^(1/3)
                d_e = (g[:, :, 0, :] - g[:, :, 1, :]) / (
                    2 * step[None, :, None])
                d_2e = (g[:, :, 2, :] - g[:, :, 3, :]) / (
                    4 * step[None, :, None])
                trunc = np.sqrt(np.mean((d_e - d_2e) ** 2, axis=(0, 2))) / 3
                g_scale = np.sqrt(np.mean(g ** 2, axis=(0, 2, 3)))
                roundoff = np.finfo(np.float32).eps * g_scale / step
                ratio = roundoff / np.maximum(trunc, 1e-300)
                rounds.append({"step": step.copy(), "trunc": trunc,
                               "roundoff": roundoff})
                if np.all((ratio > 0.1) & (ratio < 10.0)):
                    break                        # balanced within 10×
                step = step * np.clip(ratio ** (1.0 / 3.0), 0.05, 20.0)
                if mesh is not None:
                    step = mesh.broadcast_host(step)    # rank 0's next step
            result.metadata["fd_adaptive"] = rounds
            Hs, n_dropped = to_Hs(g, failed, step_used)
            result.Hs.extend(list(Hs))
            if checkpoint_file is not None and lead(mesh):
                result.save(checkpoint_file)
    finally:
        pbar.close()
    if n_dropped:
        warnings.warn(f"get_H: dropping {n_dropped} failed sims")

    _reduce_H(result, comp)
    return result


get_H.host_syncs = 0


def _implicit_H(result, comp, seeds, th_dev, fit_atol, cg_maxiter, cg_tol,
                h1_is_zero, precond, skip_errors, max_batch, progress,
                checkpoint_file, mesh):
    """get_H's implicit-diff mode, one device chunk of sims at a time."""
    h_impl = comp.h_implicit_with(precond)
    resid_store = result.metadata.setdefault("implicit_diff_cg_resid", [])
    nth = th_dev.shape[0]
    n_dropped = 0
    pbar = ProgressReporter(len(seeds), "get_H",
                            enabled=progress and lead(mesh))
    try:
        for chunk in _seed_chunks(seeds, max_batch):
            c = len(chunk)

            def columns(lo, hi):
                Hs_c, resid_c = h_impl(chunk[lo:hi], th_dev, fit_atol,
                                       cg_maxiter, cg_tol, h1_is_zero)
                with trace.span("muse.get_H.read"):
                    return _host(Hs_c, get_H), _host(resid_c, get_H)

            table = _chunk_table(mesh, c, nth * nth + nth, columns)
            Hs_c = table[:, :nth * nth].reshape(c, nth, nth)
            resid_c = table[:, nth * nth:].astype(np.float32)
            bad = ~np.isfinite(Hs_c).all(axis=(1, 2))
            if bad.any():
                if not skip_errors:
                    raise RuntimeError(
                        f"get_H: {int(bad.sum())}/{c} implicit-diff sims "
                        "produced non-finite H; pass skip_errors=True.")
                n_dropped += int(bad.sum())
                Hs_c, resid_c = Hs_c[~bad], resid_c[~bad]
            result.Hs.extend(list(Hs_c))
            resid_store.extend(list(resid_c))
            if checkpoint_file is not None and lead(mesh):
                result.save(checkpoint_file)
            pbar.step(inc=c)
    finally:
        pbar.close()
    if n_dropped:
        warnings.warn(f"get_H: dropping {n_dropped} failed sims")


def _reduce_H(result: MuseResult, comp: CompiledProblem):
    if result.Hs:
        result.H = np.mean(np.asarray(result.Hs, np.float64), axis=0)
    finalize_result(result, comp)
