"""The MUSE solver — outer quasi-Newton root-finder on the MUSE score.

Counterpart of ``muse_tpu/solver/muse.py`` (``muse``/``muse!``, reference
``src/muse.jl:61-250``): the per-simulation work of an iteration is one
batched device call per lane chunk (``CompiledProblem.muse_step``); the
rest — score assembly, H⁻¹ estimation (sims variance or Broyden replay),
the damped Newton step, the convergence test — is tiny dense linear
algebra over θ on the host in float64, as the reference does it.

With ``hoist_sampling`` (the default) and a problem that declares the CRN
white split, the whites are drawn once per fit and every iteration runs
``muse_step_white``; otherwise every iteration re-samples in ``muse_step``.

``mesh`` (a :class:`~muse_tpu_torch.parallel.SimsMesh`, one process per
device) splits the lanes of every chunk over its sims axis: each rank runs
its block, the per-lane results are gathered to every rank, every rank
runs the float64 host update, and global rank 0's stop decision and new θ
are broadcast, so no rank leaves the loop alone. Its field axis splits
every lane's latent, on the route ``CompiledProblem`` picks: the
sharded-sum route for a problem built with that ``mesh=``, the gathered
route for any other (``solver/compiled.py``). ``profile_dir`` traces
the iteration loop with ``torch.profiler``, the port's spans on
(``utils/trace.py``).

Left out: ``certify`` and the odd-lane padding (TPU compiler guards).
"""

from __future__ import annotations

import contextlib
import math
import time as _time
import warnings
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..problem import MuseProblem
from ..result import MuseResult
from ..theta import ThetaSpec
from ..utils import trace
from ..utils.keys import dummy_seed, sim_seeds
from ..utils.progress import ProgressReporter
from ..utils.tree import tree_map
from .compiled import CompiledProblem

__all__ = ["muse", "muse_fit"]


def _read(t, site) -> np.ndarray:
    """``t`` on the host: one blocking device→host read, counted in
    ``site.host_syncs`` (the function that reads)."""
    site.host_syncs += 1
    return t.detach().cpu().numpy()


def _host(t, site) -> np.ndarray:
    """:func:`_read`, in float64."""
    return _read(t, site).astype(np.float64)


def muse(problem: MuseProblem, theta0, *, observed=None,
         **kwargs) -> MuseResult:
    """One-shot MUSE estimate (``muse`` wrapper, src/muse.jl:107).

    ``problem`` may also be a PPL model function with ``observed={site:
    value}`` (``muse!(result, model, θ₀)``, src/turing.jl:248-256); its
    hyper sites are the keys of ``theta0`` (``ppl.model_problem``)."""
    problem = _as_problem(problem, theta0, observed, "muse")
    return muse_fit(MuseResult(), problem, theta0, **kwargs)


def _as_problem(problem, theta0, observed, who: str):
    """A PPL model function with ``observed=`` as its
    :class:`~muse_tpu_torch.ppl.PPLMuseProblem`, a problem as it is."""
    if callable(problem) and not isinstance(problem, MuseProblem):
        if observed is None:
            raise ValueError(
                f"{who} on a model function needs observed={{site: value}} "
                "to condition the model (the `model | (;x)` analog)")
        if theta0 is None:
            raise ValueError(f"{who} on a model function needs θ₀ (its "
                             "hyper sites are inferred from its keys)")
        from ..ppl import model_problem
        return model_problem(problem, theta0, observed=observed)
    if observed is not None:
        raise ValueError("observed= is only valid with a model function")
    return problem


def resolve_spec(result: MuseResult, theta_start, dtype) -> ThetaSpec:
    """Rebuild/attach the θ structure spec: prefer the live spec, then the
    checkpointed user structure, then the given θ₀."""
    if result._spec is not None:
        spec = result._spec
    elif result.theta_struct is not None:
        spec = ThetaSpec.from_example(result.theta_struct, dtype=dtype)
    else:
        spec = ThetaSpec.from_example(theta_start, dtype=dtype)
    result._spec = spec
    result.theta_names = spec.names
    return spec


def _as_seed(seed, result) -> int:
    if seed is not None:
        return int(seed)
    return int(result.key) if result.key is not None else 0


def check_mesh(problem: MuseProblem, comp: CompiledProblem, mesh) -> None:
    """Raise unless ``mesh`` can run ``problem``: the mesh's device is the
    problem's (no sharded work lands on the CPU when the card was asked
    for), a problem built with a field axis is solved with that mesh, and
    a ``compiled=`` problem was built for this mesh's route
    (``CompiledProblem(mesh=)``)."""
    name = problem.name or type(problem).__name__
    field = problem.field_mesh
    if mesh is None:
        if field is not None:
            raise ValueError(f"{name} was built with a field axis: pass its "
                             "mesh= to the solver too")
        if comp.gathered:
            raise ValueError(f"the compiled {name} was built for a "
                             "field-axis mesh: pass that mesh= too")
        return
    if comp.device != mesh.device:
        raise ValueError(f"{name} lives on {comp.device} but this rank's "
                         f"mesh device is {mesh.device}")
    if field is not None and field is not mesh:
        raise ValueError(f"{name} was built with another mesh than the "
                         "solver's")
    if field is None and mesh.field_axis is not None \
            and comp.cols.mesh is not mesh:
        raise ValueError(f"the compiled {name} was built for another mesh "
                         "than the solver's: build it with mesh=")


def lane_blocks(mesh, bounds) -> list:
    """This rank's block (start, stop) of global lanes in each chunk
    (start, stop) of ``bounds``: the whole chunk without a mesh."""
    if mesh is None:
        return list(bounds)
    return [tuple(s0 + b for b in mesh.lane_block(e0 - s0))
            for s0, e0 in bounds]


def gather_lanes(mesh, local, lo: int, n: int) -> np.ndarray:
    """Every lane's float64 row of an (n, …) table, from this rank's block
    ``local`` starting at lane ``lo`` (the table itself without a mesh)."""
    if mesh is None:
        return np.asarray(local, np.float64)
    return mesh.gather_sims(local, lo, n)


def lead(mesh) -> bool:
    """Whether this process writes checkpoints and draws progress: global
    rank 0, or the only process."""
    return mesh is None or mesh.rank == 0


def _profiler(profile_dir, device, mesh):
    """A ``torch.profiler.profile`` of the loop that writes one trace per
    rank into ``profile_dir`` (CPU activity, and the card's on one)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    worker = None if mesh is None else f"rank{mesh.rank}"
    return profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
        str(profile_dir), worker_name=worker))


@trace.spanned("muse.fit")
def muse_fit(
    result: MuseResult,
    problem: MuseProblem,
    theta0=None,
    *,
    seed: Optional[int] = None,
    z0=None,
    maxsteps: int = 50,
    theta_rtol: float = 1e-1,
    grad_z_atol: float = 1e-2,
    nsims: int = 100,
    alpha: Union[float, Callable[[int], float]] = 0.7,
    progress: bool = False,
    regularize: Optional[Callable] = None,
    Hinv_like=None,
    Hinv_update: str = "sims",
    broyden_memory: float = math.inf,
    checkpoint_file: Optional[str] = None,
    get_covariance: bool = False,
    save_maps=False,
    max_batch: Optional[int] = None,
    mesh=None,
    dtype=torch.float32,
    compiled: Optional[CompiledProblem] = None,
    profile_dir: Optional[str] = None,
    hoist_sampling: bool = True,
    observed=None,
) -> MuseResult:
    """Run/resume the MUSE iteration on ``result`` (``muse!`` analog).

    Arguments follow ``muse_tpu.muse_fit``; ``seed`` (an int, stored in
    ``result.key``) takes the place of the PRNG key. ``max_batch`` bounds
    the lanes of one device call; the last chunk may be smaller.
    ``hoist_sampling``: when the problem declares the CRN white split
    (``sample_white``/``x_of_white``), draw the θ-independent whites once
    per fit, keeping only the parts x depends on, and run
    ``muse_step_white`` at every iteration — the keyed path's math with the
    RNG out of the loop. False re-samples every iteration. ``problem`` may
    be a PPL model function with ``observed=``, as in :func:`muse`.

    ``mesh``: a :class:`~muse_tpu_torch.parallel.SimsMesh`, passed alike by
    every rank. ``max_batch`` bounds the GLOBAL lanes of one call, as in
    JAX; each rank runs its contiguous block of every chunk (a rank may
    hold none and still joins every collective). ``result`` ends up the
    same on every rank: θ, the history, ``gs`` and J and H. With
    ``save_maps`` the maps are gathered to every rank. Only global rank 0
    writes ``checkpoint_file`` and draws the progress bar.

    ``profile_dir``: trace the iteration loop with ``torch.profiler`` (CPU
    activity, plus the card's on one) and write one trace file per rank
    there (``tensorboard_trace_handler``). The port's spans
    (``utils/trace.py``) are on for the loop: each chunk's step sits in a
    ``muse.fit.step`` span, its reads in ``muse.fit.read`` and the host's
    θ update in ``muse.fit.update``.

    ``muse_fit.host_syncs`` counts the blocking device→host reads: one for
    the transformed θ₀ (two if θ₀ is a tensor), then per outer iteration
    five a chunk (four where the MAP solver reports no iteration counts),
    four for the θ update, and with ``save_maps=True`` one a kept map.
    """
    problem = _as_problem(problem, theta0 if theta0 is not None
                          else result.theta_struct, observed, "muse_fit")
    if Hinv_update not in ("sims", "broyden", "diagonal_broyden"):
        raise ValueError(f"invalid Hinv_update={Hinv_update!r}")

    result.key = seed = _as_seed(seed, result)
    theta_start = result.theta if result.theta is not None else theta0
    if theta_start is None:
        raise ValueError("θ₀ must be given (or present in result)")
    spec = resolve_spec(result, theta_start, dtype)

    th = _host_flat(spec, theta_start, muse_fit)
    result.theta_struct = spec.to_user(th)

    comp = compiled or CompiledProblem(problem, spec, th, dtype=dtype,
                                       mesh=mesh)
    check_mesh(problem, comp, mesh)
    dev = comp.device
    th_t = _host(comp.transform(comp.theta(th)), muse_fit)
    th_unreg, th_t_unreg = th.copy(), th_t.copy()
    nth = th.shape[0]

    alpha_fn = alpha if callable(alpha) else (lambda i, a=alpha: a)
    save_sims_maps = save_maps is not False
    if save_maps is True:
        save_maps = lambda z: _read(z, muse_fit)
    elif save_maps is False:
        save_maps = lambda z: None

    history = result.history

    # per-lane seeds: lane 0 is the data lane (its sample is replaced by
    # x_obs inside muse_step), lanes 1.. are the fixed CRN sims
    B = nsims + 1
    seeds_all = [dummy_seed(seed)] + sim_seeds(seed, nsims)
    lane_ids = torch.arange(B, device=dev)

    if z0 is not None:
        z0_flat = comp.zspec.flatten(tree_map(
            lambda v: torch.as_tensor(v, dtype=dtype, device=dev), z0))
        if z0_flat.numel() == comp.field_size:
            z0_flat = z0_flat[comp.field_slice]     # this rank's share
    else:
        z0_flat = torch.zeros(comp.nz, dtype=dtype, device=dev)

    # memory-bounded lane chunks of at most max_batch global lanes; under
    # a mesh this rank runs its block of each
    step_sz = B if max_batch is None else min(max_batch, B)
    bounds = [(s0, min(s0 + step_sz, B)) for s0 in range(0, B, step_sz)]
    blocks = lane_blocks(mesh, bounds)
    Z_chunks = [z0_flat.expand(b - a, comp.nz).clone() for a, b in blocks]
    use_white = bool(hoist_sampling) and problem.x_of_white is not None \
        and problem.sample_white is not None
    W_chunks = ([comp.sample_whites(seeds_all[a:b], x_only=True)
                 for a, b in blocks] if use_white else None)

    pbar = ProgressReporter(maxsteps - len(history), "MUSE",
                            enabled=progress and lead(mesh))
    prof = (_profiler(profile_dir, dev, mesh) if profile_dir
            else contextlib.nullcontext())
    traced = trace.enabled()
    if profile_dir:
        trace.enable(True)
    try:
      with prof:
        for i in range(len(history) + 1, maxsteps + 1):
            t0 = _time.perf_counter()

            # convergence check (src/muse.jl:163-165), rank 0's under a mesh
            with trace.span("muse.fit.update"):
                stop = i > 2 and _theta_converged(history, theta_rtol, i)
                if mesh is not None:
                    stop = bool(mesh.broadcast_host(stop)[0])
            if stop:
                _warn_midmarch_stop(history, theta_rtol, nsims)
                break

            th_dev = comp.theta(th)
            th_t_dev = comp.theta(th_t)
            # every lane's [g, g_t, converged, failed, iterations]; this
            # rank fills its own lanes
            table = np.zeros((B, 2 * nth + 3))
            zhat_dat = None
            zhat_sims_parts = []
            for ci, ((s0, e0), (a, b)) in enumerate(zip(bounds, blocks)):
                if b > a:
                    with trace.span("muse.fit.step"):
                        out = _chunk_step(comp, use_white, th_dev, th_t_dev,
                                          W_chunks, seeds_all, Z_chunks, ci,
                                          a, b, lane_ids, grad_z_atol)
                    Z_chunks[ci] = out["Z"]
                    with trace.span("muse.fit.read"):
                        it = out.get("iterations", 0)
                        it = (_host(it, muse_fit)
                              if isinstance(it, torch.Tensor)
                              else np.asarray(it))
                        table[a:b] = np.column_stack([
                            _host(out["g"], muse_fit),
                            _host(out["g_t"], muse_fit),
                            _host(out["converged"], muse_fit),
                            _host(out["failed"], muse_fit),
                            it if it.ndim else np.full(b - a, int(it))])
                if save_sims_maps:
                    Zc = Z_chunks[ci]
                    if mesh is not None:
                        Zc = mesh.gather_maps(
                            Zc, a - s0, e0 - s0, comp.field_slice,
                            comp.field_size)
                    if ci == 0:
                        zhat_dat = Zc[0]
                    zhat_sims_parts.append(Zc[1 if ci == 0 else 0:])
            with trace.span("muse.fit.read"):
                table = gather_lanes(mesh, table, 0, B)
            with trace.span("muse.fit.update"):
                g = table[:, :nth]                          # (nsims+1, nθ)
                g_t = table[:, nth:2 * nth]
                out = {"converged": table[:, 2 * nth] > 0,
                       "failed": table[:, 2 * nth + 1] > 0,
                       "iterations": table[:, 2 * nth + 2].astype(np.int32)}
                g_dat, g_sims = g[0], g[1:]
                g_dat_t, g_sims_t = g_t[0], g_t[1:]

                # the MUSE score (src/muse.jl:183-185)
                g_like_t = g_dat_t - g_sims_t.mean(axis=0)
                g_prior_t = _host(comp.prior_grad_t(th_t_dev), muse_fit)
                g_post_t = g_like_t + g_prior_t

                # H⁻¹ via sims variance / Broyden replay (src/muse.jl:188-205)
                var_sims = g_sims_t.var(axis=0, ddof=1)
                if (var_sims <= 0).any() or not np.isfinite(var_sims).all():
                    bad = [result.theta_names[k] if k < len(result.theta_names)
                           else str(k)
                           for k in np.where(~(var_sims > 0))[0]]
                    raise RuntimeError(
                        f"MUSE iteration {i}: zero/non-finite score variance "
                        f"for θ component(s) {bad}. A hyper-parameter whose "
                        "score has no simulation scatter does not affect the "
                        "observed data and cannot be estimated by MUSE — "
                        "check the model structure.")
                Hinv_like_sims = np.diag(-1.0 / var_sims)
                if Hinv_like is None or Hinv_update == "sims":
                    Hinv_like = Hinv_like_sims
                elif i > 2:
                    j0 = int(max(2, i - broyden_memory))
                    Hinv_like = history[j0 - 2]["Hinv_like_sims_t"]
                    for j in range(j0, i):
                        hj, hjm1 = history[j - 1], history[j - 2]
                        dth = hj["theta_t"] - hjm1["theta_t"]
                        dg = hj["g_like_t"] - hjm1["g_like_t"]
                        Hdg = Hinv_like @ dg
                        denom = dth @ Hdg
                        Hinv_like = Hinv_like + np.outer(
                            (dth - Hdg) / denom, dth @ Hinv_like)
                        if Hinv_update == "diagonal_broyden":
                            Hinv_like = np.diag(np.diag(Hinv_like))

                H_prior_t = np.atleast_2d(_host(comp.prior_hess_t(th_t_dev),
                                                muse_fit))
                Hinv_post = np.linalg.inv(
                    np.linalg.inv(Hinv_like) + H_prior_t)

                t = _time.perf_counter() - t0
                history.append({
                    "theta": th.copy(), "theta_unreg": th_unreg.copy(),
                    "theta_t": th_t.copy(), "theta_t_unreg": th_t_unreg.copy(),
                    "g_like_sims": g_sims, "g_like_dat_t": g_dat_t,
                    "g_like_sims_t": g_sims_t, "g_like_t": g_like_t,
                    "g_prior_t": g_prior_t, "g_post_t": g_post_t,
                    "Hinv_post_t": Hinv_post, "H_prior_t": H_prior_t,
                    "Hinv_like_t": Hinv_like,
                    "Hinv_like_sims_t": Hinv_like_sims,
                    "map_converged": out["converged"],
                    "map_failed": out["failed"],
                    "map_iterations": out["iterations"],
                    "t": t,
                    "zhat_dat": save_maps(zhat_dat),
                    "zhat_sims": (save_maps(torch.cat(zhat_sims_parts))
                                  if save_sims_maps else None),
                })
                _warn_maps(out, i)

                # damped Newton step (src/muse.jl:223-227)
                a = alpha_fn(i)
                th_t_unreg = th_t - a * (Hinv_post @ g_post_t)
                th_unreg = _host(comp.inv_transform(comp.theta(th_t_unreg)),
                                 muse_fit)
                th_t = (np.asarray(regularize(th_t_unreg), np.float64)
                        if regularize is not None else th_t_unreg)
                th = _host(comp.inv_transform(comp.theta(th_t)), muse_fit)
                if mesh is not None:
                    # global rank 0's θ on every rank
                    agreed = mesh.broadcast_host(np.concatenate(
                        [th, th_t, th_unreg, th_t_unreg])).reshape(4, nth)
                    th, th_t, th_unreg, th_t_unreg = (v.copy() for v in agreed)

                # running updates for early stop (src/muse.jl:230-232)
                result.theta = th_unreg
                result.gs = [gi for gi in g_sims]
                # per-sim reliability of the stored scores, for get_J's reuse
                result.metadata["gs_converged"] = (
                    out["converged"][1:] & ~out["failed"][1:]).copy()
                result.time += t

            pbar.step(f"θ={_fmt(th_unreg)}  "
                      f"|g_post|={np.max(np.abs(g_post_t)):.3g}")

            if checkpoint_file is not None and lead(mesh):
                result.save(checkpoint_file)
    finally:
        pbar.close()
        trace.enable(traced)

    if get_covariance:
        from .jacobians import get_H, get_J
        get_J(result, problem, seed=seed, nsims=nsims,
              grad_z_atol=grad_z_atol, dtype=dtype, compiled=comp,
              progress=progress, warn_reuse=False, max_batch=max_batch,
              mesh=mesh)
        get_H(result, problem, seed=seed, nsims=max(1, nsims // 10),
              grad_z_atol=grad_z_atol, dtype=dtype, compiled=comp,
              progress=progress, max_batch=max_batch, mesh=mesh)
    return result


muse_fit.host_syncs = 0


def _chunk_step(comp, use_white, th, th_t, W_chunks, seeds_all, Z_chunks,
                ci, a, b, lane_ids, atol):
    """One chunk's device work on this rank's lanes a..b."""
    if use_white:
        return comp.muse_step_white(th, th_t, W_chunks[ci], Z_chunks[ci],
                                    lane_ids[a:b], atol)
    return comp.muse_step(th, th_t, seeds_all[a:b], Z_chunks[ci],
                          lane_ids[a:b], atol)


def _host_flat(spec: ThetaSpec, theta, site) -> np.ndarray:
    flat = spec.flatten(theta)
    if isinstance(flat, torch.Tensor):
        return _host(flat, site)
    return np.asarray(flat, np.float64)


def _theta_converged(history, theta_rtol: float, i: int) -> bool:
    """The θ_rtol convergence test (src/muse.jl:163-165), doubly guarded
    as in ``muse_tpu``: a metric of the wrong sign (Broyden drift) falls
    back to its magnitude, and the last TWO steps must both pass, because
    one small damped step far from the root can pass the σ-scaled test."""

    def step_metric(h_prev, h_curr):
        dth_t = h_curr["theta_t"] - h_prev["theta_t"]
        metric = float(-dth_t @ h_curr["Hinv_post_t"] @ dth_t)
        if metric <= 0.0 and float(dth_t @ dth_t) > 0.0:
            warnings.warn(
                f"MUSE iteration {i}: H⁻¹_post is not negative definite "
                f"along the last step (Δθᵀ H⁻¹ Δθ = {-metric:.3g} ≥ 0) — "
                "likely Broyden-replay drift. Using |Δθᵀ H⁻¹ Δθ| for the "
                "θ_rtol test instead of silently declaring convergence; "
                'consider Hinv_update="sims" or a smaller broyden_memory.')
            metric = abs(metric)
        return math.sqrt(metric)

    if step_metric(history[-2], history[-1]) >= theta_rtol:
        return False
    if len(history) < 3:
        return False       # one qualifying step is not convergence yet
    return step_metric(history[-3], history[-2]) < theta_rtol


def _warn_midmarch_stop(history, theta_rtol: float, nsims: int) -> None:
    """Warn when the θ_rtol stop fires while the posterior score is still
    above its Monte-Carlo noise floor and not below its running maximum
    (the σ-scaled step test can freeze a damped march far from the root)."""
    g_norms = [float(np.max(np.abs(h["g_post_t"]))) for h in history
               if "g_post_t" in h]
    if len(g_norms) < 3:
        return
    g_last, g_max = g_norms[-1], max(g_norms)
    h = history[-1]
    sd = np.std(np.asarray(h["g_like_sims_t"], np.float64), axis=0, ddof=1)
    floor = sd / math.sqrt(max(nsims, 2))
    z = np.abs(np.asarray(h["g_post_t"], np.float64)) / np.maximum(
        floor, 1e-300)
    if g_last > 0.5 * g_max and float(np.max(z)) > 3.0:
        warnings.warn(
            f"MUSE stopped by theta_rtol={theta_rtol:g} while the "
            f"posterior score is still {float(np.max(z)):.1f}× its "
            "Monte-Carlo noise floor and has not decreased from its "
            f"running maximum (max|g_post| {g_last:.3g} vs peak "
            f"{g_max:.3g}). The fit is likely NOT converged: rerun with a "
            "smaller theta_rtol or more maxsteps.")


def _warn_maps(out, i):
    failed = np.asarray(out["failed"])
    if failed.any():
        warnings.warn(
            f"MUSE iteration {i}: {int(failed.sum())}/{failed.size} latent "
            "MAP solves failed; result may be affected — consider adjusting "
            "θ₀ or grad_z_atol.")
    conv = np.asarray(out["converged"])
    if not conv.all() and not failed.any():
        warnings.warn(
            f"MUSE iteration {i}: {int((~conv).sum())}/{conv.size} MAP "
            "solves did not converge within tolerance; result could be "
            "erroneous (same caveat as reference src/interface.jl:168-171).")


def _fmt(th):
    th = np.atleast_1d(th)
    if th.size <= 4:
        return "[" + ", ".join(f"{v:.4g}" for v in th) + "]"
    return f"[{th[0]:.4g}, …×{th.size}]"
