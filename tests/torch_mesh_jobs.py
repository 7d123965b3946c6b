"""Sharded runs of ``muse_tpu_torch`` for ``tests/test_torch_mesh.py``.

:func:`spawn` starts one process per rank on the CPU, joins them over
``gloo`` and runs one job (a function of this module named in ``JOBS``)
on every rank; each rank saves what it computed to ``<job>.rank<r>.npz``.
A rank that hangs in a collective is killed when the parent's deadline
passes and the call raises, so a deadlock fails its test rather than the
suite's time limit.

This module imports only ``torch``, ``numpy`` and ``muse_tpu_torch``: the
spawned children never import JAX. Its name does not start with
``test_``, so pytest does not collect it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import socket
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import muse_tpu_torch as mt
from muse_tpu_torch.models import (bandpower_problem, funnel_problem,
                                   grf_problem, grf_spectral_problem,
                                   lensing_problem)
from muse_tpu_torch.parallel import make_sims_mesh
from muse_tpu_torch.solver.compiled import CompiledProblem
from muse_tpu_torch.theta import ThetaSpec

CPU = "cpu"
N = 16                       # tests/test_mesh.py's grid
WORLD = 4
COLLECTIVE_TIMEOUT_S = 60    # init_process_group's timeout


# ------------------------------------------------------------------ #
# the runs: one function per check, shared by the sharded jobs and the
# unsharded oracle (mesh=None), so the two differ in nothing else
# ------------------------------------------------------------------ #

def funnel_runs(mesh) -> dict:
    """tests/test_mesh.py's funnel cases: muse, J, fixed, adaptive and
    implicit H, 11 and 3 lanes, max_batch."""
    p = funnel_problem(64, data_seed=42, device=CPU)
    out = {}
    r = mt.muse(p, 1.0, nsims=24, maxsteps=5, seed=1, mesh=mesh)
    out["funnel_theta"], out["funnel_steps"] = r.theta, len(r.history)
    out["funnel_g_sims"] = r.history[-1]["g_like_sims"]
    j = mt.get_J(mt.MuseResult(), p, 0.0, seed=2, nsims=16, mesh=mesh)
    out["funnel_J"] = j.J
    for name, kw in (("fd", dict(step=0.1)),
                     ("adaptive", dict(step=0.1, fd_order="adaptive")),
                     ("implicit", dict(implicit_diff=True))):
        h = mt.get_H(mt.MuseResult(), p, 0.0, seed=5, nsims=4, mesh=mesh,
                     **kw)
        out[f"funnel_H_{name}"] = h.H
    for lanes in (11, 3):
        r = mt.muse(p, 1.0, nsims=lanes - 1, maxsteps=3, seed=3, mesh=mesh)
        out[f"funnel_theta_{lanes}_lanes"] = r.theta
    r = mt.muse(p, 1.0, nsims=10, maxsteps=3, seed=9, max_batch=6,
                mesh=mesh)
    out["funnel_theta_max_batch"] = r.theta
    return out


def grf_pixel_runs(mesh) -> dict:
    p = grf_problem(n=N, solver="cg", data_seed=42, device=CPU, mesh=mesh)
    r = mt.muse(p, 0.5, nsims=15, maxsteps=4, seed=7, mesh=mesh)
    out = {"pixel_theta": r.theta, "pixel_steps": len(r.history)}
    j = mt.MuseResult()
    mt.get_J(j, p, 0.0, seed=8, nsims=9, mesh=mesh)
    mt.get_H(j, p, 0.0, seed=8, nsims=3, step=0.1, mesh=mesh)
    out["pixel_J"], out["pixel_H"] = j.J, j.H
    return out


def spectral_runs(mesh) -> dict:
    """The packed spectral GRF: fit, reused J, implicit and FD H."""
    p = grf_spectral_problem(n=N, sigma_noise=0.1, data_seed=42,
                             device=CPU, mesh=mesh)
    r = mt.muse(p, 0.5, nsims=7, maxsteps=4, seed=13, mesh=mesh)
    out = {"spectral_theta": r.theta, "spectral_steps": len(r.history)}
    mt.get_J(r, p, seed=13, nsims=7, mesh=mesh, warn_reuse=False)
    mt.get_H(r, p, seed=13, nsims=3, implicit_diff=True,
             implicit_diff_precond=p.suggested_h_precond, mesh=mesh)
    out["spectral_J"], out["spectral_H"] = r.J, r.H
    h = mt.get_H(mt.MuseResult(), p, 0.5, seed=14, nsims=3, step=0.05,
                 mesh=mesh)
    out["spectral_H_fd"] = h.H
    return out


def vector_theta_runs(mesh) -> dict:
    p = grf_problem(n=N, sigma_noise=0.3, infer_tilt=True, data_seed=42,
                    device=CPU, mesh=mesh)
    r = mt.muse(p, np.array([0.3, 0.1]), nsims=7, maxsteps=3, seed=17,
                mesh=mesh)
    j = mt.get_J(mt.MuseResult(), p, np.zeros(2), seed=17, nsims=8,
                 mesh=mesh)
    return {"vector_theta": r.theta, "vector_J": j.J}


def bandpower_runs(mesh) -> dict:
    p = bandpower_problem(n=N, nbands=8, data_seed=42, device=CPU,
                          mesh=mesh)
    th0 = np.zeros(8)
    r = mt.muse(p, th0, nsims=6, maxsteps=3, seed=23, mesh=mesh)
    j = mt.get_J(mt.MuseResult(), p, th0, seed=23, nsims=8, mesh=mesh)
    h = mt.get_H(mt.MuseResult(), p, th0, seed=23, nsims=3, step=1e-3,
                 mesh=mesh)
    hi = mt.get_H(mt.MuseResult(), p, th0, seed=23, nsims=3,
                  implicit_diff=True,
                  implicit_diff_precond=p.suggested_h_precond, mesh=mesh)
    return {"band_theta": r.theta, "band_J": j.J, "band_H": h.H,
            "band_H_implicit": hi.H}


def maps_runs(mesh) -> dict:
    """``save_maps`` (the maps gathered to every rank) and a whole-length
    ``z0`` (cut to a field rank's rows) on the spectral GRF."""
    p = grf_spectral_problem(n=N, sigma_noise=0.1, data_seed=42,
                             device=CPU, mesh=mesh)
    L = 2 * N * (N // 2 + 1)
    r = mt.muse(p, 0.5, nsims=5, maxsteps=2, seed=11, mesh=mesh,
                z0=np.full(L, 0.01, np.float32), save_maps=True)
    h = r.history[-1]
    return {"maps_theta": r.theta, "maps_dat": h["zhat_dat"],
            "maps_sims": h["zhat_sims"]}


def lensing_runs(mesh) -> dict:
    p = lensing_problem(n=N, data_seed=42, device=CPU)
    r = mt.muse(p, 0.3, nsims=7, maxsteps=3, seed=3, mesh=mesh)
    return {"lensing_theta": r.theta,
            "lensing_converged": r.history[-1]["map_converged"]}


PPL_D = 64


def _ppl_scale_model():
    """A PPL model with a positive hyper: θ = s runs in log space through
    the Blockwise bijector, with the volume factor."""
    s = mt.ppl.sample("s", mt.distributions.LogNormal(0.0, 1.0))
    z = mt.ppl.sample("z", mt.distributions.Normal(0.0, s).expand((PPL_D,)))
    mt.ppl.sample("x", mt.distributions.Normal(z, 1.0))


def ppl_runs(mesh) -> dict:
    """The PPL with a θ-bijector: fit, J and FD H (get_covariance)."""
    g = torch.Generator().manual_seed(42)
    x = 1.5 * torch.randn(PPL_D, generator=g) + torch.randn(PPL_D,
                                                            generator=g)
    r = mt.muse(_ppl_scale_model, {"s": 1.0}, observed={"x": x}, nsims=16,
                theta_rtol=1e-3, maxsteps=6, get_covariance=True, seed=2,
                mesh=mesh)
    return {"ppl_theta": r.theta, "ppl_J": r.J, "ppl_H": r.H}


SIMS_RUNS = (funnel_runs, grf_pixel_runs, spectral_runs, vector_theta_runs,
             bandpower_runs, maps_runs, lensing_runs)
FIELD_RUNS = (spectral_runs, bandpower_runs, maps_runs, funnel_runs,
              grf_pixel_runs, vector_theta_runs, lensing_runs, ppl_runs)


# ------------------------------------------------------------------ #
# jobs (every rank runs them)
# ------------------------------------------------------------------ #

def sims_job(out_dir: Path) -> dict:
    """Construction, then every run of ``SIMS_RUNS`` on ``sims=4``."""
    mesh = make_sims_mesh(device_type=CPU)
    out = {"n_sims_shards": mesh.n_sims_shards,
           "field_axis_none": mesh.field_axis is None}
    m2 = make_sims_mesh(sims=2, field=2, device_type=CPU)
    out["field_axis_2d"] = m2.field_axis == "field"
    out["field_rows"] = np.array([m2.field_rows(N).start,
                                  m2.field_rows(N).stop])
    try:
        make_sims_mesh(sims=3, field=2, device_type=CPU)
        out["bad_shape_raises"] = False
    except ValueError:
        out["bad_shape_raises"] = True
    for run in SIMS_RUNS:
        out.update(run(mesh))
    out["collectives"] = mesh.collectives
    # profile_dir under a mesh: one trace per rank
    mt.muse(funnel_problem(64, data_seed=42, device=CPU), 1.0, nsims=8,
            maxsteps=2, seed=1, mesh=mesh, profile_dir=str(out_dir / "prof"))
    return out


def _error(fn, kind) -> str:
    """The message of the ``kind`` error that ``fn()`` raises ("" if it
    raises none)."""
    try:
        fn()
    except kind as e:
        return str(e)
    return ""


def field_job(out_dir: Path) -> dict:
    """Every run of ``FIELD_RUNS`` on ``sims=2 × field=2``, the two routes'
    counts of gathers and field maxima, what stays refused, and the
    sharded white-hoisted steps on the whites in ``step_inputs.npz`` and
    ``pixel_step_inputs.npz``."""
    mesh = make_sims_mesh(sims=2, field=2, device_type=CPU)
    out = {}
    for run in FIELD_RUNS:
        mesh.reset_counts()
        out.update(run(mesh))
        out[f"counts_{run.__name__}"] = np.array(
            [mesh.gathers, mesh.max_reduces, mesh.collectives])
    other = make_sims_mesh(sims=2, field=2, device_type=CPU)
    built = grf_spectral_problem(n=N, sigma_noise=0.1, device=CPU,
                                 mesh=other)
    out["other_mesh_error"] = _error(lambda: mt.muse(
        built, 0.5, nsims=4, maxsteps=2, mesh=mesh), ValueError)
    out["matmul_error"] = _error(lambda: grf_problem(
        n=N, device=CPU, mesh=mesh, fft_mode="matmul"), NotImplementedError)
    out["pixel_lbfgs_error"] = _error(lambda: grf_problem(
        n=N, device=CPU, mesh=mesh, solver="lbfgs"), ValueError)
    out.update(_sharded_step(mesh, out_dir / "step_inputs.npz"))
    out.update(_sharded_pixel_step(mesh, out_dir / "pixel_step_inputs.npz"))
    return out


def _sharded_pixel_step(mesh, inputs: Path) -> dict:
    """The pixel ``grf_problem``'s muse_step_white on each rank's block of
    lanes (whole whites, the warm starts' rows), gathered to every rank."""
    d = np.load(inputs)
    p = grf_problem(n=N, sigma_noise=float(d["sigma"]), x_obs=d["field"],
                    device=CPU, mesh=mesh)
    comp = CompiledProblem(p, ThetaSpec.from_example(0.5), np.array([0.5]))
    B = d["u"].shape[0]
    lo, hi = mesh.lane_block(B)
    cols = p.field_slice
    th = torch.from_numpy(d["theta"])
    res = comp.muse_step_white(
        th, th, (torch.from_numpy(d["u"][lo:hi]),
                 torch.from_numpy(d["e"][lo:hi])),
        torch.from_numpy(np.ascontiguousarray(d["Z_prev"][lo:hi, cols])),
        torch.from_numpy(d["lanes"][lo:hi]), 1e-2)
    flags = torch.stack([res["converged"], res["failed"]], 1)
    return {"pixel_step_g": mesh.gather_sims(res["g"].numpy(), lo, B),
            "pixel_step_Z": mesh.gather_maps(res["Z"], lo, B, cols,
                                             p.field_size).numpy(),
            "pixel_step_flags": mesh.gather_sims(flags.numpy(), lo, B),
            "pixel_step_x": comp.x_obs.numpy()}


def _sharded_step(mesh, inputs: Path) -> dict:
    """The port's muse_step_white on each rank's block of lanes and rows of
    the given whites, gathered to every rank."""
    d = np.load(inputs)
    p = grf_spectral_problem(n=N, sigma_noise=float(d["sigma"]),
                             x_obs=d["field"], device=CPU, mesh=mesh)
    comp = CompiledProblem(p, ThetaSpec.from_example(0.5), np.array([0.5]))
    B = d["w1"].shape[0]
    lo, hi = mesh.lane_block(B)
    cols = p.field_slice

    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(a[lo:hi, cols]))

    th = torch.from_numpy(d["theta"])
    res = comp.muse_step_white(th, th, (mine(d["w1"]), mine(d["w2"])),
                               mine(d["Z_prev"]),
                               torch.from_numpy(d["lanes"][lo:hi]), 1e-2)
    flags = torch.stack([res["converged"], res["failed"]], 1)
    return {"step_g": mesh.gather_sims(res["g"].numpy(), lo, B),
            "step_Z": mesh.gather_maps(res["Z"], lo, B, cols,
                                       p.field_size).numpy(),
            "step_flags": mesh.gather_sims(flags.numpy(), lo, B),
            # the data, once: from sims rank 0's field group
            "step_x": mesh.gather_maps(
                comp.x_obs[None][:int(mesh.sims_rank == 0)], 0, 1, cols,
                p.field_size).numpy()[0]}


def hang_job(out_dir: Path) -> dict:
    """Rank 0 never reaches the collective that the others wait in."""
    if dist.get_rank() == 0:
        time.sleep(3 * COLLECTIVE_TIMEOUT_S)
    dist.all_reduce(torch.ones(1))
    return {}


JOBS = {"sims": sims_job, "field": field_job, "hang": hang_job}

# the field spawn's deadline: its runs take ~1 min on 4 CPU ranks
FIELD_TIMEOUT_S = 240.0


# ------------------------------------------------------------------ #
# the launcher
# ------------------------------------------------------------------ #

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, job: str,
               out_dir: str) -> None:
    out = Path(out_dir)
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        results = JOBS[job](out)
        np.savez(out / f"{job}.rank{rank}.npz", **results)
    except BaseException:
        (out / f"{job}.rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(job: str, out_dir, world: int = WORLD,
          timeout: float = 120.0) -> list:
    """Run ``JOBS[job]`` on ``world`` spawned gloo ranks; returns each
    rank's results (a list of dicts, rank order). Raises if a rank fails,
    and kills every rank and raises once ``timeout`` seconds have passed."""
    out_dir = Path(out_dir)
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, job, str(out_dir)))
             for r in range(world)]
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"job {job!r}: ranks {hung} still running "
                               f"after {timeout:.0f} s (a hung collective?)")
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = [(out_dir / f"{job}.rank{r}.err") for r in failed]
            raise RuntimeError(f"job {job!r}: ranks {failed} failed:\n" +
                               "\n".join(e.read_text() for e in errs
                                         if e.exists()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [dict(np.load(out_dir / f"{job}.rank{r}.npz"))
            for r in range(world)]
