"""The field GRF as a user runs it: data, one pipeline, its output.

A pipeline is slice 1's, ``muse(grf_field_problem(n=1024,
sigma_noise=0.01), 0.5, nsims=100, theta_rtol=1e-5, maxsteps=20,
get_covariance=True)``, split as a user splits it on a new data set:
``grf_field_problem(x_obs=...)``, one ``CompiledProblem`` shared by
``muse_fit`` (α 0.7, the sims-variance H⁻¹, all 101 lanes in one call) →
``get_J`` (the fit's scores reused) → ``get_H`` by central finite
differences on 10 sims at its default step, and θ̂ and σ read to the host.
The problem declares no white split, so every outer iteration runs the
keyed ``CompiledProblem.muse_step``: each lane redrawn from its seed at θ,
the batched Wiener MAP, the analytic θ-score.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..counts import grf_field as COUNTS  # noqa: F401  (read by trace)
from ..reference import grf_field as ref

#: the CompiledProblem methods that hold the device work of a pipeline;
#: the traced run spans each, and ``FIT_STEPS`` are an outer iteration's
STEP_METHODS = ("muse_step", "j_sims", "h_fiducial", "h_fd")
FIT_STEPS = ("muse_step",)
#: lanes a pipeline keeps the fit's MAPs of, for the reference to judge:
#: the data lane and this many sims drawn from the pipeline's seed
MAP_SIMS = 2


def make_pool(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """``count`` observed maps (count, n, n), float32, drawn at
    ``theta_true`` on ``device`` from one generator, in blocks."""
    return ref.make_data(cfg, seed, count, device)


def map_lanes(seed: int, nsims: int) -> list:
    """The global lanes whose MAPs a pipeline keeps: the data lane (0) and
    ``MAP_SIMS`` sims (1..nsims) drawn from the pipeline's seed."""
    rng = np.random.default_rng(seed)
    sims = rng.choice(np.arange(1, nsims + 1), size=min(MAP_SIMS, nsims),
                      replace=False)
    return [0] + sorted(int(j) for j in sims)


_STREAMS = {}


class _MapKeeper:
    """Keeps the MAPs of chosen lanes from every step of a fit, as the
    program returns them, and the θ each step ran at.

    The keyed step is handed the lanes' seeds, a host list, so a step's
    rows are told apart by their seeds (each the seed of one global lane)
    and the keeper never reads the device. On a card each kept row is
    copied to pinned host memory on a stream of its own, after the step's
    work and without a synchronise, so the window's device memory and
    timeline stay the program's."""

    def __init__(self, comp, lane_seeds: dict):
        self.comp = comp
        self.want = lane_seeds                    # lane seed → global lane
        self.maps = []                            # (lane, θ, Z) on the host
        dev = comp.device
        if dev.type == "cuda" and dev not in _STREAMS:
            _STREAMS[dev] = torch.cuda.Stream(dev)
        self.stream = _STREAMS.get(dev)
        step = comp.muse_step

        def muse_step(th, th_t, seeds, *a, **kw):
            out = step(th, th_t, seeds, *a, **kw)
            hit = [(r, self.want[s]) for r, s in enumerate(seeds)
                   if s in self.want]
            if hit:
                th_h = self._host(th)
                self.maps += [(lane, th_h, self._host(out["Z"][r]))
                              for r, lane in hit]
            return out

        comp.muse_step = muse_step

    def _host(self, t):
        if self.stream is None:
            return t.detach().clone()
        self.stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(self.stream):
            h = t.detach().to("cpu", non_blocking=True)
        t.record_stream(self.stream)
        return h

    def done(self) -> list:
        """The kept (lane, θ, Z), once their copies have landed; the
        program's object is handed back as it was."""
        if self.stream is not None:
            self.stream.synchronize()
        if self.comp is not None:
            self.comp.__dict__.pop("muse_step", None)
            self.comp = None
        return [(lane, float(th[0]), Z) for lane, th, Z in self.maps]


def pipeline(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
             span) -> dict:
    """One whole pipeline on the data ``x_obs``; ``span(name)`` is a context
    manager around each phase. Returns what the reference judges; its
    ``bulk`` (the kept MAPs) only a checked pipeline needs to keep."""
    from muse_tpu_torch import MuseResult, ThetaSpec, get_H, get_J, muse_fit
    from muse_tpu_torch.models import grf_field_problem
    from muse_tpu_torch.solver import CompiledProblem

    fit, h = cfg["fit"], cfg["h"]
    keeper = None
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with span("bench.build"):
                prob = grf_field_problem(
                    n=cfg["n"], sigma_noise=cfg["sigma_noise"],
                    gamma=cfg["gamma"], k0=cfg["k0"],
                    prior_std=cfg["prior_std"], x_obs=x_obs,
                    device=x_obs.device)
                spec = ThetaSpec.from_example(0.0)
                comp = CompiledProblem(prob, spec,
                                       spec.flatten(cfg["theta0"]))
            keeper = _MapKeeper(comp, {ref.keys.lane_seed(seed, j): j
                                       for j in map_lanes(seed, nsims)})
            res = MuseResult()
            with span("bench.muse_fit"):
                muse_fit(res, prob, cfg["theta0"], nsims=nsims,
                         max_batch=fit["max_batch"],
                         theta_rtol=fit["theta_rtol"],
                         Hinv_update=fit["Hinv_update"], alpha=fit["alpha"],
                         maxsteps=fit["maxsteps"],
                         grad_z_atol=fit["grad_z_atol"], compiled=comp,
                         seed=seed)
            with span("bench.get_J"):
                get_J(res, prob, nsims=nsims, max_batch=fit["max_batch"],
                      grad_z_atol=fit["grad_z_atol"], compiled=comp,
                      seed=seed, warn_reuse=False)
            with span("bench.get_H"):
                get_H(res, prob, nsims=h["nsims"], fd_order=h["fd_order"],
                      grad_z_atol=fit["grad_z_atol"],
                      max_batch=fit["max_batch"], compiled=comp, seed=seed)
            with span("bench.read"):
                theta_hat, sigma = float(res.theta[0]), float(res.sigma[0])
    finally:
        maps = keeper.done() if keeper is not None else []
    del prob, comp
    hist = res.history
    return {"thetas": [float(x["theta"][0]) for x in hist],
            "theta_ts": [float(x["theta_t"][0]) for x in hist],
            "g_dat": [float(x["g_like_dat_t"][0]) for x in hist],
            "g_sims": [np.asarray(x["g_like_sims"])[:, 0] for x in hist],
            "theta_hat": theta_hat, "sigma": sigma,
            "J": float(res.J[0, 0]), "H": float(res.H[0, 0]),
            "Hs": [float(x[0, 0]) for x in res.Hs],
            "iterations": len(hist), "warnings": len(caught),
            "bulk": {"maps": maps}}


def check(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
          out: dict) -> dict:
    """The numbers compared for one pipeline's output."""
    r = ref.reference(cfg, x_obs, seed, nsims, out, map_lanes(seed, nsims))
    return ref.judge(cfg, out, r)


def control(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int) -> dict:
    """The control's output for the same data and seed."""
    return ref.control_pipeline(cfg, x_obs, seed, nsims,
                                map_lanes(seed, nsims))
