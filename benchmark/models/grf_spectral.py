"""The packed spectral GRF as a user runs it: data, one pipeline, its output.

A pipeline is the port's ``muse_tpu_torch/examples/northstar_grf.py`` on a
new data set: ``grf_spectral_problem(x_obs=...)``, one ``CompiledProblem``
shared by ``muse_fit`` → ``get_J`` (the fit's scores reused) →
``get_H(implicit_diff=True)``, and θ̂ and σ read to the host.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..counts import grf_spectral as COUNTS  # noqa: F401  (read by trace)
from ..reference import grf_spectral as ref

#: the CompiledProblem methods that hold the device work of a pipeline;
#: the traced run spans each, and ``FIT_STEPS`` are an outer iteration's
STEP_METHODS = ("sample_whites", "muse_step_white", "h_implicit_from_whites")
FIT_STEPS = ("muse_step_white",)
#: lanes a pipeline keeps the fit's MAPs of, for the reference to judge:
#: the data lane and this many sims drawn from the pipeline's seed
MAP_SIMS = 2


def make_pool(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """``count`` packed data realizations (count, L), float32, drawn at
    ``theta_true`` from one generator on ``device`` in two calls:
    x̃ = √(C + σ²)·w with w packed hermitian white noise."""
    n = cfg["n"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shape = (count, n, n // 2 + 1)
    g = torch.randn(shape, generator=gen, device=device)
    h = torch.randn(shape, generator=gen, device=device)
    w = ref.herm_white(g, h, ref.coeff_tensors(n, device, torch.float32))
    del g, h
    C2 = ref.spectrum_base(cfg, device) * math.exp(cfg["theta_true"])
    return (torch.sqrt(C2 + cfg["sigma_noise"] ** 2).float() * w).contiguous()


def nsims_h(nsims: int) -> int:
    """The example's H sims: max(8, nsims/10)."""
    return max(8, nsims // 10)


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

    ``sample_whites`` is wrapped to learn which lane seeds each tensor of
    whites holds, so a step's rows are told apart by the whites it is handed
    and the keeper never reads the device. On a card each kept row is copied
    to pinned host memory on a stream of its own, after the step's work and
    without a synchronise, so the window's device memory and timeline stay
    the program's."""

    def __init__(self, comp, lane_seeds: dict):
        self.comp = comp
        self.want = lane_seeds                    # lane seed → global lane
        self.rows = {}                            # id(whites) → [(row, lane)]
        self.maps = []                            # (lane, θ, Z) on the host
        dev = comp.device
        if dev.type == "cuda" and dev not in _STREAMS:
            _STREAMS[dev] = torch.cuda.Stream(dev)
        self.stream = _STREAMS.get(dev)
        draw, step = comp.sample_whites, comp.muse_step_white

        def sample_whites(seeds, *a, **kw):
            W = draw(seeds, *a, **kw)
            hit = [(r, self.want[s]) for r, s in enumerate(seeds)
                   if s in self.want]
            if hit and W[0] is not None:
                self.rows[id(W[0])] = hit
            return W

        def muse_step_white(th, th_t, W_all, *a, **kw):
            out = step(th, th_t, W_all, *a, **kw)
            hit = self.rows.get(id(W_all[0]))
            if hit:
                th_h = self._host(th)
                self.maps += [(lane, th_h, self._host(out["Z"][r]))
                              for r, lane in hit]
            return out

        comp.sample_whites = sample_whites
        comp.muse_step_white = muse_step_white

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
            for name in ("sample_whites", "muse_step_white"):
                self.comp.__dict__.pop(name, None)
            self.comp = None
        self.rows.clear()
        return [(lane, float(th[0]), Z) for lane, th, Z in self.maps]


def pipeline(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
             span) -> dict:
    """One whole pipeline on the data ``x_obs``; ``span(name)`` is a context
    manager around each phase. Returns what the reference judges; its
    ``bulk`` (the kept MAPs) only a checked pipeline needs to keep."""
    from muse_tpu_torch import MuseResult, ThetaSpec, get_H, get_J, muse_fit
    from muse_tpu_torch.models import grf_spectral_problem
    from muse_tpu_torch.solver import CompiledProblem

    fit = cfg["fit"]
    keeper = None
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with span("bench.build"):
                prob = grf_spectral_problem(
                    n=cfg["n"], sigma_noise=cfg["sigma_noise"],
                    gamma=cfg["gamma"], k0=cfg["k0"], solver=cfg["solver"],
                    noise=cfg["noise"], cg_maxiter=cfg["cg_maxiter"],
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
                      compiled=comp, seed=seed, warn_reuse=False)
            with span("bench.get_H"):
                get_H(res, prob, nsims=nsims_h(nsims), implicit_diff=True,
                      implicit_diff_precond=prob.suggested_h_precond,
                      max_batch=fit["max_batch"], compiled=comp, seed=seed)
            with span("bench.read"):
                theta_hat, sigma = float(res.theta[0]), float(res.sigma[0])
    finally:
        maps = keeper.done() if keeper is not None else []
    del prob, comp
    hist = res.history
    return {"thetas": [float(h["theta"][0]) for h in hist],
            "g_dat": [float(h["g_like_dat_t"][0]) for h in hist],
            "g_sims": [np.asarray(h["g_like_sims"])[:, 0] for h in hist],
            "theta_hat": theta_hat, "sigma": sigma,
            "J": float(res.J[0, 0]), "H": float(res.H[0, 0]),
            "Hs": [float(h[0, 0]) for h in res.Hs],
            "iterations": len(hist), "warnings": len(caught),
            "bulk": {"maps": maps}}


def check(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
          out: dict) -> dict:
    """The numbers compared for one pipeline's output."""
    r = ref.reference(cfg, x_obs, seed, nsims, nsims_h(nsims), out,
                      map_lanes(seed, nsims))
    return ref.judge(cfg, out, r)


def control(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int) -> dict:
    """The control's output for the same data and seed."""
    return ref.control_pipeline(cfg, x_obs, seed, nsims, nsims_h(nsims),
                                map_lanes(seed, nsims))
