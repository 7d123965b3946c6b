"""The CMB-lensing model as a user runs it: data, one pipeline, its output.

A pipeline is the port's ``muse_tpu_torch/examples/lensing_demo.py`` at
its flagship size on a new data set: ``lensing_problem(x_obs=...)``, one
``CompiledProblem`` shared by ``muse_fit`` (from θ₀ = 0 with the Wiener
warm start, Broyden H⁻¹, α 0.3, each step clamped to ±0.3) → ``get_J``
(the fit's scores reused, unconverged ones dropped) →
``get_H(implicit_diff=True)`` with the model's Fourier preconditioner, and
θ̂ and σ read to the host.

Its MAPs are judged by their float64 stationarity, never by solving them
again: a lensing MAP need not be unique. Each pipeline keeps, without a
read of the device in the window, the MAPs the program returned: every
lane's at the fit's last step (whose scores ``get_J`` reuses), the data
lane's and ``MAP_SIMS`` sims' at every step, and the fiducial MAPs of
``get_H``'s solve.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..counts import lensing as COUNTS  # noqa: F401  (read by trace)
from ..reference import lensing as ref

#: the CompiledProblem methods that hold the device work of a pipeline;
#: the traced run spans each, and ``FIT_STEPS`` are an outer iteration's
STEP_METHODS = ("sample_whites", "muse_step_white", "h_implicit_from_whites")
FIT_STEPS = ("muse_step_white",)
#: lanes a pipeline keeps the fit's MAPs of at every step: the data lane
#: and this many sims drawn from the pipeline's seed
MAP_SIMS = 2


def make_pool(cfg: dict, seed: int, count: int, device) -> torch.Tensor:
    """``count`` observed maps (count, n, n), float32, drawn at
    ``theta_true`` on ``device`` from one generator, in blocks."""
    gen_seeds = np.random.SeedSequence(int(seed)).generate_state(
        (count + 7) // 8, np.uint32)
    parts = [ref.make_data(cfg, int(s), min(8, count - 8 * i), device)
             for i, s in enumerate(gen_seeds)]
    return torch.cat(parts).contiguous()


def map_lanes(seed: int, nsims: int) -> list:
    """The global lanes whose MAPs a pipeline keeps at every step: the data
    lane (0) and ``MAP_SIMS`` sims (1..nsims) drawn from the seed."""
    rng = np.random.default_rng(seed)
    sims = rng.choice(np.arange(1, nsims + 1), size=min(MAP_SIMS, nsims),
                      replace=False)
    return [0] + sorted(int(j) for j in sims)


_STREAMS = {}


class _MapKeeper:
    """Keeps the MAPs the program returns, and the θ each solve ran at.

    ``sample_whites`` is wrapped to learn which lane seeds each tensor of
    whites holds, so a step's kept rows are told apart by the whites it is
    handed; the last step's whole ``Z`` is held (the program holds it too)
    until the fit returns; ``_solve_maps`` is wrapped inside
    ``h_implicit_from_whites`` to take the fiducial MAPs. On a card every
    copy goes to pinned host memory on a stream of its own, after the
    program's work and without a synchronise, so the window's device memory
    and timeline stay the program's."""

    def __init__(self, comp, lane_seeds: dict):
        self.comp = comp
        self.want = lane_seeds                    # lane seed → global lane
        self.rows = {}                            # id(whites) → [(row, lane)]
        self.maps = []                            # (lane, θ, Z) on the host
        self.last = None                          # (θ, Z) of the last step
        self.h = None                             # (θ, Z, converged)
        self.in_h = False
        dev = comp.device
        if dev.type == "cuda" and dev not in _STREAMS:
            _STREAMS[dev] = torch.cuda.Stream(dev)
        self.stream = _STREAMS.get(dev)
        draw, step = comp.sample_whites, comp.muse_step_white
        h_step, solve = comp.h_implicit_from_whites, comp._solve_maps

        def sample_whites(seeds, *a, **kw):
            W = draw(seeds, *a, **kw)
            hit = [(r, self.want[s]) for r, s in enumerate(seeds)
                   if s in self.want]
            if hit and W[0] is not None:
                self.rows[id(W[0])] = hit
            return W

        def muse_step_white(th, th_t, W_all, *a, **kw):
            out = step(th, th_t, W_all, *a, **kw)
            th_h = self._host(th)
            self.last = (th_h, out["Z"])
            hit = self.rows.get(id(W_all[0]), [])
            self.maps += [(lane, th_h, self._host(out["Z"][r]))
                          for r, lane in hit]
            return out

        def h_implicit_from_whites(*a, **kw):
            self.in_h = True
            try:
                return h_step(*a, **kw)
            finally:
                self.in_h = False

        def _solve_maps(xs, Z0, th, atol):
            Z, aux = solve(xs, Z0, th, atol)
            if self.in_h:
                self.h = (self._host(th), self._host(Z),
                          self._host(aux["converged"]))
            return Z, aux

        comp.sample_whites = sample_whites
        comp.muse_step_white = muse_step_white
        comp.h_implicit_from_whites = h_implicit_from_whites
        comp._solve_maps = _solve_maps

    def _host(self, t):
        if self.stream is None:
            return t.detach().clone()
        self.stream.wait_stream(torch.cuda.current_stream(t.device))
        with torch.cuda.stream(self.stream):
            h = t.detach().to("cpu", non_blocking=True)
        t.record_stream(self.stream)
        return h

    def fit_done(self):
        """The fit has returned: copy its last step's whole Z."""
        if self.last is not None and isinstance(self.last[1], torch.Tensor) \
                and self.last[1].device.type != "cpu":
            self.last = (self.last[0], self._host(self.last[1]))

    def done(self) -> dict:
        """The kept MAPs, once their copies have landed; the program's
        object is handed back as it was."""
        if self.stream is not None:
            self.stream.synchronize()
        if self.comp is not None:
            for name in ("sample_whites", "muse_step_white",
                         "h_implicit_from_whites", "_solve_maps"):
                self.comp.__dict__.pop(name, None)
            self.comp = None
        self.rows.clear()
        bulk = {"maps": [(lane, float(th[0]), Z)
                         for lane, th, Z in self.maps]}
        if self.last is not None:
            bulk["last"] = (float(self.last[0][0]), self.last[1])
        if self.h is not None:
            th, Z, conv = self.h
            bulk["h"] = (float(th[0]), Z)
            bulk["h_converged"] = conv.numpy().astype(bool)
        return bulk


def pipeline(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
             span) -> dict:
    """One whole pipeline on the data ``x_obs``; ``span(name)`` is a context
    manager around each phase. Returns what the reference judges; its
    ``bulk`` (the kept MAPs) only a checked pipeline needs to keep."""
    from muse_tpu_torch import MuseResult, ThetaSpec, get_H, get_J, muse_fit
    from muse_tpu_torch.models import lensing_problem
    from muse_tpu_torch.solver import CompiledProblem

    fit, h = cfg["fit"], cfg["h"]
    keeper = None
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with span("bench.build"):
                prob = lensing_problem(
                    n=cfg["n"], sigma_noise=cfg["sigma_noise"],
                    gamma_z=cfg["gamma_z"], gamma_phi=cfg["gamma_phi"],
                    defl_scale=cfg["defl_scale"], prior_std=cfg["prior_std"],
                    solver=cfg["solver"], x_obs=x_obs, device=x_obs.device)
                spec = ThetaSpec.from_example(0.0)
                comp = CompiledProblem(prob, spec,
                                       spec.flatten(cfg["theta0"]))
            keeper = _MapKeeper(comp, {ref.keys.lane_seed(seed, j): j
                                       for j in map_lanes(seed, nsims)})
            # the example's trust region for a log-amplitude: each θ-step
            # clamped to ±clamp about the θ it came from
            prev = {"th": np.full(1, float(cfg["theta0"]))}

            def clamp_step(th_t):
                th_t = np.clip(th_t, prev["th"] - fit["clamp"],
                               prev["th"] + fit["clamp"])
                prev["th"] = np.asarray(th_t)
                return th_t

            res = MuseResult()
            with span("bench.muse_fit"):
                muse_fit(res, prob, cfg["theta0"], nsims=nsims,
                         z0=prob.suggested_z0, alpha=fit["alpha"],
                         Hinv_update=fit["Hinv_update"],
                         regularize=clamp_step,
                         grad_z_atol=fit["grad_z_atol"],
                         theta_rtol=fit["theta_rtol"],
                         maxsteps=fit["maxsteps"],
                         max_batch=fit["max_batch"], compiled=comp,
                         seed=seed)
            keeper.fit_done()
            with span("bench.get_J"):
                get_J(res, prob, nsims=nsims, grad_z_atol=fit["grad_z_atol"],
                      warn_reuse=False, skip_errors=True,
                      max_batch=fit["max_batch"], compiled=comp, seed=seed)
            with span("bench.get_H"):
                get_H(res, prob, nsims=h["nsims"], implicit_diff=True,
                      implicit_diff_precond=prob.suggested_h_precond,
                      implicit_fit_atol=h["fit_atol"],
                      max_batch=fit["max_batch"], compiled=comp, seed=seed)
            with span("bench.read"):
                theta_hat, sigma = float(res.theta[0]), float(res.sigma[0])
    finally:
        bulk = keeper.done() if keeper is not None else {}
    del prob, comp
    hist = res.history
    conv = [np.asarray(x["map_converged"], bool) for x in hist]
    h_conv = bulk.pop("h_converged", np.zeros(0, bool))
    frozen = sum(int((~c).sum()) for c in conv) + int((~h_conv).sum())
    return {"thetas": [float(x["theta"][0]) for x in hist],
            "theta_ts": [float(x["theta_t"][0]) for x in hist],
            "g_dat": [float(x["g_like_dat_t"][0]) for x in hist],
            "g_sims": [np.asarray(x["g_like_sims_t"])[:, 0] for x in hist],
            "theta_hat": theta_hat, "sigma": sigma,
            "J": float(res.J[0, 0]), "H": float(res.H[0, 0]),
            "Hs": [float(x[0, 0]) for x in res.Hs],
            "gs_kept": np.asarray(res.metadata["gs_converged"], bool),
            "converged": conv, "h_converged": h_conv,
            "frozen": frozen, "iterations": len(hist),
            "warnings": len(caught), "bulk": bulk}


def check(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int,
          out: dict) -> dict:
    """The numbers compared for one pipeline's output."""
    r = ref.reference(cfg, x_obs, seed, nsims, out, map_lanes(seed, nsims))
    return ref.judge(cfg, out, r)


def control(cfg: dict, x_obs: torch.Tensor, seed: int, nsims: int) -> dict:
    """The control's output for the same data and seed."""
    return ref.control_pipeline(cfg, x_obs, seed, nsims,
                                map_lanes(seed, nsims))
