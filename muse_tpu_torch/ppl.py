"""A minimal effect-handler PPL — the model-ingestion layer.

Counterpart of ``muse_tpu/ppl.py`` (the reference ingests PPL models
through its Turing.jl and Soss.jl adapters, ``src/turing.jl``,
``src/soss.jl``). Models are plain Python functions calling
``sample(name, dist)``; effect handlers reinterpret those calls to trace,
seed or substitute values. Handlers run in Python around the model, so
``torch.func`` transforms pass through a model as through any function.

Example (the reference test's funnel, test/runtests.jl:14-18)::

    import torch
    from muse_tpu_torch import muse, ppl
    from muse_tpu_torch.distributions import Normal

    def funnel():
        theta = ppl.sample("theta", Normal(0.0, 3.0))
        z = ppl.sample("z", Normal(0.0, torch.exp(theta / 2)).expand((512,)))
        ppl.sample("x", Normal(z, 1.0))

    prob = ppl.PPLMuseProblem(funnel, observed={"x": x_obs},
                              params=("theta",), device="cpu")
    result = muse(prob, {"theta": 1.0})

Sites as in ``TuringMuseProblem`` (src/turing.jl:137-140): conditioned
(``observed``) sites are the data x, ``params`` the hyper parameters θ,
and every other sample site is latent z. Latents live in unconstrained
space inside the solver (positive and interval supports are linked through
their bijectors, with the density's volume factor, as DynamicPPL's linked
``logjoint``), and θ gets a blockwise support bijector with the Turing
volume-factor convention (src/turing.jl:171-186).

``seed(generator)`` draws every unset sample site, in program order, from
one ``torch.Generator``; JAX's per-site ``fold_in`` has no counterpart, so
the two packages agree in distribution, not draw by draw.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from . import transforms as tf
from .distributions import Distribution
from .problem import MuseProblem
from .utils.keys import lane_generator

__all__ = ["sample", "deterministic", "factor", "plate", "trace", "seed",
           "substitute", "PPLMuseProblem", "model_problem"]

# the active handlers, innermost last (one stack per process, as in
# numpyro: a model reads no handler argument)
_HANDLER_STACK: list = []
_PLATE_STACK: list = []


class Messenger:
    """Base effect handler: a context manager on the handler stack."""

    def __enter__(self):
        _HANDLER_STACK.append(self)
        return self

    def __exit__(self, *exc):
        if _HANDLER_STACK.pop() is not self:
            raise RuntimeError("effect handlers exited out of order")

    def process(self, site: dict):
        pass

    def postprocess(self, site: dict):
        pass


class seed(Messenger):
    """Draws every sample site that has no value from ``generator``, in
    program order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def process(self, site):
        if site["type"] == "sample" and site["generator"] is None:
            site["generator"] = self.generator


class substitute(Messenger):
    """Fixes named site values (conditioning, parameter injection)."""

    def __init__(self, values: Dict[str, Any]):
        self.values = dict(values)

    def process(self, site):
        # a factor site's value is a computed density term: substituting
        # it would replace the model's math
        if site["type"] != "factor" and site["name"] in self.values:
            site["value"] = self.values[site["name"]]


class trace(Messenger):
    """Records every site: name → {type, dist, value}."""

    def __init__(self):
        self.sites: Dict[str, dict] = {}

    def postprocess(self, site):
        self.sites[site["name"]] = dict(site)


class plate(Messenger):
    """An independence dimension, ``numpyro.plate`` semantics (the ``with``
    form). Inside ``with plate(name, size, dim=None)`` every sample site's
    distribution is expanded so its batch shape carries ``size`` along
    ``dim`` (negative, from the right); ``dim=None`` takes the next free
    dim left of every enclosing plate's::

        with plate("groups", G):               # dim -1
            mu = sample("mu", Normal(0., 3.))          # shape (G,)
            with plate("items", N):            # dim -2
                x = sample("x", Normal(mu, 1.))        # shape (N, G)

    Site log-densities sum over plate dims, and a scalar value observed or
    substituted under a plate counts ``size`` times. Subsampling is not
    implemented: MUSE needs full-data densities.
    """

    def __init__(self, name: str, size: int, dim=None):
        self.name = name
        self.size = int(size)
        if dim is not None and dim >= 0:
            raise ValueError("plate dim must be negative (from the right)")
        self.dim = dim

    def __enter__(self):
        if self.dim is None:
            used = [p.dim for p in _PLATE_STACK]
            self.dim = (min(used) - 1) if used else -1
        elif any(p.dim == self.dim for p in _PLATE_STACK):
            raise ValueError(
                f"plate dim {self.dim} is already used by an enclosing "
                "plate — pass distinct dims or let them auto-allocate")
        _PLATE_STACK.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if _PLATE_STACK.pop() is not self:
            raise RuntimeError("plates exited out of order")
        return super().__exit__(*exc)

    def process(self, site):
        if site["type"] != "sample":
            return
        pshape = (self.size,) + (1,) * (-self.dim - 1)
        site["dist"] = site["dist"].expand(
            torch.broadcast_shapes(tuple(site["dist"].shape), pshape))


def _as_value(v):
    """A site value as a tensor (host floats in the default float dtype)."""
    if isinstance(v, torch.Tensor):
        return v
    a = np.asarray(v)
    return torch.as_tensor(a, dtype=torch.get_default_dtype()
                           if a.dtype.kind == "f" else None)


def _observed_value(v, dev) -> torch.Tensor:
    """Observed data on ``dev``; floating values in the default float dtype
    (as JAX holds them in float32)."""
    v = _as_value(v).to(dev)
    return v.to(torch.get_default_dtype()) if v.is_floating_point() else v


def sample(name: str, dist: Distribution, obs=None):
    """Declare a random variable. Returns its sampled or substituted value."""
    site = {"type": "sample", "name": name, "dist": dist, "value": obs,
            "generator": None}
    for h in reversed(_HANDLER_STACK):
        h.process(site)
    if site["value"] is None:
        if site["generator"] is None:
            raise RuntimeError(
                f"site {name!r} has no value and no seed handler is active")
        # site["dist"], not the argument: plates expand it in process()
        site["value"] = site["dist"].sample(site["generator"])
    site["value"] = _as_value(site["value"])
    for h in _HANDLER_STACK:
        h.postprocess(site)
    return site["value"]


def factor(name: str, log_factor):
    """Add a term to the model's log-joint (``numpyro.factor``, Turing's
    ``@addlogprob!``). Its summed value enters ``log_like``; a factor that
    depends on θ alone also enters ``log_prior``. Factors never affect
    sampling. Not supported inside a plate: sum the term yourself and call
    ``factor`` outside it."""
    if _PLATE_STACK:
        raise NotImplementedError(
            "factor() inside a plate is not supported — sum the term "
            "over the plate yourself and call factor() outside it")
    site = {"type": "factor", "name": name, "value": _as_value(log_factor),
            "dist": None, "generator": None}
    for h in reversed(_HANDLER_STACK):
        h.process(site)
    for h in _HANDLER_STACK:
        h.postprocess(site)
    return None


def deterministic(name: str, value):
    """Record a derived quantity in traces."""
    site = {"type": "deterministic", "name": name, "value": value,
            "dist": None, "generator": None}
    for h in reversed(_HANDLER_STACK):
        h.process(site)
    for h in _HANDLER_STACK:
        h.postprocess(site)
    return value


# --------------------------------------------------------------------- #
# MUSE problem adapter
# --------------------------------------------------------------------- #

def _bij_for(dist: Distribution):
    # the distribution's own bijector carries its support's bounds (a
    # Uniform(2, 5) latent links through Logit(2, 5), not Logit(0, 1))
    return dist.bijector()


def _site_logpdf(site) -> torch.Tensor:
    return torch.sum(site["dist"].log_prob(site["value"]))


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _same(a, b) -> bool:
    return np.array_equal(_host(a), _host(b), equal_nan=True)


def _infer_root_sites(site_order, observed, dists1, dists2, values):
    """Default hyper sites when ``params`` is omitted: the model-graph root
    sites — non-observed sample sites whose distribution parameters are
    constants (the Soss adapter's graph-leaf default, src/soss.jl:91-94).
    The model was traced again with every site's value perturbed
    (``dists2``); a site whose density at a fixed point changed has a
    random parent. A heuristic: a parent whose influence cancels exactly
    at the probe point is missed — pass ``params`` for full control."""
    roots = [n for n in site_order if n not in observed and _same(
        _site_logpdf({"dist": dists1[n], "value": values[n]}),
        _site_logpdf({"dist": dists2[n], "value": values[n]}))]
    if not roots:
        raise ValueError(
            "could not infer hyper sites: every non-observed site's "
            "distribution depends on another site — pass params= "
            "explicitly (the src/soss.jl:91-94 graph-leaf default only "
            "covers root sites)")
    return tuple(roots)


class PPLMuseProblem(MuseProblem):
    """Adapt a handler-PPL model to the MUSE interface.

    Args:
      model: the model function (calls ``ppl.sample``).
      observed: conditioned site values, the data x (``model | (;x)``).
      params: names of the hyper-parameter sites θ; ``("theta",)`` by
        default (the Turing adapter's ``params=(:θ,)``); None infers the
        model-graph root sites (src/soss.jl:91-94).
      model_args: extra positional arguments for ``model``.
      volume_factor: whether transformed-θ densities include the
        change-of-variables term (Turing True, Soss False).
      device: where the data, the draws and the densities live; without
        it, the device of the first observed tensor, else the card.

    The model's sites are found by tracing it once with a generator seeded
    0 on ``device``. The probes that infer root sites and θ-only factors
    trace it again on the host side of the solver, outside any transform.
    """

    def __init__(self, model: Callable, *, observed: Dict[str, Any],
                 params: Sequence[str] = ("theta",), model_args: tuple = (),
                 volume_factor: bool = True, device=None):
        if device is None:
            device = next((v.device for v in observed.values()
                           if isinstance(v, torch.Tensor)), "cuda")
        self.device = device
        dev = self.device
        self.volume_factor = volume_factor
        self.model = model
        self.model_args = tuple(model_args)
        self.observed = {k: _observed_value(v, dev)
                         for k, v in observed.items()}

        # --- site discovery (src/turing.jl:137-140) ------------------- #
        with trace() as tr, seed(lane_generator(0, dev)):
            model(*self.model_args)
        self.site_order = [n for n, s in tr.sites.items()
                           if s["type"] == "sample"]
        self.factor_sites = tuple(n for n, s in tr.sites.items()
                                  if s["type"] == "factor")
        if params is None:
            base = {n: tr.sites[n]["value"] for n in self.site_order}
            pert = {n: base[n] * 1.173 + 0.31891 for n in self.site_order}
            with trace() as tr2, substitute(pert):
                model(*self.model_args)
            params = _infer_root_sites(
                self.site_order, self.observed,
                {n: tr.sites[n]["dist"] for n in self.site_order},
                {n: tr2.sites[n]["dist"] for n in self.site_order}, base)
        self.params = tuple(params)
        missing = [p for p in self.params if p not in self.site_order]
        if missing:
            bad = [p for p in missing if p in self.factor_sites]
            if bad:
                raise ValueError(f"{bad} are factor sites — they carry a "
                                 "density term, not a random variable, so "
                                 "they cannot be hyper parameters")
            raise ValueError(f"params {missing} are not sites of the model")
        bad_obs = [o for o in self.observed if o not in self.site_order]
        if bad_obs:
            bad = [o for o in bad_obs if o in self.factor_sites]
            if bad:
                raise ValueError(f"{bad} are factor sites — they carry a "
                                 "density term, not a random variable, so "
                                 "they cannot be observed")
            raise ValueError(f"observed {bad_obs} are not model sites")
        # observed values take each site's full traced shape (a scalar
        # observed under a plate is observed at every plate index), which
        # keeps the data lane shaped like the sim lanes; extra leading dims
        # are an error rather than extra density terms
        for k in self.observed:
            full = tuple(tr.sites[k]["value"].shape)
            try:
                self.observed[k] = torch.broadcast_to(self.observed[k], full)
            except RuntimeError:
                raise ValueError(
                    f"observed[{k!r}] has shape "
                    f"{tuple(self.observed[k].shape)}, which does not "
                    f"broadcast to site {k!r}'s shape {full} (its plate/"
                    "batch + event shape). MUSE compares the data against "
                    "same-shaped simulations, so extra leading dims are "
                    "not meaningful here — reshape the data or add a "
                    "plate to the model.") from None
        self.latent_vars = tuple(
            n for n in self.site_order
            if n not in self.observed and n not in self.params)
        if not self.latent_vars:
            raise ValueError("model has no latent sites")

        # --- factor sites --------------------------------------------- #
        # every factor enters log_like; a factor whose value does not move
        # when every non-θ site is perturbed depends on θ alone and also
        # enters log_prior
        self._prior_factors: tuple = ()
        if self.factor_sites:
            base = {n: tr.sites[n]["value"] for n in self.site_order}
            probe = {n: (base[n] if n in self.params
                         else base[n] * 1.173 + 0.31891)
                     for n in self.site_order}
            with trace() as trf, substitute(probe):
                model(*self.model_args)
            self._prior_factors = tuple(
                n for n in self.factor_sites
                if _same(tr.sites[n]["value"], trf.sites[n]["value"]))

        # per-site support bijectors (supports must not depend on θ, as in
        # Turing's link machinery)
        self._site_bij = {n: _bij_for(tr.sites[n]["dist"])
                          for n in self.site_order}
        self._discovery = tr.sites

        # θ's blockwise bijector over the flat θ, in ThetaSpec's sorted-key
        # order
        hyper_sorted = sorted(self.params)
        sizes = [max(1, tr.sites[n]["value"].numel()) for n in hyper_sorted]
        bijs = [self._site_bij[n] for n in hyper_sorted]
        if all(b.name == "identity" for b in bijs):
            self.theta_bijector = None
        else:
            self.theta_bijector = tf.Blockwise(bijs, sizes)

        self.x = {k: self.observed[k] for k in sorted(self.observed)}

    # ----------------------------------------------------------------- #

    def _theta_dict(self, theta) -> Dict[str, Any]:
        if isinstance(theta, dict):
            extra = set(theta) - set(self.params)
            if extra:
                raise ValueError(f"unknown θ entries {sorted(extra)}; "
                                 f"params are {self.params}")
            return {k: _as_value(v) for k, v in theta.items()}
        if len(self.params) == 1:
            return {self.params[0]: _as_value(theta)}
        raise ValueError(f"θ must be a dict naming each of {self.params}")

    def sample_x_z(self, generator, theta) -> Tuple[Dict, Dict]:
        """Forward-sample (x, z) | θ; z in unconstrained space."""
        with trace() as tr, seed(generator), \
                substitute(self._theta_dict(theta)):
            self.model(*self.model_args)
        x = {n: tr.sites[n]["value"] for n in sorted(self.observed)}
        z = {n: self._site_bij[n].forward(tr.sites[n]["value"])
             for n in sorted(self.latent_vars)}
        return x, z

    def log_like(self, x, z, theta) -> torch.Tensor:
        """Linked log-joint: every site's density with z's
        unconstrained-space volume factors (``DynPPL.logjoint`` with z
        linked, src/turing.jl:192-196). It includes the θ-prior term, which
        cancels in the MUSE score's data − sims difference and moves
        neither J nor H."""
        values = dict(self._theta_dict(theta))
        ldj = 0.0
        for n in sorted(self.latent_vars):
            b = self._site_bij[n]
            zc = b.inverse(z[n])
            values[n] = zc
            # linked density: log p_c(z_c) − log|det ∂b/∂z_c|
            ldj = ldj - b.log_det_jacobian(zc)
        for n in sorted(self.observed):
            values[n] = x[n]
        with trace() as tr, substitute(values):
            self.model(*self.model_args)
        lp = sum(_site_logpdf(tr.sites[n]) for n in self.site_order)
        lp = lp + sum(torch.sum(tr.sites[n]["value"])
                      for n in self.factor_sites)
        return lp + ldj

    def log_prior(self, theta) -> torch.Tensor:
        """θ-prior alone (``model_for_prior``, src/turing.jl:198-202): the
        θ sites' densities with every other site at its discovery value."""
        values = dict(self._theta_dict(theta))
        for n in self.site_order:
            if n not in values:
                values[n] = self._discovery[n]["value"]
        with trace() as tr, substitute(values):
            self.model(*self.model_args)
        return (sum(_site_logpdf(tr.sites[n]) for n in self.params)
                + sum(torch.sum(tr.sites[n]["value"])
                      for n in self._prior_factors))


def model_problem(model: Callable, theta0, observed: Dict[str, Any],
                  **kwargs) -> PPLMuseProblem:
    """A :class:`PPLMuseProblem` whose ``params`` are the keys of θ₀ (the
    ``muse(model, (σ=0.5, θ=0))`` overload, src/turing.jl:245-256). A θ₀
    without keys falls back to graph-root inference (``params=None``)."""
    params = tuple(theta0.keys()) if isinstance(theta0, dict) else None
    return PPLMuseProblem(model, observed=observed, params=params, **kwargs)
