"""The MUSE problem interface.

Counterpart of ``muse_tpu/problem.py`` (the reference's
``AbstractMuseProblem``, ``src/interface.jl``):

  reference (Julia)                    here (PyTorch)
  -----------------                    --------------
  sample_x_z(prob, rng, θ)             MuseProblem.sample_x_z(generator, θ)
  logLike(prob, x, z, θ, θ_space)      MuseProblem.log_like(x, z, θ)
  ∇θ_logLike / logLike_and_∇z_logLike  torch.func.grad of log_like
  logPriorθ(prob, θ, θ_space)          MuseProblem.log_prior(θ)
  transform_θ / inv_transform_θ        MuseProblem.theta_bijector
  ẑ_guess_from_truth                   MuseProblem.zhat_guess_from_truth

x and z are tensors, or pytrees of tensors (the PPL's are dicts keyed by
site), on the problem's ``device``; θ is a tensor (0-d for a scalar θ) or
a mapping of tensors. Every user function must be composable
with ``torch.func`` (``grad``, ``vmap``, ``jacfwd``). The sampler takes a
``torch.Generator`` on the problem's device, never global RNG state.

The device defaults to the card: a problem that is given no device (and
no tensor to take one from) resolves ``"cuda"``, and raises where there is
none. The CPU is used only when asked for.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .utils.device import resolve_device
from .utils.tree import TreeSpec, tree_map

__all__ = ["MuseProblem", "check_self_consistency"]


class MuseProblem:
    """Base class for MUSE problems.

    Subclasses implement :meth:`sample_x_z` and :meth:`log_like` and set
    ``x`` and ``device``; everything else has the reference's defaults
    (``src/interface.jl:20,28,120-121,134,184-186``).
    """

    #: observed data (x), a tensor or a pytree of tensors on ``device``.
    x: Any = None

    _device: Optional[torch.device] = None

    @property
    def device(self) -> torch.device:
        """Where the problem's tensors live: the card unless set."""
        if self._device is None:
            self._device = resolve_device("cuda")
        return self._device

    @device.setter
    def device(self, device) -> None:
        self._device = resolve_device(device)

    #: bijector (``forward``, ``inverse``, ``log_det_jacobian`` on flat θ
    #: tensors) from θ's constrained space to the unconstrained space of the
    #: outer Newton iteration; ``None`` ⇒ identity.
    theta_bijector: Optional[Any] = None

    #: whether transformed-space densities include the log-volume factor
    #: (Turing convention True, src/turing.jl:171-186; Soss False).
    volume_factor: bool = True

    #: a batched latent solver ``(xs, Z0_flat, θ_flat, atol) -> (Z_flat,
    #: aux)`` over all lanes at once — the analog of overriding ẑ_at_θ.
    custom_zhat = None

    #: optional analytic ``(x, z, θ) -> ∂θ log_like`` (∇θ_logLike override).
    grad_theta_log_like = None

    #: optional CRN white split of the sampler (muse_tpu/problem.py:137-156):
    #: ``sample_white(generator) -> W`` draws every θ-independent random
    #: intermediate as a tuple of tensors, and ``x_of_white(W, θ) -> (x, z)``
    #: completes the sample deterministically, such that
    #: ``sample_x_z(g, θ) ≡ x_of_white(sample_white(g), θ)`` for generators
    #: seeded alike. ``muse_fit`` then draws W once per fit and runs
    #: ``muse_step_white``; implicit-diff ``get_H`` differentiates
    #: ``x_of_white`` in θ. ``check_self_consistency`` checks the contract.
    sample_white = None
    x_of_white = None

    #: the parts of W that x depends on (indices into the tuple), or None for
    #: all. The iteration keeps only these resident and passes None for the
    #: others; ``x_of_white`` then returns ``(x, None)``.
    x_white_parts: Optional[Tuple[int, ...]] = None

    #: optional ``sample_whites_batched(seeds, x_only) -> W``: the whites of
    #: every lane of ``seeds`` at once, a tuple of (B, …) tensors equal lane
    #: by lane to ``sample_white(lane_generator(seed))``; with ``x_only`` the
    #: parts outside ``x_white_parts`` are None. ``CompiledProblem``'s
    #: ``sample_whites`` takes it where it exists, else loops over the lanes.
    sample_whites_batched = None

    #: the model's name for messages (a model constructor sets it).
    name: Optional[str] = None

    #: the :class:`~muse_tpu_torch.parallel.SimsMesh` whose field axis
    #: shards this problem's latent on the sharded-sum route, or None. A
    #: model built with ``mesh=`` sets it, with ``field_slice`` (this rank's
    #: slice of the flat latent) and ``field_size`` (the whole latent's
    #: length); its ``custom_zhat`` and ``grad_theta_log_like`` then work on
    #: this rank's coordinates and return partial sums, which the solver
    #: sums over the axis. Any other problem solved with a field-axis mesh
    #: takes the gathered route, whose slice and length the solver keeps
    #: (``CompiledProblem.field_slice``/``field_size``), and sees the whole
    #: latent in every function it defines. A ``custom_zhat`` that takes a
    #: ``field`` keyword (a :class:`~muse_tpu_torch.parallel.FieldColumns`)
    #: runs there on this rank's columns itself; any other runs on the
    #: gathered latent.
    field_mesh = None
    field_slice: slice = slice(None)
    field_size: Optional[int] = None

    def sample_x_z(self, generator: torch.Generator, theta) -> Tuple[Any, Any]:
        """Joint forward sample ``(x, z) ~ P(x, z | θ)``, a deterministic
        function of the generator's seed (common random numbers)."""
        raise NotImplementedError

    def log_like(self, x, z, theta) -> torch.Tensor:
        """Joint log density ``log P(x, z | θ)`` (0-d tensor)."""
        raise NotImplementedError

    def log_prior(self, theta) -> torch.Tensor:
        """``log P(θ)``; flat by default (src/interface.jl:121)."""
        return torch.zeros((), device=self.device)

    def zhat_guess_from_truth(self, x, z, theta):
        """Starting guess for a simulation's MAP given its true z: ``zero(z)``
        (src/interface.jl:184-186)."""
        return tree_map(torch.zeros_like, z)

    def transform_theta(self, theta_flat):
        b = self.theta_bijector
        return theta_flat if b is None else b.forward(theta_flat)

    def inv_transform_theta(self, theta_t_flat):
        b = self.theta_bijector
        return theta_t_flat if b is None else b.inverse(theta_t_flat)

    def _log_volume(self, theta_flat):
        """log|det ∂transform/∂θ| at an untransformed flat θ."""
        b = self.theta_bijector
        if b is None or not self.volume_factor:
            return theta_flat.sum() * 0.0
        return b.log_det_jacobian(theta_flat)


def check_self_consistency(problem: MuseProblem, theta, *, seed: int = 0,
                           atol=1e-2, eps=1e-3, dtype=torch.float32):
    """Problem self-test (src/interface.jl:209-230), with ``torch.func`` AD.

    Checks, at the given θ:
      1. θ-transform round trip: ``inv(transform(θ)) ≈ θ``;
      2. prior volume factor: ``logPrior(θ) ≈ logPrior_t(transform(θ)) + V(θ)``;
      3. chain rule across θ-spaces:
         ``∇θ logLike(θ) ≈ J(θ)ᵀ ∇θ′ logLike_t(θ′) + ∇θ V(θ)``;
      4. AD against central finite differences of ∇z log_like;
      5. when the problem declares the white split, that
         ``x_of_white(sample_white(g), θ)`` reproduces ``sample_x_z(g, θ)``
         for two generators seeded alike.

    Raises AssertionError listing every failed check.
    """
    from torch.func import grad, jacfwd

    from .theta import ThetaSpec
    from .utils.keys import lane_generator

    dev = problem.device
    spec = ThetaSpec.from_example(theta, dtype=dtype)
    th = torch.as_tensor(spec.flatten(theta), dtype=dtype, device=dev)

    x, z = problem.sample_x_z(lane_generator(seed, dev), spec.unflatten(th))
    zspec = TreeSpec(z)
    z_flat = zspec.flatten(z).to(dtype)
    failures = []

    def check(name, a, b):
        err = float(torch.max(torch.abs(torch.as_tensor(a) -
                                        torch.as_tensor(b))))
        if not err < atol:
            failures.append(f"{name}: max abs err {err:.3e} (atol {atol})")

    # 1. round trip
    th_t = problem.transform_theta(th)
    check("transform round-trip", problem.inv_transform_theta(th_t), th)

    V = problem._log_volume
    inv = problem.inv_transform_theta

    def logp(t):
        return torch.as_tensor(problem.log_prior(spec.unflatten(t))).to(dtype)

    def logp_t(tt):
        return logp(inv(tt)) - V(inv(tt))

    # 2. prior volume factor
    check("prior volume factor", logp(th), logp_t(th_t) + V(th))

    # 3. gradient chain rule across θ-spaces
    def ll(t, zf=z_flat):
        return problem.log_like(x, zspec.unflatten(zf),
                                spec.unflatten(t)).to(dtype)

    def ll_t(tt):
        return ll(inv(tt)) - V(inv(tt))

    g_u = grad(ll)(th)
    g_t = grad(ll_t)(th_t)
    J = jacfwd(problem.transform_theta)(th)
    gV = grad(V)(th)
    check("θ-space gradient chain rule", g_u, J.T @ g_t + gV)

    # 4. ∇z AD against central finite differences on a few coordinates.
    # FD on a large-sum objective is limited by cancellation noise
    # ~|f|·ε_machine/eps, so the tolerance follows the objective's scale.
    g_z = grad(lambda zf: ll(th, zf))(z_flat)
    f0 = ll(th)
    eps_mach = float(torch.finfo(dtype).eps)
    fd_atol = max(atol, 10.0 * abs(float(f0)) * eps_mach / eps)
    n = z_flat.shape[0]
    for i in sorted({int(v) for v in torch.linspace(0, n - 1, min(5, n))}):
        e = torch.zeros_like(z_flat)
        e[i] = eps
        fd = (float(ll(th, z_flat + e)) - float(ll(th, z_flat - e))) / (2 * eps)
        err = abs(float(g_z[i]) - fd)
        if not err < fd_atol:
            failures.append(f"∇z AD vs FD [coord {i}]: err {err:.3e} "
                            f"(fd_atol {fd_atol:.3e})")

    # 5. the CRN white split, when declared
    if problem.x_of_white is not None or problem.sample_white is not None:
        if problem.x_of_white is None or problem.sample_white is None:
            failures.append("sample_white/x_of_white must be declared "
                            "together (one of them is None)")
        else:
            W = problem.sample_white(lane_generator(seed, dev))
            xw, zw = problem.x_of_white(W, spec.unflatten(th))
            for name, a, b in (("x", x, xw), ("z", z, zw)):
                a, b = TreeSpec(a).flatten(a), TreeSpec(b).flatten(b)
                err = float(torch.max(torch.abs(a - b))) if a.numel() else 0.0
                if not err < atol:
                    failures.append(
                        f"white-split {name}: x_of_white(sample_white(g), θ) "
                        f"differs from sample_x_z(g, θ) by {err:.3e}")

    if failures:
        raise AssertionError("self-consistency failures:\n  " +
                             "\n  ".join(failures))
    return True
