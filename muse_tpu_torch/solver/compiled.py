"""Batched problem: the device execution path behind the MUSE solver.

Counterpart of ``muse_tpu/solver/compiled.py``. Every per-simulation
quantity of an outer iteration is computed for all lanes of a chunk at
once, eagerly, on the problem's device:

  * ``muse_step``  — sample all sims at θ (common random numbers), run all
                     latent MAP solves in one batched call, and take the
                     per-lane θ-gradients (src/muse.jl:169-176);
  * ``sample_whites``/``muse_step_white`` — the same step with the
                     θ-independent randomness drawn once per fit, for
                     problems that declare the CRN white split;
  * ``j_sims``     — get_J's per-sim pipeline (src/muse.jl:508-513);
  * ``h_fiducial``/``h_fd`` — get_H's finite-difference pipeline, batched
                     over sims × θ-columns × stencil (src/muse.jl:417-433);
  * ``h_implicit_with``/``h_implicit_from_whites`` — get_H's
                     implicit-differentiation estimator (src/muse.jl:335-405),
                     batched over a chunk of sims.

Lane 0..B-1 of every batched tensor is one simulation; the observed data
ride as the lane whose global id is 0 in ``muse_step``
(``[nothing; split_rng(rng, nsims)]``, src/muse.jl:169). Per-lane
θ-gradients are ``torch.func.vmap(torch.func.grad(log_like))``, so a
kernel with a ``vmap`` rule (``ops/grf_spectrum.py``) sees every lane in
one launch. Sampling is a loop over the lanes' generators, or one batched
draw where the problem has ``sample_whites_batched``.

The latent MAPs of a problem without its own ``custom_zhat`` are one
:func:`~muse_tpu_torch.ops.lbfgs.batched_lbfgs` over all lanes, on
``vmap(grad_and_value(−log_like))``. x and z may be pytrees (the PPL's are
dicts of tensors): z is flattened per lane by a :class:`TreeSpec`, and
x's leaves are stacked, mixed and indexed leaf by leaf. The JAX package's
``optimization_barrier`` fences, odd-lane padding and value certifier
guard against faults of the TPU compiler and have no counterpart here.

Under the field axis of a mesh (``parallel/mesh.py``) the route is decided
once, here, from ``problem.field_mesh`` against the solver's ``mesh``:

  * the **sharded-sum route** — a problem built with that ``mesh=``
    (``problem.field_mesh``): its functions see this rank's coordinates and
    compute per-lane partial sums. The θ-scores, implicit H's contractions
    over z and its CG's dot products are summed over the field axis, each
    AFTER its ``vmap``. Its ``log_like`` must be a pure sum over
    coordinates (no per-lane term outside the sum, which the reduction
    would count once per rank), so a θ-bijector, whose volume term is such
    a term, is refused there;
  * the **gathered route** — any other problem, solved with a field-axis
    ``mesh=``. The solver owns z: each lane's flat z is kept as this
    rank's columns ``mesh.field_rows(nz)`` (:attr:`cols`, a
    :class:`~muse_tpu_torch.parallel.FieldColumns`), and so are the MAP
    solvers' vectors (``batched_lbfgs``'s and ``batched_cg``'s ``reduce``
    hooks; a ``custom_zhat`` with a ``field`` keyword runs on columns).
    The problem's own functions (``log_like`` and its gradients, a
    ``custom_zhat`` without that keyword, the implicit-H preconditioner)
    run on z gathered whole, and this rank keeps its columns of what they
    return. f, ∇θ and the θ-scores are then whole on every rank and are
    not reduced again; a θ-bijector's volume term is counted once, as
    without a mesh. The route shards the solver's state and its vector
    arithmetic; each rank still evaluates the log-density on the whole
    latent.

Every gather comes before a ``vmap`` and every reduction after it: no
collective runs inside a ``torch.func`` transform.
"""

from __future__ import annotations

import inspect
from types import SimpleNamespace

import torch
from torch.func import grad, grad_and_value, hessian, jacfwd, jvp, vmap

from ..ops.cg import batched_cg
from ..ops.lbfgs import batched_lbfgs
from ..parallel.mesh import FieldColumns
from ..problem import MuseProblem
from ..theta import ThetaSpec
from ..utils import trace
from ..utils.keys import lane_generator
from ..utils.tree import TreeSpec, tree_map

__all__ = ["CompiledProblem", "sample_whites_counts", "sample_batch_counts",
           "h_fd_counts"]

#: the lanes :meth:`CompiledProblem.sample_whites` drew through a problem's
#: ``sample_whites_batched`` and through the per-lane loop. They are kept
#: here, not on the method, which a caller may wrap.
sample_whites_counts = trace.declare(SimpleNamespace(), "batched_lanes",
                                     "looped_lanes", site="sample_whites")
#: the lanes the keyed route drew one generator at a time
#: (:meth:`CompiledProblem._sample_batch`: ``muse_step``, ``j_sims``,
#: ``h_fiducial``, ``h_fd``)
sample_batch_counts = trace.declare(SimpleNamespace(), "looped_lanes",
                                    site="sample_batch")
#: the MAP solves of :meth:`CompiledProblem.h_fd`'s stencil
h_fd_counts = trace.declare(SimpleNamespace(), "lanes", site="h_fd")


def _lane(tree, i):
    """Lane ``i`` of a batched pytree."""
    return tree_map(lambda v: v[i], tree)


class CompiledProblem:
    """Batched view of a :class:`MuseProblem` on its device.

    ``lbfgs_memory`` and ``lbfgs_max_iters`` configure the generic MAP
    solver (``m`` and ``max_iters`` of :func:`batched_lbfgs`). ``mesh`` is
    the solver's :class:`~muse_tpu_torch.parallel.SimsMesh`: with a field
    axis that the problem was not built with, the problem takes the
    gathered route (module docstring), and ``nz`` is then this rank's
    count of columns of a lane's latent."""

    @trace.spanned("muse.build.compiled")
    def __init__(self, problem: MuseProblem, spec: ThetaSpec, theta0_flat,
                 *, dtype=torch.float32, lbfgs_memory: int = 10,
                 lbfgs_max_iters: int = 500, mesh=None):
        self.problem = problem
        self.spec = spec
        self.dtype = dtype
        self.lbfgs_memory = lbfgs_memory
        self.lbfgs_max_iters = lbfgs_max_iters
        self.device = torch.device(problem.device)
        # z's structure and flat size from one example draw
        _, z0 = problem.sample_x_z(lane_generator(0, self.device),
                                   spec.unflatten(self.theta(theta0_flat)))
        self.zspec = TreeSpec(z0)
        self.x_obs = tree_map(lambda v: v.to(self.device), problem.x)
        self.field = problem.field_mesh
        if self.field is not None and problem.theta_bijector is not None:
            raise ValueError(
                f"{problem.name or type(problem).__name__} shards its latent "
                "over a field axis and has a θ-bijector: the log-volume term "
                "is not a sum over coordinates")
        # the gathered route: a field axis the problem was not built with
        gathered = (self.field is None and mesh is not None
                    and mesh.field_axis is not None)
        self.cols = FieldColumns(mesh if gathered else None, self.zspec.n)
        self.gathered = self.cols.mesh is not None
        self.nz = self.cols.n
        # the per-lane sum over the field axis of a sum over z, for either
        # route (None without a field axis)
        self.zsum = (self.field.reduce_field if self.field is not None
                     else self.cols.reduce if self.gathered else None)
        # the whole latent's length and this rank's slice of it (for a z0
        # given whole and for gathering maps), on either route
        if self.field is not None:
            self.field_slice = problem.field_slice
            self.field_size = problem.field_size
        elif self.gathered:
            self.field_slice, self.field_size = self.cols.cols, self.cols.size
        else:
            self.field_slice, self.field_size = slice(None), None

    def _field_sum(self, t):
        """``t``, a per-lane partial sum over this rank's coordinates on the
        sharded-sum route, summed over the field axis (``t`` itself
        otherwise: on the gathered route it is already whole)."""
        return t if self.field is None else self.field.reduce_field(t)

    def _whole(self, Z):
        """Every lane's whole flat z from this rank's columns: a gather on
        the gathered route, ``Z`` itself otherwise."""
        return self.cols.gather(Z)

    def theta(self, th_flat) -> torch.Tensor:
        """A flat θ (numpy or tensor) on the device in the working dtype."""
        return torch.as_tensor(th_flat, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ #
    # per-lane building blocks (θ and z flat)
    # ------------------------------------------------------------ #

    def _ll(self, x, z_flat, th_flat):
        """log P(x, z | θ), θ untransformed-flat, z flat."""
        return self.problem.log_like(x, self.zspec.unflatten(z_flat),
                                     self.spec.unflatten(th_flat)
                                     ).to(self.dtype)

    def _ll_t(self, x, z_flat, th_t_flat):
        """The same density seen from transformed θ-space (with the
        problem's volume convention, src/turing.jl:171-186)."""
        th = self.problem.inv_transform_theta(th_t_flat)
        return self._ll(x, z_flat, th) - self.problem._log_volume(th)

    def _sample_flat(self, seed, th_flat):
        x, z = self.problem.sample_x_z(lane_generator(seed, self.device),
                                       self.spec.unflatten(th_flat))
        return x, self.zspec.flatten(z).to(self.dtype)

    @trace.spanned("muse.step.sample")
    def _sample_batch(self, seeds, th_flats):
        """Sample lane i from ``seeds[i]`` at θ ``th_flats[i]`` and stack
        (z as the problem draws it: whole on the gathered route), one
        generator a lane; :data:`sample_batch_counts` counts the lanes."""
        sample_batch_counts.looped_lanes += len(seeds)
        xs, Zs = zip(*(self._sample_flat(s, t)
                       for s, t in zip(seeds, th_flats)))
        return tree_map(lambda *v: torch.stack(v), *xs), torch.stack(Zs)

    def _zhat_guess_flat(self, x, z_flat, th_flat):
        g = self.problem.zhat_guess_from_truth(
            x, self.zspec.unflatten(z_flat), self.spec.unflatten(th_flat))
        return self.zspec.flatten(g).to(self.dtype)

    def _zhat_guesses(self, xs, Zs, th_flat):
        """:meth:`_zhat_guess_flat` of every lane from its true z as the
        problem draws it, stacked, as this rank's columns."""
        return self.cols.keep(torch.stack([
            self._zhat_guess_flat(_lane(xs, i), Zs[i], th_flat)
            for i in range(Zs.shape[0])]))

    def _grads_th(self, xs, Z, th_flat):
        """Per-lane ∂θ log_like in untransformed space: the problem's
        analytic override when given (src/interface.jl:56-58), else
        ``vmap(grad)`` — one batched evaluation for all lanes. ``Z`` is
        whole on the gathered route (:meth:`_whole` of the solver's)."""
        if self.problem.grad_theta_log_like is not None:
            def one(x, z):
                g = self.problem.grad_theta_log_like(
                    x, self.zspec.unflatten(z), self.spec.unflatten(th_flat))
                return self.spec.flatten(g).to(self.dtype)
            return self._field_sum(vmap(one)(xs, Z))
        return self._field_sum(vmap(lambda x, z: grad(
            lambda t: self._ll(x, z, t))(th_flat))(xs, Z))

    # ------------------------------------------------------------ #
    # batched MAP solve (ẑ_at_θ, all lanes at once)
    # ------------------------------------------------------------ #

    def _solve_maps(self, xs, Z0, th_flat, atol):
        """All lanes' latent MAP solves → (Z, aux) with per-lane
        diagnostics (the ``ẑ_history`` analog): the problem's
        ``custom_zhat``, else batched L-BFGS on −log_like. On the gathered
        route Z0 and Z are this rank's columns: a ``custom_zhat`` with a
        ``field`` keyword takes them as they are, any other runs on Z0
        gathered whole, and the L-BFGS keeps its vectors as columns with
        its ``reduce`` hooks."""
        zhat = self.problem.custom_zhat
        if zhat is not None:
            if not self.gathered:
                Z, aux = zhat(xs, Z0, th_flat, atol)
            elif "field" in inspect.signature(zhat).parameters:
                Z, aux = zhat(xs, Z0, th_flat, atol, field=self.cols)
            else:
                Z, aux = zhat(xs, self._whole(Z0), th_flat, atol)
                Z = self.cols.keep(Z)
            B = Z.shape[0]
            aux.setdefault("converged", torch.ones(B, dtype=torch.bool,
                                                   device=Z.device))
            aux.setdefault("failed", torch.zeros(B, dtype=torch.bool,
                                                 device=Z.device))
            return Z, aux

        def neg_ll(x, z):
            return -self._ll(x, z, th_flat)

        def fn(Z):
            g, f = vmap(grad_and_value(neg_ll, argnums=1))(xs,
                                                           self._whole(Z))
            return f, self.cols.keep(g)

        hooks = ({"reduce": self.cols.reduce,
                  "reduce_max": self.cols.reduce_max} if self.gathered
                 else {})
        res = batched_lbfgs(fn, Z0, g_atol=atol, m=self.lbfgs_memory,
                            max_iters=self.lbfgs_max_iters, **hooks)
        return res.z, {"converged": res.converged, "failed": res.failed,
                       "iterations": res.iterations, "g_norm": res.g_norm,
                       "neg_logp": res.f}

    # ------------------------------------------------------------ #
    # entry points
    # ------------------------------------------------------------ #

    def _step_from_xs(self, xs_all, th, th_t, Z_prev, lane_ids, atol):
        """Muse-step tail: data-lane mix-in, batched MAP solves, per-lane
        θ-gradients in both spaces (src/muse.jl:169-181)."""
        def mix(obs, sims):
            data = (lane_ids == 0).reshape((-1,) + (1,) * (sims.dim() - 1))
            return torch.where(data, obs[None].to(sims.dtype), sims)

        xs = tree_map(mix, self.x_obs, xs_all)
        with trace.span("muse.step.solve"):
            Z, aux = self._solve_maps(xs, Z_prev, th, atol)
        with trace.span("muse.step.score"):
            Zw = self._whole(Z)
            g = self._grads_th(xs, Zw, th)
            if self.problem.theta_bijector is None:
                g_t = g    # identity transform: the two gradients coincide
            else:
                g_t = vmap(lambda x, z: grad(
                    lambda tt: self._ll_t(x, z, tt))(th_t))(xs, Zw)
            del Zw
        return {"g": g, "g_t": g_t, "Z": Z, **aux}

    def muse_step(self, th, th_t, seeds, Z_prev, lane_ids, atol):
        """One outer iteration's device work for a chunk of lanes.

        ``seeds`` has one seed per lane; the lane whose global id (in
        ``lane_ids``) is 0 has its sample replaced by the observed data.
        Sampling it anyway keeps every lane's work identical. Returns the
        per-lane θ-gradients in both spaces, the new warm starts ``Z`` and
        the MAP diagnostics (src/muse.jl:169-181)."""
        xs_all, _ = self._sample_batch(seeds, [th] * len(seeds))
        return self._step_from_xs(xs_all, th, th_t, Z_prev, lane_ids, atol)

    # ------------------------------------------------------------ #
    # CRN white-hoisted iteration (problem.sample_white / x_of_white)
    # ------------------------------------------------------------ #

    def _require_whites(self, what):
        if self.problem.sample_white is None or \
                self.problem.x_of_white is None:
            raise NotImplementedError(
                f"{what} needs the problem's CRN white split "
                "(sample_white / x_of_white, problem.py); this problem "
                "declares none")

    def _x_parts(self, W) -> tuple:
        """W with None in place of the parts x does not depend on
        (outside ``problem.x_white_parts``)."""
        keep = self.problem.x_white_parts
        return tuple(w if keep is None or i in keep else None
                     for i, w in enumerate(W))

    @trace.spanned("muse.sample_whites")
    def sample_whites(self, seeds, x_only: bool = False):
        """Per-lane θ-independent draws, one generator per seed: a tuple of
        (B, …) tensors, one per part of W. Run once per fit.

        ``x_only`` keeps only the parts that x depends on and puts None in
        place of the others, so a part the iteration never reads is not
        kept resident. A problem with ``sample_whites_batched`` draws every
        lane at once through it; any other loops over the lanes'
        generators. :data:`sample_whites_counts` counts the lanes drawn
        each way."""
        self._require_whites("sample_whites")
        batched = getattr(self.problem, "sample_whites_batched", None)
        if batched is not None:
            sample_whites_counts.batched_lanes += len(seeds)
            return tuple(batched(seeds, x_only))
        sample_whites_counts.looped_lanes += len(seeds)
        lanes = []
        for s in seeds:
            W = tuple(self.problem.sample_white(
                lane_generator(s, self.device)))
            lanes.append(self._x_parts(W) if x_only else W)
        return tuple(None if parts[0] is None
                     else tree_map(lambda *v: torch.stack(v), *parts)
                     for parts in zip(*lanes))

    def _xs_of_whites(self, W_all, th_flat):
        """x of every lane from its whites at θ: the parts x does not
        depend on are dropped first, so ``x_of_white`` computes no z (for
        the packed GRF: never ũ)."""
        W_all = self._x_parts(W_all)
        idx = [i for i, w in enumerate(W_all) if w is not None]
        theta = self.spec.unflatten(th_flat)

        def one(*parts):
            W = list(W_all)
            for i, w in zip(idx, parts):
                W[i] = w
            return self.problem.x_of_white(tuple(W), theta)[0]

        return vmap(one)(*[W_all[i] for i in idx])

    def muse_step_white(self, th, th_t, W_all, Z_prev, lane_ids, atol):
        """:meth:`muse_step` with the RNG hoisted: takes the per-lane whites
        ``W_all`` (from :meth:`sample_whites`) instead of seeds and completes
        only x with ``x_of_white``. Equal to :meth:`muse_step` on the same
        seeds under the white-split contract."""
        self._require_whites("muse_step_white")
        with trace.span("muse.step.x"):
            xs_all = self._xs_of_whites(W_all, th)
        return self._step_from_xs(xs_all, th, th_t, Z_prev, lane_ids, atol)

    def j_sims(self, seeds, th, atol):
        """get_J per-sim pipeline: sample at θ₀, MAP warm-started from the
        true z, untransformed θ-gradient (src/muse.jl:510-513)."""
        xs, Zs = self._sample_batch(seeds, [th] * len(seeds))
        Z, aux = self._solve_maps(xs, self.cols.keep(Zs), th, atol)
        return {"g": self._grads_th(xs, self._whole(Z), th), "Z": Z, **aux}

    @trace.spanned("muse.h.fiducial")
    def h_fiducial(self, seeds, th, atol):
        """get_H fiducial fits: sims at θ₀, MAP from ẑ_guess_from_truth
        (src/muse.jl:417-423)."""
        xs, Zs = self._sample_batch(seeds, [th] * len(seeds))
        Z, aux = self._solve_maps(xs, self._zhat_guesses(xs, Zs, th), th,
                                  atol)
        return {"Z": Z, **aux}

    @trace.spanned("muse.h.fd")
    def h_fd(self, seeds, th, steps, Zfid, atol, offsets):
        """get_H finite-difference mode, batched.

        For every (sim, θ-column j, stencil offset): regenerate the sim at
        θ₀ + offset·εⱼeⱼ with the SAME seed, MAP at the fiducial θ₀
        warm-started from the sim's fiducial fit, θ-gradient at θ₀
        (src/muse.jl:426-433). All nsims·nθ·stencil solves run as one
        batch. Returns g of shape (nsims, nθ, stencil, nθ). ``Zfid`` is
        the solver's (this rank's columns on the gathered route);
        :data:`h_fd_counts` counts the solves."""
        nsims, ntheta, ns = len(seeds), th.shape[0], len(offsets)
        eye = torch.eye(ntheta, dtype=self.dtype, device=self.device)
        offs = torch.as_tensor(offsets, dtype=self.dtype, device=self.device)
        steps = torch.as_tensor(steps, dtype=self.dtype, device=self.device)
        # (nθ columns, stencil, nθ coords)
        th_pert = th[None, None, :] + (offs[None, :, None]
                                       * steps[:, None, None]
                                       * eye[:, None, :])
        flat_seeds = [s for s in seeds for _ in range(ntheta * ns)]
        flat_th = list(th_pert.reshape(-1, ntheta)) * nsims
        h_fd_counts.lanes += len(flat_seeds)
        Z0 = Zfid[:, None, :].expand(nsims, ntheta * ns, self.nz)
        xs, _ = self._sample_batch(flat_seeds, flat_th)
        Z, aux = self._solve_maps(xs, Z0.reshape(-1, self.nz), th, atol)
        g = self._grads_th(xs, self._whole(Z), th).reshape(nsims, ntheta, ns,
                                                           ntheta)
        return {"g": g, "Z": Z,
                "converged": aux["converged"].reshape(nsims, ntheta, ns),
                "failed": aux["failed"].reshape(nsims, ntheta, ns)}

    def h_implicit_with(self, precond=None):
        """get_H implicit-differentiation mode (src/muse.jl:335-405): a
        function ``(seeds, th, atol, cg_maxiter, cg_tol, h1_is_zero) ->
        (Hs (S, nθ, nθ), resid (S, nθ))`` over a chunk of sims.

        The whites are drawn with the lanes' generators outside any
        transform (``torch.func.jacfwd`` refuses random ops), and
        :meth:`h_implicit_from_whites` differentiates ``x_of_white`` — the
        sampler, by the white-split contract. ``precond(w, x, th_flat)`` is
        the reference's ``Pl`` hook (src/muse.jl:312): an approximation of
        A⁻¹w for one sim's flat z-vector w."""
        self._require_whites("implicit-differentiation get_H")

        def run(seeds, th, atol, cg_maxiter, cg_tol, h1_is_zero):
            return self.h_implicit_from_whites(
                self.sample_whites(seeds), th, atol, cg_maxiter, cg_tol,
                h1_is_zero, precond)
        return run

    def h_implicit_from_whites(self, W_all, th, atol, cg_maxiter: int = 100,
                               cg_tol: float = 1e-6, h1_is_zero=False,
                               precond=None):
        """Implicit-diff H for the sims whose whites are ``W_all``.

        Per sim:  H = H1 + H2, with ẑ the MAP of x = x_of_white(W, θ₀):
          H1    = ∂θsim ∇θ logLike(x(θsim), ẑ, θ₀)        (src/muse.jl:353-358)
          dFdθ  = ∂θ ∇z logLike(x, ẑ, θ)                 (:361-365)
          dFdθ1 = ∂θsim ∇z logLike(x(θsim), ẑ, θ₀)       (:366-371)
          A     = −∇z² logLike(x, ·, θ₀) as an HVP        (:373-379)
          H2    = −dFdθᵀ A⁻¹ dFdθ1                       (:380-387)
        The fiducial MAPs of all sims are one batched solve; the A⁻¹
        columns are one ``batched_cg`` with lanes = sims × θ-columns.
        Returns (Hs (S, nθ, nθ), per-column CG residual ‖A y − b‖ (S, nθ)).
        """
        nth = th.shape[0]
        W_all = tuple(W_all)
        spec = self.spec

        def x_at(W, t):
            return self.problem.x_of_white(self._x_parts(W),
                                           spec.unflatten(t))[0]

        def x_z(*W):
            x, z = self.problem.x_of_white(W, spec.unflatten(th))
            return x, self.zspec.flatten(z).to(self.dtype)

        with trace.span("muse.h.maps"):
            xs, zs = vmap(x_z)(*W_all)
            S = zs.shape[0]
            zhat, _ = self._solve_maps(xs, self._zhat_guesses(xs, zs, th),
                                       th, atol)
            # the problem's functions see the whole latent (gathered
            # route); the CG's vectors are this rank's columns of it
            zhat = self._whole(zhat)
        cols = self.cols

        def grad_z(x, z, t):
            return grad(lambda z_: self._ll(x, z_, t))(z)

        def grad_t(x, z, t):
            return grad(lambda t_: self._ll(x, z, t_))(t)

        def per_sim(W, x, zh):
            if h1_is_zero:
                H1 = torch.zeros((nth, nth), dtype=self.dtype,
                                 device=self.device)
            else:
                H1 = jacfwd(lambda t: grad_t(x_at(W, t), zh, th))(th)
            dF = jacfwd(lambda t: grad_z(x, zh, t))(th)            # (nz, nθ)
            dF1 = jacfwd(lambda t: grad_z(x_at(W, t), zh, th))(th)
            return H1, dF, dF1

        with trace.span("muse.h.jac"):
            H1, dFdth, dFdth1 = vmap(per_sim)(W_all, xs, zhat)

        # lanes = (sim, θ-column): solve A y = −dFdθ1 column by column,
        # with A = −∇z² logLike at ẑ (SPD), as an HVP
        with trace.span("muse.h.cg"):
            x_l = tree_map(lambda v: v.repeat_interleave(nth, dim=0), xs)
            zhat_l = zhat.repeat_interleave(nth, dim=0)

            def neg_hvp(V):
                return -cols.keep(vmap(lambda x, zh, v: jvp(
                    lambda z_: grad_z(x, z_, th), (zh,), (v,))[1])(
                        x_l, zhat_l, cols.gather(V)))

            M = None if precond is None else (
                lambda R: cols.keep(vmap(lambda w, x: precond(w, x, th))(
                    cols.gather(R), x_l)))
            rhs = cols.keep(-dFdth1.transpose(1, 2).reshape(S * nth, -1))
            fsum = self.zsum
            res = batched_cg(neg_hvp, rhs, tol=cg_tol, maxiter=cg_maxiter,
                             precond=M, reduce=fsum)
            Y = res.x.reshape(S, nth, self.nz)           # rows: A⁻¹ columns
            H2 = -torch.einsum("szi,sjz->sij", cols.keep(dFdth.transpose(1, 2)
                                                         ).transpose(1, 2), Y)
            d = neg_hvp(res.x) - rhs
            if fsum is None:
                return H1 + H2, torch.linalg.vector_norm(
                    d, dim=-1).reshape(S, nth)
            resid = torch.sqrt(fsum(torch.sum(d * d, -1))).reshape(S, nth)
            if self.gathered:
                # H1 is whole; H2 contracts this rank's columns
                return H1 + fsum(H2), resid
            # H1 and H2 are sums over z: one field sum of both, and of ‖d‖²
            return fsum(H1 + H2), resid

    @property
    def certifier(self):
        raise NotImplementedError(
            "the batch-width value certifier guards a TPU compiler fault and "
            "is left out of the port (ROADMAP, 'Left out on purpose')")

    # ------------------------------------------------------------ #
    # tiny θ-space derivatives (prior / transforms)
    # ------------------------------------------------------------ #

    def _lp_t(self, th_t):
        th = self.problem.inv_transform_theta(th_t)
        return (torch.as_tensor(self.problem.log_prior(
            self.spec.unflatten(th))).to(self.dtype)
            - self.problem._log_volume(th))

    def _lp_u(self, th):
        return torch.as_tensor(self.problem.log_prior(
            self.spec.unflatten(th))).to(self.dtype)

    def prior_grad_t(self, th_t):
        return grad(self._lp_t)(th_t)

    def prior_hess_t(self, th_t):
        return hessian(self._lp_t)(th_t)

    def prior_hess_u(self, th):
        return hessian(self._lp_u)(th)

    def transform(self, th):
        return self.problem.transform_theta(th)

    def inv_transform(self, th_t):
        return self.problem.inv_transform_theta(th_t)
