"""The device mesh: the sims axis and the field axis for every problem,
over ``torch.distributed``.

Counterpart of ``muse_tpu/parallel/mesh.py``. JAX shards the batched
per-sim arrays of one controller over a ``jax.sharding.Mesh`` and lets
GSPMD partition every step. Here the mesh is one process per device, as
``torchrun`` launches them, and the solver shards by hand:

  * the **sims axis** splits the lanes of every chunk into contiguous
    blocks (:meth:`SimsMesh.lane_block`). Each rank runs its block through
    the same batched step as one device would, and the per-lane results
    are gathered to every rank before the float64 host update. Lane seeds
    are global (``utils/keys.py``), so sharding changes no sim;
  * the **field axis** splits every lane's latent (:meth:`SimsMesh.field_rows`)
    by one of two routes (``solver/compiled.py``):

      - the *sharded-sum route*, for the problems built with ``mesh=``
        (``grf_spectral_problem``, ``bandpower_problem``, ``grf_problem``):
        the rank holds rows of the packed (n, 2m) grid (the pixel rows of
        ``grf_problem``'s latent), its functions compute on those rows, and
        only the per-lane sums over the latent cross ranks — the CG's dot
        products and norms and the θ-score, each by
        :meth:`SimsMesh.reduce_field`. ``grf_problem``'s entry and exit
        transforms gather each lane's field whole (:meth:`SimsMesh.gather_field`),
        transform it locally and keep the rank's rows;
      - the *gathered route*, for every other problem: the solver keeps the
        rank's columns of each lane's flat latent (and of every vector of
        its MAP solver), reduces every dot product over the field axis and
        takes every sup-norm as a max (:meth:`SimsMesh.reduce_field_max`),
        and evaluates the problem's own functions on the latent gathered
        whole. This shards the solver's state and its vector arithmetic;
        each rank still evaluates the log-density on the whole latent.

Only ``all_reduce`` and ``broadcast`` are used: NCCL and gloo both take
them on CUDA tensors (SUM and MAX alike), and gloo has no CUDA
``all_gather``. A gather is an ``all_reduce(SUM)`` of a zero-filled global
buffer in which each rank has written only its own block; adding zeros
rounds nothing, so it is exact. No collective runs inside
``torch.func.vmap`` or ``grad``.

Launch (one process per card, NCCL)::

    torchrun --nproc-per-node 4 fit.py      # in fit.py:
    torch.distributed.init_process_group("nccl")
    mesh = make_sims_mesh()                 # or sims=2, field=2
    prob = grf_spectral_problem(n=1024, sigma_noise=0.01, mesh=mesh)
    res = muse(prob, 0.5, nsims=512, mesh=mesh, ...)

On the CPU: ``init_process_group("gloo")`` and
``make_sims_mesh(device_type="cpu")``. The caller chooses the backend;
this module never initialises a process group itself.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["SimsMesh", "FieldColumns", "make_sims_mesh"]


def _block(n: int, parts: int, i: int) -> tuple:
    """The i-th of ``parts`` contiguous blocks of ``range(n)``, the first
    ``n % parts`` blocks one longer: (start, stop)."""
    q, r = divmod(n, parts)
    lo = i * q + min(i, r)
    return lo, lo + q + (i < r)


class SimsMesh:
    """A mesh with a ``sims`` data axis and an optional ``field`` axis,
    seen from one rank.

    Attributes: ``device_mesh`` (the torch ``DeviceMesh``), ``device`` (the
    rank's device), ``sims_axis`` and ``field_axis`` (None without a field
    axis), ``n_sims_shards`` and ``n_field_shards``, the rank's position
    ``sims_rank`` and ``field_rank`` on each axis and its global ``rank``,
    the process groups ``sims_group`` and ``field_group``. ``collectives``
    and ``collective_bytes`` count the collectives this rank took part in
    and the bytes of their buffers; ``gathers``/``gather_bytes`` and
    ``max_reduces`` count the field gathers and the field maxima among
    them."""

    def __init__(self, device_mesh, device: torch.device,
                 sims_axis: str = "sims", field_axis: Optional[str] = None):
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.sims_axis = sims_axis
        self.field_axis = field_axis
        self.rank = dist.get_rank()
        self.n_sims_shards = device_mesh.size(0)
        self.sims_rank = device_mesh.get_local_rank(sims_axis)
        self.sims_group = device_mesh.get_group(sims_axis)
        if field_axis is None:
            self.n_field_shards, self.field_rank = 1, 0
            self.field_group = None
        else:
            self.n_field_shards = device_mesh.size(1)
            self.field_rank = device_mesh.get_local_rank(field_axis)
            self.field_group = device_mesh.get_group(field_axis)
        self.reset_counts()

    def reset_counts(self) -> None:
        """Zero the collective counters."""
        self.collectives = 0
        self.collective_bytes = 0
        self.gathers = 0
        self.gather_bytes = 0
        self.max_reduces = 0

    def __repr__(self):
        axes = f"sims={self.n_sims_shards}"
        if self.field_axis is not None:
            axes += f" × field={self.n_field_shards}"
        return f"SimsMesh({axes}, rank {self.rank} on {self.device})"

    # ------------------------------------------------------------ #
    # what this rank holds
    # ------------------------------------------------------------ #

    def lane_block(self, n_lanes: int) -> tuple:
        """This rank's contiguous block (start, stop) of ``n_lanes`` lanes on
        the sims axis. Blocks differ in length by at most one; a rank may
        hold none (it still joins every collective)."""
        return _block(n_lanes, self.n_sims_shards, self.sims_rank)

    def field_rows(self, n_rows: int) -> slice:
        """This rank's rows of a packed (n_rows, 2m) grid on the field axis."""
        return slice(*_block(n_rows, self.n_field_shards, self.field_rank))

    # ------------------------------------------------------------ #
    # collectives
    # ------------------------------------------------------------ #

    def _all_reduce(self, t: torch.Tensor, group,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        self.collectives += 1
        self.collective_bytes += t.numel() * t.element_size()
        dist.all_reduce(t, op=op, group=group)
        return t

    def reduce_field(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the field axis of a per-rank partial sum (a new
        tensor; ``t`` itself is left as it is). Every rank of a field
        group gets the same bits."""
        if self.n_field_shards == 1:
            return t
        return self._all_reduce(t.detach().clone(), self.field_group)

    def reduce_field_max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum over the field axis of a per-rank value (a new
        tensor): a lane's sup-norm from each rank's sup-norm over its
        columns. Every rank of a field group gets the same bits."""
        if self.n_field_shards == 1:
            return t
        self.max_reduces += 1
        return self._all_reduce(t.detach().clone(), self.field_group,
                                dist.ReduceOp.MAX)

    def gather_field(self, local: torch.Tensor, cols: slice,
                     size: int) -> torch.Tensor:
        """The (…, size) whole of every lane's vector from this rank's
        columns ``cols`` of it (``local``, (…, cols)), over the field group
        only, in ``local``'s dtype. Exact: the other ranks' columns are
        zeros in this rank's buffer."""
        if self.n_field_shards == 1:
            return local
        full = torch.zeros(local.shape[:-1] + (size,), dtype=local.dtype,
                           device=local.device)
        full[..., cols] = local
        self.gathers += 1
        self.gather_bytes += full.numel() * full.element_size()
        return self._all_reduce(full, self.field_group)

    def gather_sims(self, local, lo: int, n: int) -> np.ndarray:
        """The (n, …) float64 host array of every rank's lanes, from this
        rank's ``local`` block (lanes ``lo .. lo+len(local)``)."""
        local = np.asarray(local, np.float64)
        full = np.zeros((n,) + local.shape[1:], np.float64)
        full[lo:lo + local.shape[0]] = local
        if self.n_sims_shards == 1:
            return full
        t = torch.from_numpy(full).to(self.device)
        return self._all_reduce(t, self.sims_group).cpu().numpy()

    def gather_maps(self, local: torch.Tensor, lo: int, n: int,
                    cols: Optional[slice] = None,
                    n_cols: Optional[int] = None) -> torch.Tensor:
        """Latent maps of every lane on every rank: this rank's (lanes
        ``lo ..``, columns ``cols`` of ``n_cols``) block of an (n, n_cols)
        array, completed over both axes in its own dtype."""
        n_cols = local.shape[1] if n_cols is None else n_cols
        cols = slice(None) if cols is None else cols
        full = torch.zeros((n, n_cols), dtype=local.dtype,
                           device=self.device)
        full[lo:lo + local.shape[0], cols] = local
        if self.n_sims_shards * self.n_field_shards == 1:
            return full
        return self._all_reduce(full, None)

    def broadcast_host(self, values) -> np.ndarray:
        """Global rank 0's float64 ``values`` on every rank."""
        arr = np.atleast_1d(np.asarray(values, np.float64))
        if dist.get_world_size() == 1:
            return arr
        t = torch.from_numpy(arr.copy()).to(self.device)
        self.collectives += 1
        self.collective_bytes += t.numel() * t.element_size()
        dist.broadcast(t, src=0)
        return t.cpu().numpy()


class FieldColumns:
    """This rank's columns of a length-``size`` vector space on the field
    axis of ``mesh``: the gathered route's view of one latent (the solver's
    flat z, or a MAP solver's own blocks).

    ``cols`` is the slice this rank holds; :meth:`gather` completes a
    (…, cols) block to the (…, size) whole, :meth:`keep` cuts a whole to
    this rank's columns, :meth:`reduce` sums per-lane partial sums over the
    axis and :meth:`reduce_max` takes their maximum. With no field axis
    (``mesh`` None or a field axis of 1) every method is the identity and
    ``cols`` is every column."""

    def __init__(self, mesh: Optional["SimsMesh"], size: int):
        self.mesh = mesh if mesh is not None and mesh.n_field_shards > 1 \
            else None
        self.size = size
        self.cols = (slice(0, size) if self.mesh is None
                     else self.mesh.field_rows(size))
        self.n = self.cols.stop - self.cols.start

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return local
        return self.mesh.gather_field(local, self.cols, self.size)

    def keep(self, whole: torch.Tensor) -> torch.Tensor:
        return whole if self.mesh is None else whole[..., self.cols]

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mesh is None else self.mesh.reduce_field(t)

    def reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mesh is None else self.mesh.reduce_field_max(t)

    def on_columns(self, op):
        """A map of whole (…, size) vectors as one of this rank's columns:
        gather, ``op``, keep."""
        return lambda V: self.keep(op(self.gather(V)))

    def value_and_grad(self, fn):
        """A batched value and gradient of whole lanes, ``(B, size) ->
        ((B,), (B, size))``, as one on this rank's columns: the whole f and
        this rank's columns of g."""
        def on_cols(V):
            f, g = fn(self.gather(V))
            return f, self.keep(g)
        return on_cols

    def hvp_at(self, fn):
        """``batched_newton_cg``'s ``hvp_at`` hook for the whole-lane
        ``fn`` of :meth:`value_and_grad`: at this rank's columns U, the
        Hessian-vector product columns → columns. The vjp of the gradient
        is taken at the gathered U (no collective is differentiated) and
        its graph built once; each product gathers its vector."""
        def at(U):
            _, vjp_fn = torch.func.vjp(lambda W: fn(W)[1], self.gather(U))
            return lambda v: self.keep(vjp_fn(self.gather(v))[0])
        return at


def make_sims_mesh(*, sims: Optional[int] = None, field: int = 1,
                   device_type: str = "cuda") -> SimsMesh:
    """A :class:`SimsMesh` over the process group the caller initialised.

    ``sims × field`` must equal the world size; by default every rank goes
    to the sims axis. For ``device_type="cuda"`` the rank's card is
    ``cuda:LOCAL_RANK`` (as ``torchrun`` sets it; ranks modulo the card
    count without it), made current with ``torch.cuda.set_device`` before
    any problem is built. Raises when no process group is initialised: a
    mesh is never quietly one process."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_sims_mesh needs an initialised process group: launch one "
            "process per device (torchrun --nproc-per-node N script.py) and "
            "call torch.distributed.init_process_group('nccl') — 'gloo' on "
            "the CPU — before building the mesh")
    world = dist.get_world_size()
    if field < 1:
        raise ValueError(f"field must be >= 1, got {field}")
    if sims is None:
        sims = world // field
    if sims * field != world:
        raise ValueError(f"sims({sims}) × field({field}) != world size "
                         f"({world})")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_sims_mesh(device_type='cuda') but "
                               "torch.cuda.is_available() is False")
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    from torch.distributed.device_mesh import init_device_mesh
    if field > 1:
        dm = init_device_mesh(device_type, (sims, field),
                              mesh_dim_names=("sims", "field"))
        return SimsMesh(dm, device, "sims", "field")
    dm = init_device_mesh(device_type, (sims,), mesh_dim_names=("sims",))
    return SimsMesh(dm, device, "sims", None)
