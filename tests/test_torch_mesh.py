"""The port's mesh (``muse_tpu_torch.parallel``) on 4 gloo processes.

Mirrors ``tests/test_mesh.py`` case by case, at its sizes (n = 16, the
64-dim funnel). Each group of checks is one spawn of 4 ranks
(``tests/torch_mesh_jobs.py``, which imports no JAX), run once per module;
the oracle is the unsharded port on the same calls, which the other port
tests hold against JAX. Tolerances:

  * sims axis: rtol 1e-6 — each rank runs a narrower batch of the same
    lanes with the same seeds; only the batch width of the CPU's FFTs and
    sums differs;
  * field axis: JAX's own (tests/test_mesh.py): θ̂ rtol 1e-4 / atol 1e-4,
    J and H rtol 1e-3 — every sum over the latent is taken in two halves
    (an FD H at 1e-3 of its largest entry); lensing within 0.1, JAX's
    gate for a sharded lensing run, with every MAP converged. The field
    spawn runs every problem: the packed spectral models and the pixel
    ``grf_problem`` on the sharded-sum route, the funnel family, the PPL
    (with a θ-bijector) and lensing on the gathered route;
  * the steps against JAX's 8-device field mesh: tests/test_torch_spectral.py's
    float32 tolerances for the spectral model; for the pixel model, whose
    JAX transform there is the einsum DFT, the 1e-4 of
    tests/test_mesh.py::test_matmul_dft_matches_jnp_fft.

Every rank must end with the same bits (``result`` is the same on every
rank). A spawn that does not finish within its deadline is killed and its
test fails.
"""

import threading

import numpy as np
import pytest
import torch

import muse_tpu_torch as mt
import torch_mesh_jobs as jobs
from muse_tpu_torch.ops.cg import batched_cg
from muse_tpu_torch.parallel import make_sims_mesh

torch.set_num_threads(1)

SIMS_RTOL = 1e-6


@pytest.fixture(scope="module")
def oracle():
    """The unsharded port on every run of both spawns, each run once."""
    out = {}
    for run in dict.fromkeys(jobs.SIMS_RUNS + jobs.FIELD_RUNS):
        out.update(run(None))
    return out


@pytest.fixture(scope="module")
def sims(tmp_path_factory, oracle):
    """(every rank's results on sims=4, the unsharded oracle, the job's
    directory)."""
    out = tmp_path_factory.mktemp("mesh_sims")
    return jobs.spawn("sims", out), oracle, out


def _step_inputs(path):
    """JAX's muse_step_white on an 8-device sims=4 × field=2 mesh, from
    its own whites; the inputs are saved for the port's ranks."""
    import jax
    import jax.numpy as jnp

    import muse_tpu.models.grf as jgrf
    from muse_tpu.parallel import make_sims_mesh as jmesh
    from muse_tpu.solver.compiled import CompiledProblem as JCompiled
    from muse_tpu.theta import ThetaSpec as JSpec

    n, B, sigma = jobs.N, 8, 0.1
    rng = np.random.default_rng(42)
    cfg = jgrf.GrfConfig(n, sigma_noise=sigma)
    z = np.asarray(cfg.apply_sqrtC(jnp.asarray(
        rng.standard_normal((n, n)), jnp.float32), 0.0))
    field = (z + sigma * rng.standard_normal((n, n))).astype(np.float32)
    mesh = jmesh(sims=4, field=2)
    pj = jgrf.grf_spectral_problem(n=n, sigma_noise=sigma,
                                   x_obs=jnp.asarray(field), mesh=mesh)
    spec = JSpec.from_example(np.float32(0.5))
    jc = JCompiled(pj, spec, spec.flatten(np.float32(0.5)))
    keys = mesh.shard_sims(jax.random.split(jax.random.PRNGKey(3), B))
    W = jc.sample_whites(keys)
    Z_prev = (0.1 * rng.standard_normal((B, jc.nz))).astype(np.float32)
    lanes = np.arange(B)
    th = np.array([0.25], np.float32)
    out = jc.muse_step_white(jnp.asarray(th), jnp.asarray(th), W,
                             mesh.shard_sims(jnp.asarray(Z_prev), field=True),
                             mesh.shard_sims(jnp.asarray(lanes)),
                             jnp.float32(1e-2))
    np.savez(path, field=field, sigma=sigma, w1=np.asarray(W[0]),
             w2=np.asarray(W[1]), Z_prev=Z_prev, lanes=lanes, theta=th)
    return {k: np.asarray(out[k]) for k in ("g", "Z", "converged",
                                            "failed")}, np.asarray(pj.x)


def _pixel_step_inputs(path):
    """JAX's pixel ``grf_problem`` muse_step_white on an 8-device sims=4 ×
    field=2 mesh (its transform there is the einsum DFT), from its own
    whites; the inputs are saved for the port's ranks."""
    import jax
    import jax.numpy as jnp

    import muse_tpu.models.grf as jgrf
    from muse_tpu.parallel import make_sims_mesh as jmesh
    from muse_tpu.solver.compiled import CompiledProblem as JCompiled
    from muse_tpu.theta import ThetaSpec as JSpec

    n, B, sigma = jobs.N, 8, 0.1
    rng = np.random.default_rng(7)
    cfg = jgrf.GrfConfig(n, sigma_noise=sigma)
    z = np.asarray(cfg.apply_sqrtC(jnp.asarray(
        rng.standard_normal((n, n)), jnp.float32), 0.0))
    field = (z + sigma * rng.standard_normal((n, n))).astype(np.float32)
    mesh = jmesh(sims=4, field=2)
    pj = jgrf.grf_problem(n=n, sigma_noise=sigma, x_obs=jnp.asarray(field),
                          mesh=mesh)
    spec = JSpec.from_example(np.float32(0.5))
    jc = JCompiled(pj, spec, spec.flatten(np.float32(0.5)))
    keys = mesh.shard_sims(jax.random.split(jax.random.PRNGKey(5), B))
    W = jc.sample_whites(keys)
    Z_prev = (0.1 * rng.standard_normal((B, n * n))).astype(np.float32)
    lanes = np.arange(B)
    th = np.array([0.25], np.float32)
    out = jc.muse_step_white(jnp.asarray(th), jnp.asarray(th), W,
                             mesh.shard_sims(jnp.asarray(Z_prev)),
                             mesh.shard_sims(jnp.asarray(lanes)),
                             jnp.float32(1e-2))
    np.savez(path, field=field, sigma=sigma, u=np.asarray(W[0]),
             e=np.asarray(W[1]), Z_prev=Z_prev, lanes=lanes, theta=th)
    return ({k: np.asarray(out[k]) for k in ("g", "Z", "converged",
                                             "failed")},
            np.asarray(pj.x), pj.grf_config.fft_mode)


@pytest.fixture(scope="module")
def field(tmp_path_factory, oracle):
    """(every rank's results on sims=2 × field=2, the unsharded oracle,
    JAX's sharded spectral step and its packed data, JAX's sharded pixel
    step, its data and its transform mode)."""
    out = tmp_path_factory.mktemp("mesh_field")
    jax_step, jax_x = _step_inputs(out / "step_inputs.npz")
    pixel = _pixel_step_inputs(out / "pixel_step_inputs.npz")
    return (jobs.spawn("field", out, timeout=jobs.FIELD_TIMEOUT_S), oracle,
            jax_step, jax_x, pixel)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------------ #
# the mesh itself
# ------------------------------------------------------------------ #

def test_make_sims_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        make_sims_mesh(device_type="cpu")


def test_mesh_construction(sims):
    r0 = sims[0][0]
    assert int(r0["n_sims_shards"]) == 4 and bool(r0["field_axis_none"])
    assert bool(r0["field_axis_2d"]) and bool(r0["bad_shape_raises"])
    # the field rows of a 16-row grid: 8 each, in rank order
    rows = sorted(tuple(r["field_rows"]) for r in sims[0])
    assert rows == [(0, 8), (0, 8), (8, 16), (8, 16)]


@pytest.mark.parametrize("job", ["sims", "field"])
def test_every_rank_ends_with_the_same_bits(job, sims, field):
    ranks = (sims if job == "sims" else field)[0]
    for k, v in ranks[0].items():
        # a sims rank that holds no lanes of a chunk makes no gathers
        if k in ("field_rows", "collectives") or k.startswith("counts_"):
            continue
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[k], v, err_msg=k)


# ------------------------------------------------------------------ #
# the sims axis (tests/test_mesh.py's cases)
# ------------------------------------------------------------------ #

def test_sharded_muse_matches_single_device(sims):
    r0, want = sims[0][0], sims[1]
    _close(r0["funnel_theta"], want["funnel_theta"], SIMS_RTOL)
    assert int(r0["funnel_steps"]) == int(want["funnel_steps"])
    _close(r0["funnel_g_sims"], want["funnel_g_sims"], SIMS_RTOL)


def test_sharded_get_J_matches(sims):
    _close(sims[0][0]["funnel_J"], sims[1]["funnel_J"], SIMS_RTOL)


@pytest.mark.parametrize("lanes", [11, 3])
def test_uneven_lane_count_shards(sims, lanes):
    """11 lanes on 4 ranks (3, 3, 3, 2) and 3 lanes (one rank holds none
    and still joins every collective)."""
    k = f"funnel_theta_{lanes}_lanes"
    assert np.isfinite(sims[0][0][k]).all()
    _close(sims[0][0][k], sims[1][k], SIMS_RTOL)


@pytest.mark.parametrize("mode", ["fd", "adaptive", "implicit"])
def test_sharded_get_H_matches(sims, mode):
    k = f"funnel_H_{mode}"
    _close(sims[0][0][k], sims[1][k], SIMS_RTOL)


def test_mesh_with_max_batch(sims):
    _close(sims[0][0]["funnel_theta_max_batch"],
           sims[1]["funnel_theta_max_batch"], SIMS_RTOL)


def test_sharded_grf_muse_matches(sims):
    r0, want = sims[0][0], sims[1]
    _close(r0["pixel_theta"], want["pixel_theta"], SIMS_RTOL)
    assert int(r0["pixel_steps"]) == int(want["pixel_steps"])


def test_sharded_grf_J_and_H_match(sims):
    """J at rtol 1e-6. The pixel model's lanes go through the CPU's batched
    FFT, whose last bit depends on the batch width; FD H divides a
    difference of two such scores by 2ε and so carries that bit amplified
    by |g|/(2ε·|H|) ≈ 10-40 here: held at 1e-5."""
    _close(sims[0][0]["pixel_J"], sims[1]["pixel_J"], SIMS_RTOL)
    _close(sims[0][0]["pixel_H"], sims[1]["pixel_H"], 10 * SIMS_RTOL)


def test_vector_theta_sharded_matches_single_device(sims):
    r0, want = sims[0][0], sims[1]
    _close(r0["vector_theta"], want["vector_theta"], SIMS_RTOL)
    _close(r0["vector_J"], want["vector_J"], SIMS_RTOL)
    assert r0["vector_J"].shape == (2, 2)


def test_sharded_lensing_matches(sims):
    r0, want = sims[0][0], sims[1]
    assert r0["lensing_converged"].all()
    _close(r0["lensing_theta"], want["lensing_theta"], SIMS_RTOL)


@pytest.mark.parametrize("key", ["spectral_theta", "spectral_J",
                                 "spectral_H", "spectral_H_fd"])
def test_spectral_grf_sims_axis_matches(sims, key):
    _close(sims[0][0][key], sims[1][key], SIMS_RTOL)


@pytest.mark.parametrize("key", ["band_theta", "band_J", "band_H",
                                 "band_H_implicit"])
def test_bandpower_sims_axis_matches(sims, key):
    _close(sims[0][0][key], sims[1][key], SIMS_RTOL)


# ------------------------------------------------------------------ #
# the field axis
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("model", ["spectral", "band", "funnel", "pixel",
                                   "vector", "ppl", "funnel_theta_11_lanes",
                                   "funnel_theta_3_lanes",
                                   "funnel_theta_max_batch"])
def test_field_axis_theta_matches(field, model):
    k = model if model.startswith("funnel_theta") else f"{model}_theta"
    _close(field[0][0][k], field[1][k], 1e-4, 1e-4)


@pytest.mark.parametrize("key", ["spectral_J", "spectral_H", "band_J",
                                 "band_H_implicit", "funnel_J",
                                 "funnel_H_implicit", "pixel_J", "vector_J",
                                 "ppl_J"])
def test_field_axis_J_and_H_match(field, key):
    _close(field[0][0][key], field[1][key], 1e-3)


@pytest.mark.parametrize("key", ["spectral_H_fd", "band_H", "funnel_H_fd",
                                 "funnel_H_adaptive", "pixel_H", "ppl_H"])
def test_field_axis_fd_H_matches(field, key):
    """FD H at a small step is a difference of O(n²) float32 sums: held at
    1e-3 of its largest entry, as tests/test_mesh.py holds bandpower's."""
    want = np.asarray(field[1][key])
    _close(field[0][0][key], want, 0.0, 1e-3 * np.abs(want).max())


@pytest.mark.parametrize("job", ["sims", "field"])
def test_save_maps_and_z0_under_a_mesh(job, sims, field):
    """The maps are gathered whole to every rank, and a whole-length z0 is
    cut to each rank's share."""
    r0, want = (sims if job == "sims" else field)[:2]
    r0 = r0[0]
    assert r0["maps_sims"].shape == want["maps_sims"].shape == (5, 288)
    rtol = SIMS_RTOL if job == "sims" else 1e-4
    _close(r0["maps_theta"], want["maps_theta"], rtol, 0 if job == "sims"
           else 1e-4)
    for k in ("maps_dat", "maps_sims"):
        Zw = want[k]
        _close(r0[k], Zw, 0.0, (1e-6 if job == "sims" else 1e-5)
               * np.abs(Zw).max())


def test_field_axis_lensing_runs_close(field):
    """Lensing on the gathered route (VarPro with its field hooks): every
    MAP converged, θ̂ within JAX's 0.1 of the unsharded run."""
    r0, want = field[0][0], field[1]
    assert r0["lensing_converged"].all()
    gap = abs(float(r0["lensing_theta"][0]) - float(want["lensing_theta"][0]))
    print(f"lensing field axis |θ̂ − θ̂ unsharded| = {gap:.6f}")
    assert gap < 0.1


@pytest.mark.parametrize("run, route", [
    ("spectral_runs", "sum"), ("bandpower_runs", "sum"),
    ("grf_pixel_runs", "pixel"), ("vector_theta_runs", "pixel"),
    ("funnel_runs", "gathered"), ("ppl_runs", "gathered"),
    ("lensing_runs", "gathered")])
def test_field_axis_takes_each_problems_route(field, run, route):
    """The packed spectral models sum partial sums and gather nothing; the
    pixel grf_problem gathers at its solves' entry and exit and takes no
    field maximum; every other problem takes the gathered route, whose
    MAP solvers take sup-norms as field maxima."""
    gathers, maxima, total = field[0][0][f"counts_{run}"]
    assert total > 0
    assert (gathers > 0) == (route != "sum")
    assert (maxima > 0) == (route == "gathered")


def test_field_axis_refused_where_it_cannot_shard(field):
    """What stays refused on a field axis: the einsum DFT, which the port
    leaves out; a problem built with one mesh and solved with another;
    and the pixel grf_problem built for the axis with the generic L-BFGS,
    whose log-likelihood needs the whole latent (built without mesh= it
    takes the gathered route)."""
    r0 = field[0][0]
    assert "Left out on purpose" in str(r0["matmul_error"])
    assert "another mesh" in str(r0["other_mesh_error"])
    assert "gathered route" in str(r0["pixel_lbfgs_error"])


def test_pixel_field_step_matches_jax(field):
    """The port's field-axis pixel grf_problem muse_step_white (sims=2 ×
    field=2: gathered FFTs at the solve's entry and exit, the PCG on each
    rank's rows) against JAX's on an 8-device sims=4 × field=2 mesh, whose
    transform is the einsum DFT, on JAX's whites."""
    r0 = field[0][0]
    want, jax_x, fft_mode = field[4]
    assert fft_mode == "matmul"
    np.testing.assert_allclose(r0["pixel_step_x"], jax_x, rtol=1e-4,
                               atol=1e-4)
    _close(r0["pixel_step_g"], want["g"], 1e-4, 1e-4)
    _close(r0["pixel_step_Z"], want["Z"], 1e-4, 1e-4)
    np.testing.assert_array_equal(r0["pixel_step_flags"][:, 0] > 0,
                                  want["converged"])
    np.testing.assert_array_equal(r0["pixel_step_flags"][:, 1] > 0,
                                  want["failed"])


def test_field_step_matches_jax(field):
    """The port's sharded muse_step_white (sims=2 × field=2, gathered)
    against JAX's on an 8-device sims=4 × field=2 mesh, on JAX's whites."""
    ranks, _, want, jax_x, _ = field
    r0 = ranks[0]
    np.testing.assert_allclose(r0["step_x"], jax_x, rtol=1e-6, atol=1e-6)
    _close(r0["step_g"], want["g"], 1e-4)
    Zj = want["Z"]
    _close(r0["step_Z"], Zj, 0.0, 1e-5 * np.abs(Zj).max())
    np.testing.assert_array_equal(r0["step_flags"][:, 0] > 0,
                                  want["converged"])
    np.testing.assert_array_equal(r0["step_flags"][:, 1] > 0, want["failed"])


# ------------------------------------------------------------------ #
# the launcher, profile_dir, the CG's reduce hook
# ------------------------------------------------------------------ #

def test_a_hung_collective_fails_within_the_deadline(tmp_path):
    with pytest.raises(TimeoutError, match="hung collective"):
        jobs.spawn("hang", tmp_path, world=2, timeout=8.0)


def test_profile_dir_writes_one_trace_per_rank(sims):
    names = sorted(p.name.split(".")[0]
                   for p in (sims[2] / "prof").glob("*.pt.trace.json"))
    assert names == [f"rank{r}" for r in range(jobs.WORLD)]


def test_a_mesh_on_another_device_is_refused():
    """A problem on the CPU with a mesh whose rank computes on a card (or
    the other way round) is refused before any collective runs."""
    from muse_tpu_torch.models import funnel_problem
    from muse_tpu_torch.parallel import SimsMesh
    mesh = SimsMesh.__new__(SimsMesh)       # as far as the check reads it
    mesh.device, mesh.field_axis = torch.device("cuda", 0), None
    p = funnel_problem(16, data_seed=42, device="cpu")
    with pytest.raises(ValueError, match="mesh device"):
        mt.muse(p, 1.0, nsims=4, maxsteps=2, mesh=mesh)


def test_profile_dir_writes_a_trace(tmp_path):
    from muse_tpu_torch.models import funnel_problem
    p = funnel_problem(64, data_seed=42, device="cpu")
    mt.muse(p, 1.0, nsims=8, maxsteps=3, seed=1, profile_dir=str(tmp_path))
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    text = traces[0].read_text()
    assert "muse.fit.step" in text and "muse.fit.update" in text
    from muse_tpu_torch.utils import trace
    assert not trace.enabled()          # on for the call only


def _old_batched_cg(matvec, b=None, x0=None, *, tol=1e-6, maxiter=500,
                    precond=None, r0=None, z0=None, b_norm=None,
                    matvec_and_curvature=None):
    """``batched_cg`` as it was before the reduce hook, line for line."""
    if r0 is None:
        r0 = b - matvec(torch.zeros_like(b) if x0 is None else x0)
    if b_norm is None:
        b_norm = torch.linalg.vector_norm(b, dim=-1)
    B = r0.shape[0]
    x = torch.zeros_like(r0) if x0 is None else x0
    tol = torch.broadcast_to(torch.as_tensor(tol, dtype=r0.dtype,
                                             device=r0.device), (B,))
    Minv = (lambda v: v) if precond is None else precond
    z = Minv(r0) if z0 is None else z0
    thresh = tol * torch.clamp(b_norm, min=1e-30)

    def norm(v):
        return torch.linalg.vector_norm(v, dim=-1)

    r, p = r0, z
    rz = torch.sum(r0 * z, -1)
    done = norm(r0) < thresh
    iters = torch.zeros((B,), dtype=torch.int32, device=r0.device)
    next_check = 0
    for k in range(maxiter):
        if k == next_check:
            if bool(done.all()):
                break
            next_check = max(1, k + min(k, 8))
        if matvec_and_curvature is not None:
            Ap, pAp = matvec_and_curvature(p)
        else:
            Ap = matvec(p)
            pAp = torch.sum(p * Ap, -1)
        alpha = rz / torch.where(pAp > 0, pAp, torch.ones_like(pAp))
        alpha = torch.where(done | (pAp <= 0), torch.zeros_like(alpha), alpha)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = Minv(r)
        rz1 = torch.sum(r * z, -1)
        beta = torch.where(done, torch.zeros_like(rz1),
                           rz1 / torch.where(rz == 0, torch.ones_like(rz), rz))
        p = torch.where(done[:, None], p, z + beta[:, None] * p)
        iters = iters + (~done).to(torch.int32)
        done = done | (norm(r) < thresh) | ~torch.isfinite(rz1)
        rz = rz1
    return x, norm(r), done, iters


def _spd_batch(B=6, N=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    Q = torch.randn((B, N, N), generator=g)
    A = Q @ Q.transpose(1, 2) / N + torch.eye(N)
    b = torch.randn((B, N), generator=g)

    def matvec(V):
        return torch.einsum("bij,bj->bi", A, V)
    return A, b, matvec


@pytest.mark.parametrize("route", ["matvec", "precond", "curvature"])
def test_batched_cg_without_reduce_is_the_old_loop(route):
    """reduce=None leaves the loop bitwise what it was."""
    A, b, matvec = _spd_batch()
    d = torch.diagonal(A, dim1=1, dim2=2)
    kw = {"tol": torch.linspace(1e-6, 1e-3, b.shape[0]), "maxiter": 60}
    if route == "precond":
        kw["precond"] = lambda R: R / d
    if route == "curvature":
        r0 = b.clone()
        kw.update(r0=r0, z0=r0 / d, b_norm=torch.linalg.vector_norm(b, dim=-1),
                  precond=lambda R: R / d,
                  matvec_and_curvature=lambda P: (matvec(P),
                                                  torch.sum(P * matvec(P), -1)))
        new = batched_cg(None, None, **kw)
        old = _old_batched_cg(None, None, **kw)
    else:
        new = batched_cg(matvec, b, **kw)
        old = _old_batched_cg(matvec, b, **kw)
    for a, o in zip(new, old):
        assert torch.equal(a, o)


class _FieldPair:
    """Two shards of a field axis as two threads: each thread's ``reduce``
    posts its partial sums and returns the sum of both, as an all_reduce
    over a field group of 2 would."""

    def __init__(self):
        self.barrier = threading.Barrier(2)
        self.slots = [None, None]
        self.calls = [[], []]

    def reduce(self, i):
        def f(s):
            self.calls[i].append(tuple(s.shape))
            self.slots[i] = s
            self.barrier.wait(timeout=30)
            total = self.slots[0] + self.slots[1]
            self.barrier.wait(timeout=30)
            return total
        return f


def test_batched_cg_reduce_hook_sums_the_shards():
    """Each lane's vector in two halves, one batched_cg per half whose
    reduce hook sums both halves' partial sums: both halves stop at the
    same step, and together they are the unsharded solution."""
    B, N = 4, 30
    g = torch.Generator().manual_seed(1)
    d = torch.rand((B, N), generator=g, dtype=torch.float64) + 0.5
    b = torch.randn((B, N), generator=g, dtype=torch.float64)
    whole = batched_cg(lambda V: d * V, b, tol=1e-10, maxiter=100,
                       precond=lambda R: R / d)
    halves = (slice(0, N // 2), slice(N // 2, N))
    pair, out = _FieldPair(), [None, None]

    def run(i):
        sl = halves[i]
        out[i] = batched_cg(lambda V: d[:, sl] * V, b[:, sl], tol=1e-10,
                            maxiter=100, precond=lambda R: R / d[:, sl],
                            reduce=pair.reduce(i))

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    # ‖b‖², then (rz, ‖r‖²) stacked, then per step pAp and (rz, ‖r‖²)
    assert pair.calls[0] == pair.calls[1]
    assert pair.calls[0][:3] == [(B,), (2, B), (B,)]
    assert torch.equal(out[0].iterations, out[1].iterations)
    assert torch.equal(out[0].converged, out[1].converged)
    assert torch.equal(out[0].r_norm, out[1].r_norm)
    torch.testing.assert_close(torch.cat([out[0].x, out[1].x], 1), whole.x,
                               rtol=1e-10, atol=1e-12)
