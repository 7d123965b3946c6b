"""The packed GRF's diagonal PCG (``ops/diag_pcg.py``, ``csrc/diag_pcg.cu``).

On the CPU the passes take their plain versions, which are ``batched_cg``'s
expressions in its order: the loop is held bit for bit against the route it
replaced, ``batched_cg`` with the fused operator's ``matvec_and_curvature``
and a precomputed start (rebuilt here as :func:`_curvature_route_pcg`), for
every packed model's ``custom_zhat`` (the spectral GRF in its three noise
modes, the bandpower model, the pixel GRF), and for a field group of two
halves in two threads whose ``reduce`` sums both halves.

Tests marked ``cuda`` need a card and ``nvcc`` and skip elsewhere; this
file imports no JAX, so they run with

    python -m pytest --noconftest -m cuda tests/test_torch_diag_pcg.py

On a card each pass's vectors are bitwise its plain version's run on the
CPU in float32 (the same IEEE operations, none contracted), and its
per-lane sums within 1e-5 relative of the plain version in float64 (the
kernels sum in a fixed tree, torch in its own order); reruns are bitwise,
and a lane's whole solve is bitwise the same in a batch of 26 and of 51.
"""

import threading

import numpy as np
import pytest
import torch

from muse_tpu_torch.models import grf as tg
from muse_tpu_torch.models import (bandpower_problem, grf_problem,
                                   grf_spectral_problem)
from muse_tpu_torch.ops import diag_pcg as dp
from muse_tpu_torch.ops.cg import batched_cg
from muse_tpu_torch.ops.grf_spectrum import spectrum_quadform_and_grad
from muse_tpu_torch.utils import trace
from muse_tpu_torch.utils.keys import lane_generator

torch.set_num_threads(1)

COUNTS = ("batched_cg.steps", "batched_cg.curvature_steps",
          "batched_cg.host_syncs")


def _curvature_route_pcg(A, b, Z0, atol, cg_maxiter, grid, nz=None,
                         reduce=None, scale=None, divisor=1.0):
    """``models/grf.py``'s ``_packed_diag_pcg`` before the diagonal loop:
    ``batched_cg`` with the fused operator and a precomputed start (the
    right-hand side formed first where ``scale`` is given)."""
    if scale is not None:
        b = scale * b / divisor
    A_grid = A.reshape(grid)
    r0 = b - A * Z0
    if reduce is None:
        b_norm = torch.linalg.vector_norm(b, dim=-1)
    else:
        b_norm = torch.sqrt(reduce(torch.sum(b * b, -1)))
    rel_tol = atol * float(np.sqrt(np.float32(nz or Z0.shape[1]))) / \
        torch.clamp(b_norm, min=1e-30)

    def matvec_and_curvature(P):
        quad, half = spectrum_quadform_and_grad(
            P.reshape((P.shape[0],) + grid), A_grid)
        return half.reshape(P.shape), quad

    res = batched_cg(None, None, Z0, tol=rel_tol, maxiter=cg_maxiter,
                     precond=lambda R: R / A, r0=r0, z0=r0 / A,
                     b_norm=b_norm,
                     matvec_and_curvature=matvec_and_curvature,
                     reduce=reduce)
    return res.x, {"converged": res.converged,
                   "failed": ~torch.isfinite(res.r_norm),
                   "iterations": res.iterations, "g_norm": res.r_norm}


def _counted(fn, *args):
    c0 = trace.counters()
    out = fn(*args)
    c1 = trace.counters()
    return out, {k: c1[k] - c0[k] for k in COUNTS}


def _same(new, old):
    (Zn, an), (Zo, ao) = new, old
    assert torch.equal(Zn, Zo)
    assert an.keys() == ao.keys()
    for k in an:
        assert torch.equal(an[k], ao[k]), k


def _model(name):
    kw = dict(sigma_noise=0.01, device="cpu", cg_maxiter=9)
    if name.startswith("spectral"):
        return (grf_spectral_problem(n=16, noise=name.split("_")[1], **kw),
                torch.tensor([0.3]))
    if name == "bandpower":
        return bandpower_problem(n=16, nbands=3, **kw), torch.zeros(3)
    return grf_problem(n=17, **kw), torch.tensor([0.3])


@pytest.mark.parametrize("name", ["spectral_marginal", "spectral_direct",
                                  "spectral_fft", "bandpower", "pixel"])
@pytest.mark.parametrize("atol,start", [(1e-2, "solution"), (1e-2, "half"),
                                        (1e-5, "half"), (1e-12, "half")])
def test_models_solve_bitwise_as_the_curvature_route(monkeypatch, name, atol,
                                                     start):
    """Each packed model's ``custom_zhat`` through the diagonal loop and
    through the route it replaced: the same Z, flags, iterations, residual
    norms and counter deltas, bit for bit. The starts: the exact MAP (no
    step), and half the white latent (one to three steps, lanes apart)."""
    prob, th = _model(name)
    draws = [prob.sample_x_z(lane_generator(s, "cpu"),
                             th if name == "bandpower" else th[0])
             for s in range(5)]
    xs = torch.stack([x for x, _ in draws])
    Z0 = 0.5 * torch.stack([u for _, u in draws]).reshape(5, -1)
    if start == "solution":
        Z0 = prob.custom_zhat(xs, Z0, th, 1e-12)[0]
    new = _counted(prob.custom_zhat, xs, Z0, th, atol)
    monkeypatch.setattr(tg, "_packed_diag_pcg", _curvature_route_pcg)
    old = _counted(prob.custom_zhat, xs, Z0, th, atol)
    _same(new[0], old[0])
    assert new[1] == old[1]
    # the steps between two reads of all(done) run on, frozen lanes and all
    steps = new[1]["batched_cg.curvature_steps"]
    assert steps >= int(new[0][1]["iterations"].max())
    assert (steps == 0) == (start == "solution")


def _system(B, L, seed):
    g = torch.Generator().manual_seed(seed)
    A = 1.0 + 1e4 * torch.rand((1, L), generator=g)
    scale = torch.rand((1, L), generator=g) * 100.0
    b = torch.randn((B, L), generator=g)
    Z0 = torch.randn((B, L), generator=g)
    return A, scale, b, Z0


@pytest.mark.parametrize("maxiter", [1, 50])
@pytest.mark.parametrize("scaled", [False, True])
def test_direct_calls_bitwise_as_the_curvature_route(maxiter, scaled):
    """``_packed_diag_pcg`` itself, with and without the right-hand side's
    scale, to convergence and cut at one step (lanes left unconverged)."""
    n = 9
    grid = (n, 2 * (n // 2 + 1))
    A, scale, b, Z0 = _system(6, grid[0] * grid[1], 7)
    kw = dict(scale=scale, divisor=1e-4) if scaled else {}
    args = (A, b, Z0, 1e-9, maxiter, grid)
    new = _counted(lambda: tg._packed_diag_pcg(*args, nz=n * n, **kw))
    old = _counted(lambda: _curvature_route_pcg(*args, nz=n * n, **kw))
    _same(new[0], old[0])
    assert new[1] == old[1] and new[1]["batched_cg.steps"] >= 1
    if maxiter == 1:
        assert not new[0][1]["converged"].all()


class _FieldPair:
    """A field group of 2 as two threads: ``reduce`` posts this half's
    per-lane sums and returns the sum over both halves."""

    def __init__(self):
        self.barrier = threading.Barrier(2)
        self.slots = [None, None]

    def reduce(self, i):
        def hook(t):
            self.slots[i] = t
            self.barrier.wait(timeout=60)
            out = self.slots[0] + self.slots[1]
            self.barrier.wait(timeout=60)
            return out
        return hook


def _halves(solve, rows):
    """``solve(i, rows_i, reduce)`` on both halves of the grid's rows in two
    threads; returns both results."""
    pair, out = _FieldPair(), [None, None]
    halves = (slice(0, rows // 2), slice(rows // 2, rows))

    def go(i):
        out[i] = solve(i, halves[i], pair.reduce(i))

    threads = [threading.Thread(target=go, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("scaled", [False, True])
def test_field_pair_bitwise_as_the_curvature_route(scaled):
    """A field group of two halves of the grid's rows, ``reduce`` summing
    both: each half's solution and flags bitwise the route it replaced, and
    both halves agree on every lane's flags, iterations and norms."""
    n = 12
    m2 = 2 * (n // 2 + 1)
    A, scale, b, Z0 = _system(5, n * m2, 11)

    def runner(pcg):
        def solve(i, rows, reduce):
            cols = slice(rows.start * m2, rows.stop * m2)
            kw = dict(scale=scale[:, cols], divisor=1e-4) if scaled else {}
            return pcg(A[:, cols], b[:, cols], Z0[:, cols], 1e-7, 50,
                       (rows.stop - rows.start, m2), nz=n * m2,
                       reduce=reduce, **kw)
        return solve

    new = _halves(runner(tg._packed_diag_pcg), n)
    old = _halves(runner(_curvature_route_pcg), n)
    for i in (0, 1):
        _same(new[i], old[i])
    for k in ("converged", "iterations", "g_norm"):
        assert torch.equal(new[0][1][k], new[1][1][k])
    assert int(new[0][1]["iterations"].max()) >= 1


# ------------------------------------------------------------------ #
# the kernels, on a card
# ------------------------------------------------------------------ #

SHAPES = [(B, n) for B in (1, 65, 128) for n in (64, 257, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda")


def _lanes(B, seed, dev):
    """A state between two steps: positive rz, a done lane and one whose
    lane was done before the last step, thresholds around the norms."""
    g = torch.Generator().manual_seed(seed)
    rz = torch.rand(B, generator=g) + 0.1
    done = torch.rand(B, generator=g) < 0.2
    done[0] = False
    if B > 2:
        done[1] = True
    keep = done & (torch.rand(B, generator=g) < 0.5)
    lanes = dp.PcgLanes(rz=rz, r_norm=torch.rand(B, generator=g),
                        thresh=torch.rand(B, generator=g) * 1e3,
                        beta=torch.rand(B, generator=g), done=done,
                        keep=keep,
                        iters=torch.randint(0, 5, (B,), generator=g,
                                            dtype=torch.int32))
    return dp.PcgLanes(*(t.to(dev) for t in lanes))


def _to(lanes, dev, dtype=None):
    return dp.PcgLanes(*(t.to(dev, dtype) if t.is_floating_point()
                         else t.to(dev) for t in lanes))


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())


def _check_lanes(got, want32, want64, sums=("rz", "r_norm", "beta",
                                            "thresh")):
    for k in dp.PcgLanes._fields:
        g, w = getattr(got, k).cpu(), getattr(want32, k)
        if k in sums:
            assert _rel(g, getattr(want64, k)) <= 1e-5, k
        else:
            assert torch.equal(g, w), k


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", SHAPES)
def test_start_kernel_against_plain(cuda, B, n):
    L = 2 * n * (n // 2 + 1)
    A, scale, b, Z0 = _system(B, L, n + B)
    c = 0.3 * float(torch.linalg.vector_norm(b[0] * scale[0] / 1e-4))
    for kw in ({}, {"scale": scale, "divisor": 1e-4}):
        args = [t.to(cuda) for t in (A, b, Z0)]
        kwc = {k: v.to(cuda) if torch.is_tensor(v) else v
               for k, v in kw.items()}
        r, p, lanes = dp.diag_pcg_start_cuda(*args, c, **kwc)
        r32, p32, l32 = dp.diag_pcg_start_plain(A, b, Z0, c, **kw)
        kw64 = {k: v.double() if torch.is_tensor(v) else v
                for k, v in kw.items()}
        _, _, l64 = dp.diag_pcg_start_plain(A.double(), b.double(),
                                            Z0.double(), c, **kw64)
        assert torch.equal(r.cpu(), r32) and torch.equal(p.cpu(), p32)
        _check_lanes(lanes, l32, l64, sums=("rz", "r_norm", "thresh"))
        r2, p2, lanes2 = dp.diag_pcg_start_cuda(*args, c, **kwc)
        assert torch.equal(r, r2) and torch.equal(p, p2)
        for a, z in zip(lanes, lanes2):
            assert torch.equal(a, z)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", SHAPES)
def test_update_and_direction_kernels_against_plain(cuda, B, n):
    L = 2 * n * (n // 2 + 1)
    A, _, x, r = _system(B, L, 3 * n + B)
    p = torch.randn((B, L), generator=torch.Generator().manual_seed(B))
    pAp = torch.sum(p * A * p, -1)
    if B > 2:
        pAp[2] = -1.0                      # a non-positive curvature
    lanes = _lanes(B, n, "cpu")
    want = dp.diag_pcg_update_plain(x, r, p, A, pAp, lanes)
    want64 = dp.diag_pcg_update_plain(x.double(), r.double(), p.double(),
                                      A.double(), pAp.double(),
                                      _to(lanes, "cpu", torch.float64))
    dev = [t.to(cuda) for t in (x, r, p, A, pAp)]
    for in_place in (False, True):
        xc, rc = dev[0].clone(), dev[1].clone()
        got = dp.diag_pcg_update_cuda(xc, rc, dev[2], dev[3], dev[4],
                                      _to(lanes, cuda), in_place=in_place)
        assert (got[0] is xc) == in_place and got[1] is rc
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        _check_lanes(got[2], want[2], want64[2], sums=("rz", "r_norm",
                                                       "beta"))
        again = dp.diag_pcg_update_cuda(dev[0].clone(), dev[1].clone(),
                                        dev[2], dev[3], dev[4],
                                        _to(lanes, cuda))
        assert torch.equal(again[0], got[0]) and torch.equal(again[1],
                                                             got[1])
        for a, z in zip(again[2], got[2]):
            assert torch.equal(a, z)
    # the direction from the state the update left
    new_lanes = want[2]
    pd = dp.diag_pcg_direction_cuda(want[1].to(cuda), p.to(cuda).clone(),
                                    dev[3], _to(new_lanes, cuda))
    assert torch.equal(pd.cpu(), dp.diag_pcg_direction_plain(
        want[1], p, A, new_lanes))


def _solve(dev, B, n, lanes=None):
    """The diagonal solve of a random scaled system at n, stopping at 1e-5
    of the smallest ‖b‖; ``lanes`` cuts it to its first lanes. Returns
    (the result, (A, scale, x̃, Z₀, grid, c))."""
    grid = (n, 2 * (n // 2 + 1))
    A, scale, xt, Z0 = (t.to(dev) for t in _system(B, grid[0] * grid[1], 5))
    c = 1e-5 * float(torch.linalg.vector_norm(scale * xt / 1e-4,
                                              dim=-1).min())
    xt, Z0 = xt[:lanes].contiguous(), Z0[:lanes].contiguous()
    return (dp.batched_diag_pcg(A, xt, Z0, grid, c, 100, scale=scale,
                                divisor=1e-4),
            (A, scale, xt, Z0, grid, c))


@pytest.mark.cuda
def test_a_lane_solves_alike_in_26_and_51_lanes(cuda):
    """Reruns are bitwise, and the first 26 lanes of a 51-lane solve are
    bitwise those lanes solved alone."""
    big, _ = _solve(cuda, 51, 257)
    again, _ = _solve(cuda, 51, 257)
    assert all(torch.equal(a, b) for a, b in zip(big, again))
    part, _ = _solve(cuda, 51, 257, lanes=26)
    for a, b in zip(part, big):
        assert torch.equal(a, b[:26])
    assert int(big.iterations.max()) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(65, 256), (128, 1024)])
def test_solve_against_batched_cg_with_the_plain_operator(cuda, B, n):
    """The same iterations a lane as ``batched_cg`` with A·v in torch, and
    x within 1e-6 relative; the start launched once, the update and the
    direction once a step."""
    c0 = trace.counters()
    res, (A, scale, xt, Z0, grid, c) = _solve(cuda, B, n)
    c1 = trace.counters()
    b = scale * xt / 1e-4
    ref = batched_cg(lambda v: A * v, b, Z0,
                     tol=c / torch.linalg.vector_norm(b, dim=-1),
                     maxiter=100, precond=lambda R: R / A)
    assert torch.equal(res.iterations, ref.iterations)
    assert torch.equal(res.converged, ref.converged)
    assert _rel(res.x, ref.x) <= 1e-6 or float(
        (res.x - ref.x).abs().max() / ref.x.abs().max()) <= 1e-6
    d = {k: c1[k] - c0[k] for k in c1}
    steps = d["batched_cg.curvature_steps"]
    assert steps >= int(res.iterations.max()) >= 1
    assert d["diag_pcg_start_cuda.launches"] == 1
    assert d["diag_pcg_update_cuda.launches"] == steps
    assert d["diag_pcg_direction_cuda.launches"] == steps
    assert d["spectrum_quadform_and_grad_cuda.launches"] == steps


@pytest.mark.cuda
def test_a_fit_launches_the_passes_once_a_step(cuda, monkeypatch):
    """A ``grf_spectral_problem`` fit on the card: the update's and the
    direction's launches equal the PCG steps counted by
    ``batched_cg.curvature_steps``, and the start launches once a solve."""
    import warnings

    import muse_tpu_torch as mt

    prob = grf_spectral_problem(n=64, sigma_noise=0.01, device=cuda)
    solves = []
    solve = tg._packed_diag_pcg

    def counting(*a, **k):
        solves.append(1)
        return solve(*a, **k)
    monkeypatch.setattr(tg, "_packed_diag_pcg", counting)
    c0 = trace.counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mt.muse_fit(mt.MuseResult(), prob, 0.5, nsims=40, max_batch=16,
                    theta_rtol=1e-4, alpha=1.0, maxsteps=5, seed=3)
    c1 = trace.counters()
    d = {k: c1[k] - c0[k] for k in c1}
    steps = d["batched_cg.curvature_steps"]
    assert steps >= 1
    assert d["diag_pcg_update_cuda.launches"] == steps
    assert d["diag_pcg_direction_cuda.launches"] == steps
    assert d["diag_pcg_start_cuda.launches"] == len(solves) >= 3
