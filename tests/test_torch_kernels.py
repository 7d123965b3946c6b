"""The hand-written CUDA kernels against their plain PyTorch versions.

Tests marked ``cuda`` need a card and ``nvcc`` and skip elsewhere. This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

The unmarked tests check, on the CPU, the dispatch rules around the kernel.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from muse_tpu_torch.ops import grf_spectrum as tp
from muse_tpu_torch.ops.lbfgs import batched_lbfgs

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    return torch.device("cuda")


def _inputs(B, n, device, seed=0, rows=None):
    """(B, rows, 2m) spectra and (rows, 2m) weights: a field axis of a mesh
    gives each rank ``rows`` of the n rows of the packed grid (all of them
    by default)."""
    g = torch.Generator(device=device).manual_seed(seed)
    m2 = 2 * (n // 2 + 1)
    z = torch.randn((B, n, m2), generator=g, device=device)
    w = torch.rand((n, m2), generator=g, device=device) + 0.5
    if rows is not None:
        z, w = z[:, n - rows:].contiguous(), w[n - rows:].contiguous()
    return z, w


def test_cpu_tensors_take_the_plain_version():
    z, w = _inputs(2, 8, "cpu")
    before = tp.spectrum_quadform_cuda.launches
    np.testing.assert_array_equal(
        tp.spectrum_quadform(z, w).numpy(),
        tp.spectrum_quadform_plain(z, w).numpy())
    assert tp.spectrum_quadform_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    z, w = _inputs(2, 8, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.spectrum_quadform_cuda(z, w)


def test_fused_cpu_tensors_take_the_plain_version():
    z, w = _inputs(2, 9, "cpu")
    before = tp.spectrum_quadform_and_grad_cuda.launches
    q, g = tp.spectrum_quadform_and_grad(z, w)
    qp, gp = tp.spectrum_quadform_and_grad_plain(z, w)
    assert torch.equal(q, qp) and torch.equal(g, gp)
    assert torch.equal(g, z * w)
    assert tp.spectrum_quadform_and_grad_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.spectrum_quadform_and_grad_cuda(z, w)


# the lane counts of every path at 1024², then the row slices of a field
# axis of 2 (the sharded north star's fit chunks of 128 and 1 lanes) and the
# half chunk of a sims axis of 2 (64 lanes)
@pytest.mark.cuda
@pytest.mark.parametrize("B,n,rows", [
    (1, 1024, None), (17, 1024, None), (20, 1024, None), (40, 1024, None),
    (101, 1024, None), (128, 1024, None), (3, 100, None), (3, 33, None),
    (64, 1024, None), (128, 1024, 512), (1, 1024, 512)])
def test_kernel_matches_plain(cuda, B, n, rows):
    z, w = _inputs(B, n, cuda, rows=rows)
    got = tp.spectrum_quadform_cuda(z, w)
    want = tp.spectrum_quadform_plain(z.double(), w.double())
    rel = ((got.double() - want).abs() / want.abs()).max().item()
    assert rel <= 1e-5, rel
    # no atomics: a second launch is bitwise equal
    assert torch.equal(got, tp.spectrum_quadform_cuda(z, w))


@pytest.mark.cuda
def test_lane_value_does_not_depend_on_batch(cuda):
    z, w = _inputs(17, 256, cuda)
    full = tp.spectrum_quadform_cuda(z, w)
    one = tp.spectrum_quadform_cuda(z[5:6].contiguous(), w)
    assert torch.equal(full[5:6], one)


@pytest.mark.cuda
def test_function_grads_match_plain(cuda):
    z, w = _inputs(5, 128, cuda)
    ct = torch.arange(1.0, 6.0, device=cuda)
    zk, wk = z.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (tp.spectrum_quadform(zk, wk) * ct).sum().backward()
    zp, wp = z.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (tp.spectrum_quadform_plain(zp, wp) * ct).sum().backward()
    torch.testing.assert_close(zk.grad, zp.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wk.grad, wp.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_vmap_grad_is_one_launch(cuda):
    z, w = _inputs(7, 64, cuda)

    def f(zz, cc):
        return tp.spectrum_quadform(zz[None], cc * cc)[0]

    before = tp.spectrum_quadform_cuda.launches
    g = vmap(lambda zz: grad(f, argnums=1)(zz, w))(z)
    assert tp.spectrum_quadform_cuda.launches - before == 1
    want = 2 * w[None] * z * z
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_wrapper_checks(cuda):
    z, w = _inputs(2, 16, cuda)
    with pytest.raises(TypeError):
        tp.spectrum_quadform_cuda(z.double(), w.double())
    with pytest.raises(ValueError):
        tp.spectrum_quadform_cuda(z, w[:, :-1].contiguous())
    with pytest.raises(ValueError):
        tp.spectrum_quadform_cuda(z.transpose(1, 2).contiguous()
                                  .transpose(1, 2), w)


def _weights(K, n, device, seed=1, rows=None):
    """K (rows, 2m) weights: the amplitude's positive weight and, for
    K > 1, weights of either sign (a tilt's −log(k+k₀)·w is negative)."""
    g = torch.Generator(device=device).manual_seed(seed)
    m2 = 2 * (n // 2 + 1)
    W = torch.rand((K, n, m2), generator=g, device=device) + 0.5
    W[1::2] *= -1.0
    return W if rows is None else W[:, n - rows:].contiguous()


def test_quadforms_cpu_tensors_take_the_plain_version():
    z, _ = _inputs(3, 8, "cpu")
    W = _weights(2, 8, "cpu")
    before = tp.spectrum_quadforms_cuda.launches
    assert torch.equal(tp.spectrum_quadforms(z, W),
                       tp.spectrum_quadforms_plain(z, W))
    assert tp.spectrum_quadforms_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tp.spectrum_quadforms_cuda(z, W)


# every (B, K) a θ-score launches at 1024²: the amplitude's lane counts at
# K = 1 (fit chunks of 128, 101 and 1, the stencils' 20 and 40, the A/B's
# 17, a sims axis's 64, the 64-sim fit's one chunk of 65), the tilt's at
# K = 2 (the calibration study's fit chunk of 101 and the tests' widths), a
# field axis's rows (512 of 1024) at 128, 101 and 20 lanes; then ragged
# shapes and K = 3, 4
@pytest.mark.cuda
@pytest.mark.parametrize("B,K,n,rows", [
    (1, 1, 1024, None), (17, 1, 1024, None), (20, 1, 1024, None),
    (40, 1, 1024, None), (64, 1, 1024, None), (101, 1, 1024, None),
    (128, 1, 1024, None), (65, 1, 1024, None), (101, 2, 1024, None),
    (5, 2, 1024, None),
    (1, 2, 1024, None), (128, 1, 1024, 512), (101, 1, 1024, 512),
    (20, 1, 1024, 512), (3, 1, 100, None), (5, 3, 33, None),
    (6, 4, 100, None), (7, 2, 33, 20)])
def test_quadforms_kernel_matches_plain(cuda, B, K, n, rows):
    """Within 1e-6 relative of float64, bitwise on a rerun, bitwise equal to
    K launches at K = 1, and a lane's value the same alone (B = 1) as in
    the batch."""
    z, _ = _inputs(B, n, cuda, seed=B + n, rows=rows)
    W = _weights(K, n, cuda, rows=rows)
    got = tp.spectrum_quadforms_cuda(z, W)
    assert got.shape == (B, K)
    want = tp.spectrum_quadforms_plain(z.double(), W.double())
    rel = ((got.double() - want).abs() / want.abs()).max().item()
    assert rel <= 1e-6, rel
    assert torch.equal(got, tp.spectrum_quadforms_cuda(z, W))
    for k in range(K):
        assert torch.equal(got[:, k], tp.spectrum_quadform_cuda(
            z, W[k].contiguous()))
    for b in sorted({0, B // 2, B - 1}):
        assert torch.equal(got[b:b + 1], tp.spectrum_quadforms_cuda(
            z[b:b + 1].contiguous(), W))


@pytest.mark.cuda
def test_quadforms_vmap_is_one_launch_and_checks(cuda):
    z, _ = _inputs(7, 64, cuda)
    W = _weights(2, 64, cuda)
    before = tp.spectrum_quadforms_cuda.launches
    got = vmap(lambda v: tp.spectrum_quadforms(v[None], W)[0])(z)
    assert tp.spectrum_quadforms_cuda.launches - before == 1
    assert torch.equal(got, tp.spectrum_quadforms_cuda(z, W))
    with pytest.raises(ValueError, match="weights"):
        tp.spectrum_quadforms_cuda(z, _weights(5, 64, cuda))
    with pytest.raises(ValueError):
        tp.spectrum_quadforms_cuda(z, W[0])


@pytest.mark.cuda
def _band_weight(n, nbands, device, sigma_noise=0.01):
    """The bandpower PCG's operator A = 1 + P0·exp(θ_band)/σ² on the (n, 2m)
    grid, θ spread over ±0.5."""
    from muse_tpu_torch.models.bandpower import _k_grid64, band_edges
    k = _k_grid64(n)
    band = np.searchsorted(band_edges(n, nbands), k, side="right")
    C = (k + 1.0) ** -2.0 * np.exp(np.linspace(-0.5, 0.5, nbands))[band]
    A = np.tile((1.0 + C / sigma_noise ** 2).astype(np.float32).reshape(-1), 2)
    return torch.tensor(A.reshape(n, 2 * (n // 2 + 1)), device=device)


# the lane counts of every path that launches the fused kernel at 1024²
# (fit chunks of 128, 101 and 1 lanes; get_H's MAP solves of 51, 10, 20, 40
# and 5 lanes), with a flat weight and with the bandpower operator; then
# under a mesh: a sims axis of 2 halves the north star's chunks (64, 26,
# 25 lanes), a field axis of 2 halves the rows (the north star's 128, 1
# and 51 lanes, the bandpower fit's 101 and its H's 5); last, the
# calibration studies' implicit H of 8 pixel-GRF sims and the 6-band
# bandpower fit (49 lanes) and H (6); the 64-sim fit's one chunk of 65
@pytest.mark.cuda
@pytest.mark.parametrize("B,n,bands,rows", [
    (1, 1024, 0, None), (5, 1024, 0, None), (10, 1024, 0, None),
    (17, 1024, 0, None), (20, 1024, 0, None), (40, 1024, 0, None),
    (51, 1024, 0, None), (101, 1024, 0, None), (128, 1024, 0, None),
    (101, 1024, 12, None), (5, 1024, 12, None), (3, 100, 0, None),
    (5, 33, 0, None), (64, 1024, 0, None), (26, 1024, 0, None),
    (25, 1024, 0, None), (128, 1024, 0, 512), (1, 1024, 0, 512),
    (51, 1024, 0, 512), (101, 1024, 12, 512), (5, 1024, 12, 512),
    (8, 1024, 0, None), (49, 1024, 6, None), (6, 1024, 6, None),
    (65, 1024, 0, None)])
def test_fused_kernel_matches_plain(cuda, B, n, bands, rows):
    """quad within 1e-5 relative of a float64 sum, half_grad bitwise
    ``z * w``, and a bitwise-equal rerun (no atomics)."""
    z, w = _inputs(B, n, cuda, seed=B + n, rows=rows)
    if bands:
        w = _band_weight(n, bands, cuda)
        if rows is not None:
            w = w[n - rows:].contiguous()
    q, g = tp.spectrum_quadform_and_grad_cuda(z, w)
    want = tp.spectrum_quadform_plain(z.double(), w.double())
    rel = ((q.double() - want).abs() / want.abs()).max().item()
    assert rel <= 1e-5, rel
    assert torch.equal(g, z * w)
    q2, g2 = tp.spectrum_quadform_and_grad_cuda(z, w)
    assert torch.equal(q, q2) and torch.equal(g, g2)


@pytest.mark.cuda
def test_fused_wrapper_checks_and_counts(cuda):
    z, w = _inputs(2, 16, cuda)
    before = tp.spectrum_quadform_and_grad_cuda.launches
    tp.spectrum_quadform_and_grad(z, w)
    assert tp.spectrum_quadform_and_grad_cuda.launches - before == 1
    with pytest.raises(TypeError):
        tp.spectrum_quadform_and_grad_cuda(z.double(), w.double())
    with pytest.raises(ValueError):
        tp.spectrum_quadform_and_grad_cuda(z, w[:, :-1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(7, 4096), (101, 33)])
def test_batched_lbfgs_on_the_card_matches_the_cpu(cuda, B, N):
    """The same stiff per-lane quadratics solved on the card and on the CPU:
    the same flags, z within the g_atol scale, iterations within ±2 (sums
    round in another order on the card)."""
    g = np.random.default_rng(B)
    c = g.standard_normal((B, N)).astype(np.float32)
    diag = np.float32(g.uniform(1.0, 100.0, (B, N)))
    out = {}
    for dev in ("cpu", cuda):
        ct, dt = torch.tensor(c, device=dev), torch.tensor(diag, device=dev)

        def fn(z):
            d = z - ct
            return 0.5 * torch.sum(dt * d * d, -1), dt * d

        out[str(dev)] = batched_lbfgs(fn, torch.zeros((B, N), device=dev),
                                      g_atol=1e-3)
    cpu, card = out["cpu"], out[str(cuda)]
    assert torch.equal(card.converged.cpu(), cpu.converged)
    assert torch.equal(card.failed.cpu(), cpu.failed)
    assert bool(cpu.converged.all())
    di = (card.iterations.cpu().long() - cpu.iterations.long()).abs()
    assert int(di.max()) <= 2
    # |z − c| < g_atol/diag ≤ 1e-3 on both sides
    torch.testing.assert_close(card.z.cpu(), cpu.z, rtol=0, atol=2e-3)


@pytest.mark.cuda
def test_band_reduction_route(cuda):
    """Why the bandpower score reduces by sorted slices: at the full size
    (101 lanes × 12 bands × 1024²) it is within 1e-5 of a float64 sum,
    bitwise equal on a rerun and faster than a masked sum per band and than
    ``index_add_`` (atomics). Run with ``-s`` to see the milliseconds."""
    from muse_tpu_torch.models.bandpower import (_k_grid64, band_edges,
                                                 bandpower_problem)
    n, nb, B = 1024, 12, 101
    pb = bandpower_problem(n=n, nbands=nb, sigma_noise=0.01, device=cuda)
    band = torch.tensor(np.tile(np.searchsorted(
        band_edges(n, nb), _k_grid64(n), side="right").reshape(-1), 2),
        device=cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn((B, band.numel()), generator=g, device=cuda) ** 2
    masks = [(band == b).to(q.dtype) for b in range(nb)]
    routes = {
        "sorted slices": lambda: vmap(pb.band_sum)(q),
        "masked sums": lambda: torch.stack([(q * m).sum(-1) for m in masks],
                                           -1),
        "index_add_": lambda: torch.zeros((B, nb), device=cuda).index_add_(
            1, band, q)}
    want = torch.stack([(q.double() * m.double()).sum(-1) for m in masks], -1)
    ms = {}
    for name, fn in routes.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            fn()
        stop.record()
        stop.synchronize()
        ms[name] = start.elapsed_time(stop) / 10
        rel = ((got.double() - want).abs() / want).max().item()
        print(f"band reduction by {name}: {ms[name]:.3f} ms, max relative "
              f"error vs float64 {rel:.3e}, rerun bitwise equal: "
              f"{torch.equal(got, again)}")
        if name == "sorted slices":
            assert rel <= 1e-5 and torch.equal(got, again)
    assert ms["sorted slices"] < min(ms["masked sums"], ms["index_add_"])


@pytest.mark.cuda
@pytest.mark.parametrize("use_pallas", [True, False])
def test_use_pallas_switch_counts_launches(cuda, use_pallas):
    """``grf_field_problem(use_pallas=False)`` computes its quadform with
    the plain version on the card and launches no kernel; True launches
    one per batched score. Both give the same scores."""
    from muse_tpu_torch.models import grf_field_problem
    p, plain = (grf_field_problem(n=64, sigma_noise=0.1, device=cuda,
                                  use_pallas=flag)
                for flag in (use_pallas, False))
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((6, 64, 64), generator=g, device=cuda)
    z = torch.randn((6, 64, 64), generator=g, device=cuda)
    th = torch.tensor(0.2, device=cuda)

    def scores(prob):
        return vmap(lambda a, b: grad(lambda t: prob.log_like(a, b, t))(th))(
            x, z)

    before = tp.spectrum_quadform_cuda.launches
    got = scores(p)
    assert tp.spectrum_quadform_cuda.launches - before == int(use_pallas)
    torch.testing.assert_close(got, scores(plain), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cg_lane_sums_across_batch_widths(cuda):
    """A lane's per-step sums in ``batched_cg`` (rz, pᵀAp and ‖r‖², as the
    ``reduce`` hook sees them) at 26 lanes and at 51 agree to 1e-6 of the
    lane's first value of each sum, the tolerance the port states in place
    of the batch-width certifier: torch's per-lane reductions on a card
    take their split from the shape, so they need not agree bit for bit."""
    from muse_tpu_torch.ops.cg import batched_cg
    g = torch.Generator(device=cuda).manual_seed(8)
    L = 2 * 512 * 257
    d = torch.rand((1, L), generator=g, device=cuda) * 1e3 + 1.0
    b = torch.randn((51, L), generator=g, device=cuda)

    def run(B):
        seen = []

        def record(t):
            seen.append(t.clone())
            return t
        batched_cg(lambda V: d * V, b[:B], tol=1e-7, maxiter=30,
                   reduce=record)
        return seen

    wide, narrow = run(51), run(26)
    assert min(len(wide), len(narrow)) > 3
    # records: ‖b‖², (rz, ‖r‖²) at the start, then per step pᵀAp, (rz, ‖r‖²)
    for i, (w, n) in enumerate(zip(wide, narrow)):
        scale = narrow[i if i < 3 else 1 if i % 2 else 2].abs()
        assert ((w[..., :26] - n).abs() <= 1e-6 * scale).all(), i
