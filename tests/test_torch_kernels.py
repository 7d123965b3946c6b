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


def _inputs(B, n, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    m2 = 2 * (n // 2 + 1)
    z = torch.randn((B, n, m2), generator=g, device=device)
    w = torch.rand((n, m2), generator=g, device=device) + 0.5
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 1024), (17, 1024), (101, 1024),
                                 (128, 1024), (3, 100), (3, 33)])
def test_kernel_matches_plain(cuda, B, n):
    z, w = _inputs(B, n, cuda)
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 1024), (17, 1024), (51, 1024),
                                 (128, 1024), (3, 100), (5, 33)])
def test_fused_kernel_matches_plain(cuda, B, n):
    """quad within 1e-5 relative of a float64 sum, half_grad bitwise
    ``z * w``, and a bitwise-equal rerun (no atomics)."""
    z, w = _inputs(B, n, cuda, seed=B + n)
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
