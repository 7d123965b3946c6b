"""The port's spectrum quadform against muse_tpu's Pallas kernel.

The same inputs, made with numpy from a seed, go through
``muse_tpu.ops.pallas_grf.spectrum_quadform`` (the Pallas kernel, in
interpret mode on the CPU) and through the port's plain version and its
``autograd.Function``. Tolerance rtol 1e-5, atol 1e-5: f32 sums of the
same positive terms taken in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from muse_tpu.ops import pallas_grf as jp
from muse_tpu_torch.ops import grf_spectrum as tp

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    B, n, m2 = 3, 16, 18
    z = rng.standard_normal((B, n, m2)).astype(np.float32)
    ic = (rng.uniform(size=(n, m2)) + 0.5).astype(np.float32)
    return z, ic


def test_plain_matches_pallas_forward(data):
    z, ic = data
    ref = np.asarray(jp.spectrum_quadform(jnp.asarray(z), jnp.asarray(ic)))
    got = tp.spectrum_quadform_plain(torch.from_numpy(z),
                                     torch.from_numpy(ic)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_function_forward_matches_pallas(data):
    z, ic = data
    ref = np.asarray(jp.spectrum_quadform(jnp.asarray(z), jnp.asarray(ic)))
    got = tp.spectrum_quadform(torch.from_numpy(z),
                               torch.from_numpy(ic)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_function_both_cotangents_match_pallas_vjp(data):
    """Mirror of tests/test_pallas_grf.py::test_custom_vjp_both_cotangents
    across the two packages."""
    z, ic = data
    w = np.arange(1.0, z.shape[0] + 1, dtype=np.float32)
    f = lambda zz, cc: jnp.sum(jp.spectrum_quadform(zz, cc) * w)
    gz_ref, gc_ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(z),
                                                 jnp.asarray(ic))
    zt = torch.from_numpy(z).requires_grad_(True)
    ct = torch.from_numpy(ic).requires_grad_(True)
    (tp.spectrum_quadform(zt, ct) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz_ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(gc_ref),
                               rtol=RTOL, atol=ATOL)


def test_vmap_grad_folds_lanes_into_one_evaluation(data):
    """Per-lane weight-gradients through vmap(grad) with B=1 per lane: one
    forward evaluation for all lanes, values equal to a per-lane loop and
    to JAX's vmap(grad) of the Pallas kernel."""
    z, ic = data
    zt, ct = torch.from_numpy(z), torch.from_numpy(ic)

    def f(zz, cc):
        return (tp.spectrum_quadform(zz[None], cc * cc)[0]).sum()

    before = tp.SpectrumQuadform.evaluations
    g = vmap(lambda zz: grad(f, argnums=1)(zz, ct))(zt)
    assert tp.SpectrumQuadform.evaluations - before == 1
    loop = torch.stack([grad(f, argnums=1)(zz, ct) for zz in zt])
    torch.testing.assert_close(g, loop, rtol=RTOL, atol=ATOL)

    fj = lambda zz, cc: jp.spectrum_quadform(zz[None], cc * cc)[0]
    gj = jax.vmap(lambda zz: jax.grad(fj, argnums=1)(zz, jnp.asarray(ic)))(
        jnp.asarray(z))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=ATOL)


def test_vmap_with_batched_weights(data):
    """The vmap rule also takes per-lane weights (one evaluation each)."""
    z, ic = data
    zt = torch.from_numpy(z)
    cs = torch.from_numpy(ic)[None] * torch.arange(1.0, 4.0)[:, None, None]
    got = vmap(lambda zz, cc: tp.spectrum_quadform(zz[None], cc)[0])(zt, cs)
    want = torch.stack([tp.spectrum_quadform_plain(zt[i:i + 1], cs[i])[0]
                        for i in range(3)])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_pack_helpers_match_jax():
    n = 16
    rng = np.random.default_rng(2)
    z = rng.standard_normal((2, n, n)).astype(np.float32)
    a = rng.uniform(size=(n, n // 2 + 1)).astype(np.float32)
    np.testing.assert_allclose(
        tp.pack_rfft2(torch.from_numpy(z)).numpy(),
        np.asarray(jp.pack_rfft2(jnp.asarray(z))), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tp.pack_weights(torch.from_numpy(a)).numpy(),
        np.asarray(jp.pack_weights(jnp.asarray(a))))


def test_pack_helpers_parseval():
    """Σ z² = (1/n²) Σ w |ẑ|² through the quadform."""
    from muse_tpu_torch.models import GrfConfig
    n = 16
    z = torch.from_numpy(
        np.random.default_rng(3).standard_normal((n, n)).astype(np.float32))
    cfg = GrfConfig(n=n, device="cpu")
    quad = tp.spectrum_quadform(tp.pack_rfft2(z)[None],
                                tp.pack_weights(cfg.herm_weight))[0] / n ** 2
    assert float(quad) == pytest.approx(float((z * z).sum()), rel=1e-4)


@pytest.mark.parametrize("n", [32, 33])
def test_quadform_and_grad_plain_matches_pallas(n):
    """The fused value + half-gradient against muse_tpu's Pallas kernel
    (test_pallas_grf.py:32-39 pattern) at B=3: quad at rtol 1e-5, the
    half-gradient (one multiply per element) at rtol 1e-6."""
    rng = np.random.default_rng(n)
    m2 = 2 * (n // 2 + 1)
    z = rng.standard_normal((3, n, m2)).astype(np.float32)
    ic = (rng.uniform(size=(n, m2)) + 0.5).astype(np.float32)
    qj, gj = jp.spectrum_quadform_and_grad(jnp.asarray(z), jnp.asarray(ic))
    qt, gt = tp.spectrum_quadform_and_grad(torch.from_numpy(z),
                                           torch.from_numpy(ic))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6)
    # the value is the quadform of the same inputs, and 2·half_grad its
    # z-gradient
    np.testing.assert_allclose(
        qt.numpy(), tp.spectrum_quadform_plain(torch.from_numpy(z),
                                               torch.from_numpy(ic)).numpy(),
        rtol=1e-5)
    zt = torch.from_numpy(z).requires_grad_(True)
    tp.spectrum_quadform_plain(zt, torch.from_numpy(ic)).sum().backward()
    torch.testing.assert_close(2 * gt, zt.grad, rtol=1e-6, atol=1e-6)
