"""The port's batched L-BFGS (``muse_tpu_torch/ops/lbfgs.py``) against
``muse_tpu.ops.lbfgs.batched_lbfgs`` on the same numpy inputs, and the
generic MAP path it carries (``grf_spectral_problem(solver="lbfgs")``).

Tolerances: the final z within the ``g_atol`` scale (1e-4 where g_atol
is 1e-5 on unit curvature), flags equal, iterations within ±2. Float32
Rosenbrock trajectories part in the last bits between XLA's fused
arithmetic and torch's, so Rosenbrock runs in float64 on both sides (JAX
under ``jax.enable_x64``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_tpu.ops.lbfgs import batched_lbfgs as j_lbfgs
import muse_tpu_torch
from muse_tpu_torch.models import grf_spectral_problem
from muse_tpu_torch.ops import lbfgs as tl
from muse_tpu_torch.ops.lbfgs import batched_lbfgs as t_lbfgs
from test_lbfgs import _ref_lbfgs_numpy

torch.set_num_threads(1)


def _both(fn_j, fn_t, z0, **kw):
    rj = j_lbfgs(fn_j, jnp.asarray(z0), **kw)
    rt = t_lbfgs(fn_t, torch.as_tensor(z0), **kw)
    return rj, rt


def _assert_like_jax(rj, rt, z_atol, iter_tol=2):
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_array_equal(rt.failed.numpy(), np.asarray(rj.failed))
    di = np.abs(rt.iterations.numpy().astype(int)
                - np.asarray(rj.iterations).astype(int))
    assert di.max() <= iter_tol, (rt.iterations, rj.iterations)
    ok = ~np.asarray(rj.failed)
    np.testing.assert_allclose(rt.z.numpy()[ok], np.asarray(rj.z)[ok],
                               atol=z_atol)


def _quadratic(c, diag):
    def fj(z):
        d = z - c
        return 0.5 * jnp.sum(diag * d * d, -1), diag * d

    ct, dt = torch.as_tensor(c), torch.as_tensor(diag)

    def ft(z):
        d = z - ct
        return 0.5 * torch.sum(dt * d * d, -1), dt * d
    return fj, ft


def test_batched_quadratic_matches_jax():
    B, N = 8, 64
    c = np.random.default_rng(0).standard_normal((B, N)).astype(np.float32)
    diag = np.linspace(0.5, 20.0, N, dtype=np.float32)
    rj, rt = _both(*_quadratic(c, diag), np.zeros((B, N), np.float32),
                   g_atol=1e-5)
    _assert_like_jax(rj, rt, z_atol=1e-5, iter_tol=0)
    assert bool(rt.converged.all()) and not bool(rt.failed.any())
    np.testing.assert_allclose(rt.z.numpy(), c, atol=1e-4)
    assert float(rt.g_norm.max()) < 1e-5


def test_rosenbrock_matches_jax_in_float64():
    def fj(z):
        x, y = z[:, 0], z[:, 1]
        return ((1 - x) ** 2 + 100 * (y - x ** 2) ** 2,
                jnp.stack([-2 * (1 - x) - 400 * x * (y - x ** 2),
                           200 * (y - x ** 2)], -1))

    def ft(z):
        x, y = z[:, 0], z[:, 1]
        return ((1 - x) ** 2 + 100 * (y - x ** 2) ** 2,
                torch.stack([-2 * (1 - x) - 400 * x * (y - x ** 2),
                             200 * (y - x ** 2)], -1))

    z0 = np.array([[-1.2, 1.0], [0.0, 0.0], [2.0, 2.0], [-2.0, -1.0]])
    with jax.enable_x64(True):
        rj, rt = _both(fj, ft, z0, g_atol=1e-6, max_iters=2000)
        _assert_like_jax(rj, rt, z_atol=1e-8)
    assert rt.z.dtype == torch.float64
    np.testing.assert_allclose(rt.z.numpy(), np.ones((4, 2)), atol=1e-4)


def test_per_lane_masks_match_jax():
    """Lanes of very different conditioning converge at their own pace;
    easy lanes are not perturbed by the stiff ones going on."""
    B, N = 4, 16
    scales = np.array([1.0, 10.0, 100.0, 1000.0], np.float32)[:, None]
    diag = (np.linspace(1.0, 5.0, N, dtype=np.float32)[None] * scales)
    rj, rt = _both(*_quadratic(np.ones((B, N), np.float32), diag),
                   np.zeros((B, N), np.float32), g_atol=1e-6,
                   max_iters=1000)
    _assert_like_jax(rj, rt, z_atol=1e-5)
    assert bool(rt.converged.all())
    assert int(rt.iterations[0]) <= int(rt.iterations[-1])


def test_nan_lane_frozen_and_per_lane_g_atol():
    """A NaN lane is frozen and failed while the others solve; g_atol may
    differ per lane."""
    B, N = 3, 8
    c = np.ones((B, N), np.float32)
    poison = np.array([0.0, np.nan, 0.0], np.float32)

    def fj(z):
        d = z - c
        return 0.5 * jnp.sum(d * d, -1) + poison, d

    def ft(z):
        d = z - torch.as_tensor(c)
        return 0.5 * torch.sum(d * d, -1) + torch.as_tensor(poison), d

    g_atol = np.array([1e-6, 1e-6, 1e-2], np.float32)
    rj = j_lbfgs(fj, jnp.zeros((B, N)), g_atol=jnp.asarray(g_atol))
    rt = t_lbfgs(ft, torch.zeros((B, N)), g_atol=torch.as_tensor(g_atol))
    _assert_like_jax(rj, rt, z_atol=1e-5)
    assert rt.failed.tolist() == [False, True, False]
    assert torch.equal(rt.z[1], torch.zeros(N))          # frozen at z0
    assert rt.converged[0] and rt.converged[2]
    assert float(rt.g_norm[0]) < 1e-6 and float(rt.g_norm[2]) < 1e-2


def test_ragged_store_matches_per_lane_reference():
    """The per-lane ring buffer: lanes that skip curvature-failing stores
    after their ring has wrapped keep exact per-lane recency order, so
    each lane matches the sequential numpy reference (same scenario as
    tests/test_lbfgs.py::test_ragged_store_matches_per_lane_reference)."""
    N, m, g_atol = 8, 2, 1e-5
    a_b = np.float32([5.0, 30.0, 30.0, 100.0])
    c_b = np.float32([0.1, 0.0, 0.5, -0.2])
    d_b = np.float32([0.3, -0.1, 0.2, 0.0])
    xoff = np.float32([0.5, 2.0, 0.5, 1.0])
    yoff = np.float32([0.0, 2.0, 2.2, 0.0])
    B = len(a_b)
    z0s = np.concatenate(
        [(c_b + xoff)[:, None] * np.ones((B, N - 1), np.float32),
         (d_b + yoff)[:, None]], axis=1).astype(np.float32)

    def fn_lane(b):
        def fn(z):
            x = (z[:-1] - c_b[b]).astype(np.float32)
            y = (z[-1:] - d_b[b]).astype(np.float32)
            f = np.float32(np.sum(0.5 * a_b[b] * x * x, dtype=np.float32)
                           + np.sum(-np.cos(y) + 5e-4 * y * y,
                                    dtype=np.float32) + 1.0)
            g = np.concatenate([a_b[b] * x,
                                np.sin(y) + 1e-3 * y]).astype(np.float32)
            return f, g
        return fn

    refs = [_ref_lbfgs_numpy(fn_lane(b), z0s[b], g_atol, m) for b in range(B)]
    assert any(r[4] for r in refs)          # a skip after wraparound occurs
    a_t, c_t, d_t = (torch.as_tensor(v)[:, None] for v in (a_b, c_b, d_b))

    def fn_batch(z):
        x = z[:, :-1] - c_t
        y = z[:, -1:] - d_t
        f = (torch.sum(0.5 * a_t * x * x, -1)
             + torch.sum(-torch.cos(y) + 5e-4 * y * y, -1) + 1.0)
        return f, torch.cat([a_t * x, torch.sin(y) + 1e-3 * y], 1)

    # the trajectories through the skips after wraparound (iterations
    # ~3-18) agree to float32 rounding; a batch-global write index would
    # scramble the recency order there and part them by O(1)
    for k in (8, 16):
        res = t_lbfgs(fn_batch, torch.as_tensor(z0s), g_atol=g_atol, m=m,
                      max_iters=k)
        for b in range(B):
            z_ref = _ref_lbfgs_numpy(fn_lane(b), z0s[b], g_atol, m,
                                     max_iters=k)[0]
            np.testing.assert_allclose(res.z[b].numpy(), z_ref, atol=1e-4,
                                       err_msg=f"lane {b}, {k} iterations")
    # to convergence: near the end the Armijo test turns on the last bits
    # of f, where the sums of the two sides round apart, so the iteration
    # counts may differ by a few
    res = t_lbfgs(fn_batch, torch.as_tensor(z0s), g_atol=g_atol, m=m)
    assert bool(res.converged.all())
    for b in range(B):
        z_ref, it_ref, *_ = refs[b]
        assert abs(int(res.iterations[b]) - it_ref) <= 4, (b, it_ref)
        np.testing.assert_allclose(res.z[b].numpy(), z_ref, atol=2e-3)


@pytest.mark.parametrize("check_every", [1, 3, 64])
def test_lagged_checks_are_bitwise_noops(monkeypatch, check_every):
    """Reading the done-mask and the line search's accepted flag less often
    runs extra iterations and trials on frozen lanes; the result is
    bitwise the same as reading after every one."""
    B, N = 5, 32
    rng = np.random.default_rng(3)
    c = rng.standard_normal((B, N)).astype(np.float32)
    diag = (np.linspace(1.0, 50.0, N, dtype=np.float32)[None]
            * np.float32([1, 3, 10, 30, 100])[:, None])
    _, ft = _quadratic(c, diag)

    def run(k):
        monkeypatch.setattr(tl, "_CHECK_EVERY", k)
        before = t_lbfgs.iterations
        r = t_lbfgs(ft, torch.zeros((B, N)), g_atol=1e-4)
        return r, t_lbfgs.iterations - before

    ref, n_ref = run(1)
    got, n_got = run(check_every)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert n_got >= n_ref                   # lagged reads run no-op steps


def test_stalled_lane_ends_the_loop_with_jax_counts():
    """A lane whose accepted step leaves z, f and g as they were is a fixed
    point; the JAX loop runs it to max_iters. The port ends the loop early
    and reports the same iterations, flags and z."""
    A, c2 = np.float32(1e6), np.float32(1e8 + 64)

    def fj(z):
        z1, z2 = z[:, 0], z[:, 1]
        return (0.5 * (A * z1 * z1 + (z2 - c2) ** 2),
                jnp.stack([A * z1, z2 - c2], -1))

    def ft(z):
        z1, z2 = z[:, 0], z[:, 1]
        return (0.5 * (A * z1 * z1 + (z2 - c2) ** 2),
                torch.stack([A * z1, z2 - c2], -1))

    z0 = np.array([[0.3, 1e8], [1.0, 1e8 + 8], [0.0, 1e8 + 64]], np.float32)
    before = t_lbfgs.iterations
    rj, rt = _both(fj, ft, z0, g_atol=1e-3, max_iters=60)
    assert t_lbfgs.iterations - before < 10            # ended early
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    assert rt.iterations.tolist()[:2] == [60, 60]
    _assert_like_jax(rj, rt, z_atol=0, iter_tol=0)


# ------------------------------------------------------------------ #
# the generic MAP path: grf_spectral_problem(solver="lbfgs")
# ------------------------------------------------------------------ #

def test_spectral_lbfgs_fit_matches_cg():
    """At n=16 the L-BFGS MAPs and the PCG MAPs give the same fit: the
    spectral GRF's θ-score is analytic in x̃, so θ̂ agrees to 1e-6, and
    every L-BFGS lane converges or stalls, none fails."""
    fits = {}
    for solver in ("lbfgs", "cg"):
        p = grf_spectral_problem(n=16, sigma_noise=0.1, solver=solver,
                                 device="cpu")
        r = muse_tpu_torch.muse_fit(muse_tpu_torch.MuseResult(), p, 0.5,
                                    nsims=16, theta_rtol=1e-4, seed=3)
        muse_tpu_torch.get_J(r, p, nsims=16, warn_reuse=False)
        muse_tpu_torch.get_H(r, p, nsims=2)
        fits[solver] = r
    lb, cg = fits["lbfgs"], fits["cg"]
    assert abs(float(lb.theta[0]) - float(cg.theta[0])) < 1e-6
    assert abs(float(lb.sigma[0]) / float(cg.sigma[0]) - 1) < 1e-3
    assert max(h["map_iterations"].max() for h in lb.history) > 1
    assert not any(h["map_failed"].any() for h in lb.history)
