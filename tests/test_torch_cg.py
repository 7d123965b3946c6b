"""The port's batched CG against muse_tpu's, on the same numpy inputs.

B=6 lanes of N=200 SPD systems: a diagonal operator (the packed GRF's
MAP) and a dense one (an implicit-H Hessian), mixed per-lane tolerances,
with and without a preconditioner and with a precomputed initial state.
x agrees at rtol 1e-4 (float32 CG: the two libraries sum the dot products
in different orders, and the error compounds over the iterations), and
the per-lane iteration counts and convergence flags are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_tpu.ops.cg import batched_cg as jcg
from muse_tpu_torch.ops import cg as cg_module
from muse_tpu_torch.ops.cg import batched_cg as tcg

torch.set_num_threads(1)

B, N = 6, 200
TOL = np.array([1e-2, 1e-3, 1e-4, 1e-5, 3e-3, 3e-5], np.float32)


@pytest.fixture(scope="module")
def systems():
    rng = np.random.default_rng(11)
    diag = rng.uniform(1.0, 50.0, (B, N)).astype(np.float32)
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    lam = np.geomspace(1.0, 80.0, N)
    dense = ((Q * lam) @ Q.T).astype(np.float32)
    b = rng.standard_normal((B, N)).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((B, N))).astype(np.float32)
    pdiag = (np.diag(dense)[None] * np.ones((B, 1))).astype(np.float32)
    return {"diag": diag, "dense": dense, "b": b, "x0": x0, "pdiag": pdiag}


def _ops(kind, s):
    """(jax matvec, torch matvec, jax precond, torch precond)."""
    if kind == "diag":
        dj, dt = jnp.asarray(s["diag"]), torch.from_numpy(s["diag"])
        pj = lambda v: v / jnp.sqrt(dj)
        pt = lambda v: v / torch.sqrt(dt)
        return (lambda v: dj * v), (lambda v: dt * v), pj, pt
    Aj, At = jnp.asarray(s["dense"]), torch.from_numpy(s["dense"])
    Pj, Pt = jnp.asarray(s["pdiag"]), torch.from_numpy(s["pdiag"])
    return ((lambda v: v @ Aj), (lambda v: v @ At),
            (lambda v: v / Pj), (lambda v: v / Pt))


def _check_same(rt, rj):
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(),
                                  np.asarray(rj.converged))
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4,
                               atol=1e-4 * float(np.abs(rj.x).max()))


@pytest.mark.parametrize("kind", ["diag", "dense"])
@pytest.mark.parametrize("use_precond", [False, True])
def test_matches_jax(systems, kind, use_precond):
    mj, mt, pj, pt = _ops(kind, systems)
    b, x0 = systems["b"], systems["x0"]
    rj = jcg(mj, jnp.asarray(b), jnp.asarray(x0), tol=jnp.asarray(TOL),
             maxiter=300, precond=pj if use_precond else None)
    rt = tcg(mt, torch.from_numpy(b), torch.from_numpy(x0),
             tol=torch.from_numpy(TOL), maxiter=300,
             precond=pt if use_precond else None)
    _check_same(rt, rj)
    assert rt.converged.all()
    # each stops on its own residual, below tol·‖b‖ (the final residuals
    # are rounding-dominated, so they are not compared with each other)
    thresh = TOL * np.linalg.norm(b, axis=-1)
    assert (rt.r_norm.numpy() < thresh).all()


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_precomputed_initial_state_matches_jax(systems, kind):
    """r0 / z0 / b_norm given and b omitted, as zhat_cg calls it."""
    mj, mt, pj, pt = _ops(kind, systems)
    b, x0 = systems["b"], systems["x0"]
    r0 = b - np.asarray(mj(jnp.asarray(x0)))
    z0 = np.asarray(pj(jnp.asarray(r0)))
    bn = np.linalg.norm(b, axis=-1).astype(np.float32)
    rj = jcg(mj, None, jnp.asarray(x0), tol=jnp.asarray(TOL), maxiter=300,
             precond=pj, r0=jnp.asarray(r0), z0=jnp.asarray(z0),
             b_norm=jnp.asarray(bn))
    rt = tcg(mt, None, torch.from_numpy(x0), tol=torch.from_numpy(TOL),
             maxiter=300, precond=pt, r0=torch.from_numpy(r0),
             z0=torch.from_numpy(z0), b_norm=torch.from_numpy(bn))
    _check_same(rt, rj)


def test_maxiter_leaves_lanes_unconverged_like_jax(systems):
    mj, mt, _, _ = _ops("dense", systems)
    b = systems["b"]
    rj = jcg(mj, jnp.asarray(b), tol=1e-5, maxiter=7)
    rt = tcg(mt, torch.from_numpy(b), tol=1e-5, maxiter=7)
    _check_same(rt, rj)
    assert not rt.converged.any()
    assert (rt.iterations == 7).all()
    np.testing.assert_allclose(rt.r_norm.numpy(), np.asarray(rj.r_norm),
                               rtol=1e-3)


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_matvec_and_curvature_equals_generic_path(systems, kind):
    _, mt, _, pt = _ops(kind, systems)
    b, x0 = torch.from_numpy(systems["b"]), torch.from_numpy(systems["x0"])
    tol = torch.from_numpy(TOL)
    before = tcg.curvature_steps

    def fused(p):
        Ap = mt(p)
        return Ap, torch.sum(p * Ap, -1)

    a = tcg(mt, b, x0, tol=tol, maxiter=300, precond=pt)
    f = tcg(None, b, x0, tol=tol, maxiter=300, precond=pt,
            r0=b - mt(x0), matvec_and_curvature=fused)
    # the loop runs on to the host's next all(done) read: after steps 1,
    # 2, 4, 8 and then every 8
    reads = [1, 2, 4] + list(range(8, 400, 8))
    want = min(r for r in reads if r >= int(f.iterations.max()))
    assert tcg.curvature_steps - before == want
    for name in ("x", "r_norm", "converged", "iterations"):
        assert torch.equal(getattr(a, name), getattr(f, name)), name


@pytest.mark.parametrize("check_every", [2, 5, 64])
def test_checking_every_k_steps_is_bitwise_equal(systems, check_every,
                                                 monkeypatch):
    """Frozen lanes make the steps after all(done) no-ops."""
    _, mt, _, pt = _ops("dense", systems)
    b, x0 = torch.from_numpy(systems["b"]), torch.from_numpy(systems["x0"])
    tol = torch.from_numpy(TOL)
    monkeypatch.setattr(cg_module, "_CHECK_EVERY", 1)
    every = tcg(mt, b, x0, tol=tol, maxiter=300, precond=pt)
    monkeypatch.setattr(cg_module, "_CHECK_EVERY", check_every)
    k = tcg(mt, b, x0, tol=tol, maxiter=300, precond=pt)
    for name in ("x", "r_norm", "converged", "iterations"):
        assert torch.equal(getattr(every, name), getattr(k, name)), name


def test_argument_checks(systems):
    b = torch.from_numpy(systems["b"])
    with pytest.raises(ValueError, match="need b"):
        tcg(lambda v: v, None)
    with pytest.raises(ValueError, match="b_norm"):
        tcg(lambda v: v, None, r0=b)
    with pytest.raises(ValueError, match="need matvec"):
        tcg(None, b, r0=b)
