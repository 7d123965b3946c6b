"""The global-clock two-loop and the trust-region Newton-CG of the port
against muse_tpu's, on the same numpy inputs.

Tolerances:
  * rtol 1e-5 for the two-loop recursion and one Steihaug solve: the same
    float32 arithmetic, dot products summed in other orders;
  * |Δz| ≤ 1e-4 (on the lensing objective 1e-4·max|z|: its solves stop at
    sup|g| < 1e-2, which pins z no better), equal converged/failed flags
    and equal iteration counts for whole Newton-CG solves on a quadratic
    and on the 16² lensing objective at weak lensing (θ = −1, −2), where
    the objective has one basin. (From θ ≈ 0 up it has several, and
    float32 rounding decides which one a cold-started lane of either
    package falls into.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from muse_tpu.models.lensing import lensing_problem as j_lensing
from muse_tpu.ops import lbfgs as jlbfgs
from muse_tpu.ops import newton_cg as jnc
from muse_tpu_torch.models.lensing import lensing_problem as t_lensing
from muse_tpu_torch.ops import lbfgs as tlbfgs
from muse_tpu_torch.ops import newton_cg as tnc

torch.set_num_threads(1)

CPU = "cpu"


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------------ #
# _two_loop_chrono
# ------------------------------------------------------------------ #

def _history(m, B, N, seed):
    """A global-clock history with ragged validity: some lanes skipped
    stores (their slots invalidated), one lane holds nothing."""
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((m, B, N)).astype(np.float32)
    Y = (S + 0.3 * rng.standard_normal((m, B, N))).astype(np.float32)
    rho = (1.0 / np.einsum("mbn,mbn->mb", S, Y)).astype(np.float32)
    valid = rng.random((m, B)) < 0.7
    valid[:, -1] = False
    g = rng.standard_normal((B, N)).astype(np.float32)
    return g, S, Y, rho, valid


@pytest.mark.parametrize("head", [0, 3, 7])
def test_two_loop_chrono_matches_jax(head):
    m, B, N = 5, 4, 11
    g, S, Y, rho, valid = _history(m, B, N, seed=head)
    want = np.asarray(jlbfgs._two_loop_chrono(
        jnp.asarray(g), jnp.asarray(S), jnp.asarray(Y), jnp.asarray(rho),
        jnp.asarray(valid), jnp.int32(head), m))
    got = tlbfgs._two_loop_chrono(_t(g), _t(S), _t(Y), _t(rho), _t(valid),
                                  head, m).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # a lane without a valid pair gets steepest descent
    np.testing.assert_array_equal(got[-1], -g[-1])


def test_two_loop_chrono_equals_the_per_lane_two_loop_on_full_rings():
    """When every lane stored at every iteration the two layouts hold the
    same history, and the two recursions give the same direction."""
    m, B, N = 4, 3, 9
    g, S, Y, rho, _ = _history(m, B, N, seed=11)
    valid = np.ones((m, B), bool)
    head = 6
    chrono = tlbfgs._two_loop_chrono(_t(g), _t(S), _t(Y), _t(rho),
                                     _t(valid), head, m)
    per_lane = tlbfgs._two_loop(_t(g), _t(S), _t(Y), _t(rho), _t(valid),
                                torch.full((B,), head), m)
    torch.testing.assert_close(chrono, per_lane, rtol=1e-6, atol=1e-6)


def test_two_loop_chrono_does_not_modify_its_inputs():
    g, S, Y, rho, valid = (_t(a) for a in _history(3, 2, 5, seed=1))
    keep = [a.clone() for a in (g, S, Y, rho, valid)]
    tlbfgs._two_loop_chrono(g, S, Y, rho, valid, 2, 3)
    for a, b in zip((g, S, Y, rho, valid), keep):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ #
# _steihaug
# ------------------------------------------------------------------ #

def _quadratic(B, N, seed, indefinite=False):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((B, N, N)).astype(np.float32)
    H = np.einsum("bij,bkj->bik", Q, Q) / N + 0.5 * np.eye(N, dtype=np.float32)
    if indefinite:
        H[:, 0, 0] -= 4.0
    a = rng.standard_normal((B, N)).astype(np.float32)
    return H.astype(np.float32), a


@pytest.mark.parametrize("case,delta,indefinite", [
    ("interior", 1e3, False), ("boundary", 0.3, False),
    ("negative curvature", 2.0, True)])
def test_steihaug_matches_jax(case, delta, indefinite):
    B, N = 3, 12
    H, a = _quadratic(B, N, seed=3, indefinite=indefinite)
    g = np.einsum("bij,bj->bi", H, -a).astype(np.float32)
    diag = np.abs(np.einsum("bii->bi", H)) + 0.1
    active = np.array([True, True, False])
    dj, bj, ij = jnc._steihaug(
        lambda v: jnp.einsum("bij,bj->bi", jnp.asarray(H), v), jnp.asarray(g),
        jnp.full((B,), delta, jnp.float32), lambda v: v / jnp.asarray(diag),
        40, 0.25, jnp.asarray(active))
    Ht, dt = _t(H), _t(diag)
    d, bhit, its = tnc._steihaug(
        lambda v: torch.einsum("bij,bj->bi", Ht, v), _t(g),
        torch.full((B,), delta), lambda v: v / dt, 40, 0.25, _t(active))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(bhit.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(its.numpy(), np.asarray(ij))
    assert not d[2].any() and int(its[2]) == 0       # the frozen lane
    if case != "interior":
        assert bhit[:2].all()
        np.testing.assert_allclose(d[:2].norm(dim=-1).numpy(), delta,
                                   rtol=1e-5)


# ------------------------------------------------------------------ #
# batched_newton_cg
# ------------------------------------------------------------------ #

def _diag_problem(B, N, lo, hi, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, N)).astype(np.float32)
    d = np.geomspace(lo, hi, N).astype(np.float32)[None]
    return a, d


def _assert_same_solve(rt, rj, z_atol=1e-4):
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), rtol=0,
                               atol=z_atol)
    for name in ("converged", "failed", "iterations", "cg_iterations"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)), name)


@pytest.mark.parametrize("precond", [False, True])
def test_newton_cg_on_a_quadratic_matches_jax(precond):
    """An SPD quadratic of condition number 100: same iterates, flags and
    per-lane outer and inner iteration counts, with and without the exact
    preconditioner."""
    B, N = 3, 48
    a, d = _diag_problem(B, N, 1.0, 100.0, seed=5)
    aj, dj = jnp.asarray(a), jnp.asarray(d)
    at, dt = _t(a), _t(d)

    def fj(Z):
        r = Z - aj
        return 0.5 * jnp.sum(dj * r * r, -1), dj * r

    def ft(Z):
        def fsum(U):
            f = 0.5 * (dt * (U - at) ** 2).sum(-1)
            return f.sum(), f
        g, f = torch.func.grad(fsum, has_aux=True)(Z)
        return f, g

    kw = dict(g_atol=1e-4, cg_maxiter=200, max_outer=50)
    rj = jnc.batched_newton_cg(fj, jnp.zeros((B, N)),
                               precond=(lambda v: v / dj) if precond else None,
                               **kw)
    rt = tnc.batched_newton_cg(ft, torch.zeros((B, N)),
                               precond=(lambda v: v / dt) if precond else None,
                               **kw)
    assert rt.converged.all()
    _assert_same_solve(rt, rj)
    np.testing.assert_allclose(rt.z.numpy(), a, atol=2e-4)


@pytest.fixture(scope="module")
def lensing16():
    """muse_tpu's and the port's 16² lensing problems (solver="newton") on
    the same data, with 4 lanes of observations drawn by muse_tpu at weak
    lensing."""
    n = 16
    pj = j_lensing(n, solver="newton", data_key=jax.random.PRNGKey(1))
    pt = t_lensing(n, solver="newton", x_obs=np.asarray(pj.x), device=CPU)
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    xs = {th: np.asarray(jax.vmap(pj.sample_x_z, in_axes=(0, None))(
        keys, jnp.float32(th))[0]) for th in (-1.0, -2.0)}
    return pj, pt, xs


@pytest.mark.parametrize("theta", [-1.0, -2.0])
def test_newton_cg_on_the_lensing_objective_matches_jax(lensing16, theta):
    """zhat_newton (batched_newton_cg on the joint 16² lensing objective
    with the Fourier preconditioner) from z = 0, solved to 1e-3: a lane
    that crosses the indefinite region takes ~19 outer iterations and
    amplifies float32 rounding, so at a looser tolerance the two packages
    may stop an iteration apart inside the tolerance ball. z within
    1e-4·max|z|, the same flags and outer iterations, the Steihaug steps
    within 5 (of up to ~110)."""
    pj, pt, xs = lensing16
    n2 = 2 * 16 * 16
    Zj, aj = pj.custom_zhat(jnp.asarray(xs[theta]),
                            jnp.zeros((4, n2), jnp.float32),
                            jnp.asarray([theta], jnp.float32), 1e-3)
    Zt, at = pt.custom_zhat(_t(xs[theta]), torch.zeros((4, n2)),
                            torch.tensor([theta]), 1e-3)
    assert at["converged"].all() and not at["failed"].any()
    Zj = np.asarray(Zj)
    np.testing.assert_allclose(Zt.numpy(), Zj, rtol=0,
                               atol=1e-4 * np.abs(Zj).max())
    for k in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(at[k].numpy(), np.asarray(aj[k]), k)
    np.testing.assert_allclose(at["cg_iterations"].numpy(),
                               np.asarray(aj["cg_iterations"]), rtol=0, atol=5)
    np.testing.assert_allclose(at["neg_logp"].numpy(),
                               np.asarray(aj["neg_logp"]), rtol=1e-5)


def test_hvp_is_the_vjp_of_the_gradient(lensing16):
    """The product that batched_newton_cg applies, torch.func.vjp of the
    gradient function, against a central difference of the gradient in
    float64 on the 16² lensing objective (relative error ≤ 1e-6)."""
    _, pt, xs = lensing16
    p64 = t_lensing(16, solver="newton", x_obs=pt.x.numpy(), device=CPU)
    rng = np.random.default_rng(0)
    U = torch.tensor(0.3 * rng.standard_normal((4, 512)))
    V = torch.tensor(rng.standard_normal((4, 512)))
    # float64 inputs promote the float32 constants of the model
    fn = p64.value_and_grad(torch.tensor(xs[-1.0]).double(),
                            torch.tensor([-1.0]))
    hv = torch.func.vjp(lambda u: fn(u)[1], U)[1](V)[0]
    eps = 1e-5
    fd = (fn(U + eps * V)[1] - fn(U - eps * V)[1]) / (2 * eps)
    assert hv.dtype == torch.float64
    err = float((hv - fd).abs().max() / fd.abs().max())
    assert err < 1e-6, err


def test_rosenbrock_batch_converges():
    """A nonconvex curved valley with indefinite Hessians on the way."""
    x0 = torch.tensor([[-1.2, 1.0], [0.0, 0.0], [2.0, 2.0], [-0.5, 2.0]])

    def fn(Z):
        def fsum(U):
            f = (1 - U[:, 0]) ** 2 + 100 * (U[:, 1] - U[:, 0] ** 2) ** 2
            return f.sum(), f
        g, f = torch.func.grad(fsum, has_aux=True)(Z)
        return f, g

    res = tnc.batched_newton_cg(fn, x0, g_atol=1e-4, max_outer=200)
    assert res.converged.all(), res.g_norm
    np.testing.assert_allclose(res.z.numpy(), np.ones((4, 2)), atol=1e-3)


def test_nan_lane_is_flagged_failed_and_the_others_converge():
    def fn(Z):
        def fsum(U):
            f = (U ** 2).sum(-1)
            f = torch.where(torch.arange(3) == 1, torch.nan, f)
            return (U ** 2).sum(), f
        g, f = torch.func.grad(fsum, has_aux=True)(Z)
        return f, g

    res = tnc.batched_newton_cg(fn, torch.ones((3, 4)), g_atol=1e-6)
    assert bool(res.failed[1]) and not bool(res.converged[1])
    assert bool(res.converged[0]) and bool(res.converged[2])
    assert int(res.iterations[1]) == 0


@pytest.mark.parametrize("every", [1, 64])
def test_result_does_not_depend_on_the_read_schedule(monkeypatch, every):
    """The host reads the done-masks on ops/cg.py's schedule; frozen lanes
    make the steps between two reads no-ops, so reading before every step
    or almost never gives the same result bit for bit, and the counters
    add up."""
    B, N = 3, 32
    a, d = _diag_problem(B, N, 1.0, 300.0, seed=9)
    at, dt = _t(a), _t(d)

    def fn(Z):
        def fsum(U):
            f = 0.5 * (dt * (U - at) ** 2).sum(-1) + 0.1 * (U ** 4).sum(-1)
            return f.sum(), f
        g, f = torch.func.grad(fsum, has_aux=True)(Z)
        return f, g

    ref = tnc.batched_newton_cg(fn, torch.zeros((B, N)), g_atol=1e-4)
    monkeypatch.setattr(tnc, "_CHECK_EVERY", every)
    c = tnc.batched_newton_cg
    before = (c.iterations, c.cg_steps, c.hvps, c.host_syncs)
    res = c(fn, torch.zeros((B, N)), g_atol=1e-4)
    for x, y in zip(res, ref):
        assert torch.equal(x, y)
    outer, steps, hvps, syncs = (now - was for now, was in zip(
        (c.iterations, c.cg_steps, c.hvps, c.host_syncs), before))
    assert outer >= int(res.iterations.max()) > 0
    # one product per Steihaug step and one for each predicted reduction
    assert hvps == steps + outer
    assert steps >= int(res.cg_iterations.max())
    assert syncs > 0
