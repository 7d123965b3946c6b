"""The field-axis hooks of the port's MAP solvers (``reduce``,
``reduce_max`` and their companions in ``ops/lbfgs.py``, ``ops/varpro.py``
and ``ops/newton_cg.py``), on the CPU in one process.

  * Without hooks each loop is bitwise what it was before the hooks: the
    oracle is the verbatim copy in ``tests/torch_unhooked``.
  * With hooks the lanes' vectors are split in two halves, one solver per
    half in its own thread, and each hook sums (or maximizes) over both
    halves as a field group of 2 would. Both halves take the same steps,
    and together they are the unsharded solution: float64, held at 1e-8
    absolute (the solves stop at a sup-norm of 1e-9).
  * The vector-free two-loop recursion (:func:`_two_loop_gram`) against the
    sequential one, in float64, for per-lane and global-clock heads.

The objectives are separable per coordinate and written out by hand (no
``torch.func`` transform runs in a thread).
"""

import threading

import pytest
import torch

import torch_unhooked.lbfgs as old_lbfgs
import torch_unhooked.newton_cg as old_newton_cg
import torch_unhooked.varpro as old_varpro
from muse_tpu_torch.ops import lbfgs, newton_cg, varpro

B, N = 5, 24


def _problem(dtype):
    g = torch.Generator().manual_seed(3)
    a = torch.rand((B, N), generator=g, dtype=dtype) + 0.2
    c = torch.randn((B, N), generator=g, dtype=dtype)
    z0 = torch.randn((B, N), generator=g, dtype=dtype)
    return a, c, z0


def _parts(a, c, Z):
    """Per-lane partial objective, gradient and Hessian diagonal of the
    separable Σ ½a z² − c z + 0.1 z⁴ over the columns given."""
    f = (0.5 * a * Z * Z - c * Z + 0.1 * Z ** 4).sum(-1)
    return f, a * Z - c + 0.4 * Z ** 3, a + 1.2 * Z * Z


# ------------------------------------------------------------------ #
# no hooks: the loops of before, bit for bit
# ------------------------------------------------------------------ #

def _vg_func(a, c):
    def fn(Z):
        return torch.func.vmap(torch.func.grad_and_value(
            lambda z, aa, cc: (0.5 * aa * z * z - cc * z
                               + 0.1 * z ** 4).sum()))(Z, a, c)[::-1]
    return fn


def _lensing_like(dtype):
    """A separable VarPro problem: obs = (1 + ½tanh u)·z, linear in z."""
    g = torch.Generator().manual_seed(5)
    xs = torch.randn((B, N), generator=g, dtype=dtype)
    U0 = 0.1 * torch.randn((B, N), generator=g, dtype=dtype)
    Z0 = torch.zeros((B, N), dtype=dtype)

    def obs_op(U, Z):
        return (1.0 + 0.5 * torch.tanh(U)) * Z
    return obs_op, xs, U0, Z0


@pytest.mark.parametrize("solver", ["lbfgs", "newton_cg", "varpro"])
def test_solvers_without_hooks_are_the_old_loops(solver):
    a, c, z0 = _problem(torch.float32)
    if solver == "lbfgs":
        new = lbfgs.batched_lbfgs(_vg_func(a, c), z0, g_atol=1e-5, m=4)
        old = old_lbfgs.batched_lbfgs(_vg_func(a, c), z0, g_atol=1e-5, m=4)
    elif solver == "newton_cg":
        kw = dict(g_atol=1e-5, precond=lambda R: R / (a + 1.0))
        new = newton_cg.batched_newton_cg(_vg_func(a, c), z0, **kw)
        old = old_newton_cg.batched_newton_cg(_vg_func(a, c), z0, **kw)
    else:
        obs_op, xs, U0, Z0 = _lensing_like(torch.float32)
        kw = dict(sigma2=0.25, g_atol=1e-4, m=4)
        new = varpro.batched_varpro(obs_op, xs, U0, Z0, **kw)
        old = old_varpro.batched_varpro(obs_op, xs, U0, Z0, **kw)
    assert int(new.iterations.sum()) > B
    for n, o in zip(new, old):
        assert torch.equal(n, o)


# ------------------------------------------------------------------ #
# hooks: two halves of every lane, one thread each
# ------------------------------------------------------------------ #

class _FieldPair:
    """A field group of 2 as two threads: each hook posts this half's
    per-lane values and returns their sum or maximum over both halves."""

    def __init__(self):
        self.barrier = threading.Barrier(2)
        self.slots = [None, None]
        self.calls = [0, 0]

    def _combine(self, i, t, op):
        self.calls[i] += 1
        self.slots[i] = t
        self.barrier.wait(timeout=60)
        out = op(self.slots[0], self.slots[1])
        self.barrier.wait(timeout=60)
        return out

    def hooks(self, i):
        return (lambda t: self._combine(i, t, torch.add),
                lambda t: self._combine(i, t, torch.maximum))


def _halves(run):
    """``run(i, cols, reduce, reduce_max)`` on both halves in two threads;
    returns both results and the hook calls of each."""
    pair, out = _FieldPair(), [None, None]
    halves = (slice(0, N // 2), slice(N // 2, N))

    def go(i):
        out[i] = run(i, halves[i], *pair.hooks(i))

    threads = [threading.Thread(target=go, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert pair.calls[0] == pair.calls[1] > 0
    return out


def _same_steps_and_whole(halves, whole, vec_fields):
    """Both halves took the same steps and reached the same flags and the
    same whole sup-norm; every lane converged, as in the unsharded run, and
    side by side the halves' vectors are its solution. (The two differ in
    the order of each sum, so a lane may stop one iteration apart.)"""
    h0, h1 = halves
    for name in ("converged", "failed", "iterations", "g_norm"):
        assert torch.equal(getattr(h0, name), getattr(h1, name)), name
    assert h0.converged.all() and whole.converged.all()
    assert not h0.failed.any()
    assert (h0.iterations - whole.iterations).abs().max() <= 1
    for name in vec_fields:
        torch.testing.assert_close(
            torch.cat([getattr(h0, name), getattr(h1, name)], 1),
            getattr(whole, name), rtol=1e-8, atol=1e-8)


def test_lbfgs_field_hooks_sum_the_shards():
    a, c, z0 = _problem(torch.float64)

    def fn_whole(Z):
        f, g, _ = _parts(a, c, Z)
        return f, g

    # the unsharded run with hooks that reduce nothing: the vector-free
    # recursion, as the halves take it
    ident = (lambda t: t)
    whole = lbfgs.batched_lbfgs(fn_whole, z0, g_atol=1e-9, m=4,
                                reduce=ident, reduce_max=ident)
    plain = lbfgs.batched_lbfgs(fn_whole, z0, g_atol=1e-9, m=4)
    torch.testing.assert_close(whole.z, plain.z, rtol=1e-8, atol=1e-9)

    def run(i, cols, reduce, reduce_max):
        def fn(Z):
            f, g, _ = _parts(a[:, cols], c[:, cols], Z)
            return reduce(f), g
        return lbfgs.batched_lbfgs(fn, z0[:, cols], g_atol=1e-9, m=4,
                                   reduce=reduce, reduce_max=reduce_max)

    _same_steps_and_whole(_halves(run), whole, ("z", "g"))


def test_newton_cg_field_hooks_sum_the_shards():
    a, c, z0 = _problem(torch.float64)

    def fn_whole(Z):
        f, g, _ = _parts(a, c, Z)
        return f, g

    def hvp_at_whole(U):
        h = _parts(a, c, U)[2]
        return lambda v: h * v

    # the unsharded run with the analytic HVP, as the hooked halves take it
    ident = (lambda t: t)
    whole = newton_cg.batched_newton_cg(fn_whole, z0, g_atol=1e-9,
                                        reduce=ident, reduce_max=ident,
                                        hvp_at=hvp_at_whole)

    def run(i, cols, reduce, reduce_max):
        def fn(Z):
            f, g, _ = _parts(a[:, cols], c[:, cols], Z)
            return reduce(f), g

        def hvp_at(U):
            h = _parts(a[:, cols], c[:, cols], U)[2]
            return lambda v: h * v
        return newton_cg.batched_newton_cg(
            fn, z0[:, cols], g_atol=1e-9, reduce=reduce,
            reduce_max=reduce_max, hvp_at=hvp_at)

    _same_steps_and_whole(_halves(run), whole, ("z", "g"))


def test_newton_cg_identity_hooks_match_the_loop():
    """With hooks that reduce nothing, the hooked arithmetic (the merged
    sums of the Steihaug step) gives the loop's iterates in float64."""
    a, c, z0 = _problem(torch.float64)
    fn = _vg_func(a, c)

    def hvp_at(U):
        _, vjp_fn = torch.func.vjp(lambda W: fn(W)[1], U)
        return lambda v: vjp_fn(v)[0]

    ident = (lambda t: t)
    plain = newton_cg.batched_newton_cg(fn, z0, g_atol=1e-9)
    hooked = newton_cg.batched_newton_cg(fn, z0, g_atol=1e-9, reduce=ident,
                                         reduce_max=ident, hvp_at=hvp_at)
    assert torch.equal(plain.iterations, hooked.iterations)
    torch.testing.assert_close(hooked.z, plain.z, rtol=1e-8, atol=1e-10)


def test_varpro_field_hooks_sum_the_shards():
    obs_op, xs, U0, Z0 = _lensing_like(torch.float64)
    s2 = 0.25

    def lin_ops_of(D_of):
        def lin_ops(U):
            D = D_of(U)
            return (lambda Z: D * Z), (lambda W: D * W)
        return lin_ops

    def D_of(U):
        return 1.0 + 0.5 * torch.tanh(U)

    def f_and_g_of(x, reduce):
        def f_and_g(U, Z):
            D = D_of(U)
            r = x - D * Z
            f = 0.5 * ((r * r).sum(-1) / s2 + (U * U).sum(-1)
                       + (Z * Z).sum(-1))
            dD = 0.5 * (1.0 - torch.tanh(U) ** 2)
            return reduce(f), U - r * Z * dD / s2
        return f_and_g

    ident = (lambda t: t)
    kw = dict(sigma2=s2, g_atol=1e-9, m=4, inner_maxiter=80)
    whole = varpro.batched_varpro(obs_op, xs, U0, Z0, lin_ops=lin_ops_of(D_of),
                                  reduce=ident, reduce_max=ident,
                                  f_and_g=f_and_g_of(xs, ident), **kw)
    # the identity hooks are the unhooked loop's arithmetic up to rounding
    plain = varpro.batched_varpro(obs_op, xs, U0, Z0, **kw)
    torch.testing.assert_close(whole.u_nl, plain.u_nl, rtol=1e-7, atol=1e-9)

    def run(i, cols, reduce, reduce_max):
        return varpro.batched_varpro(
            obs_op, xs[:, cols], U0[:, cols], Z0[:, cols],
            lin_ops=lin_ops_of(D_of), reduce=reduce, reduce_max=reduce_max,
            f_and_g=f_and_g_of(xs[:, cols], reduce), **kw)

    _same_steps_and_whole(_halves(run), whole, ("u_nl", "z_lin"))


# ------------------------------------------------------------------ #
# the vector-free two-loop recursion
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("layout", ["per_lane", "chrono"])
def test_two_loop_gram_matches_the_recursion(layout):
    g = torch.Generator().manual_seed(11)
    m = 4
    S = torch.randn((m, B, N), generator=g, dtype=torch.float64)
    Y = S + 0.1 * torch.randn((m, B, N), generator=g, dtype=torch.float64)
    rho = 1.0 / (S * Y).sum(-1)
    valid = torch.rand((m, B), generator=g) > 0.3
    q = torch.randn((B, N), generator=g, dtype=torch.float64)
    if layout == "per_lane":
        head = torch.randint(0, 9, (B,), generator=g)
        want = lbfgs._two_loop(q, S, Y, rho, valid, head, m)
        idx = (head[None] - 1 - torch.arange(m)[:, None]) % m
    else:
        want = lbfgs._two_loop_chrono(q, S, Y, rho, valid, 7, m)
        idx = ((6 - torch.arange(m)) % m)[:, None].expand(m, B)
    got, gg = lbfgs._two_loop_gram(q, S, Y, rho, valid, idx, lambda t: t)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gg, (q * q).sum(-1), rtol=1e-14, atol=0.0)


def test_hooks_are_given_together():
    a, c, z0 = _problem(torch.float32)
    with pytest.raises(ValueError, match="together"):
        lbfgs.batched_lbfgs(_vg_func(a, c), z0, reduce=lambda t: t)
    with pytest.raises(ValueError, match="together"):
        newton_cg.batched_newton_cg(_vg_func(a, c), z0, reduce=lambda t: t)
