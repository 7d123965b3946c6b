"""The lens operator's passes (``ops/lens_planes.py``, ``csrc/lens_planes.cu``)
and the explicit gradients ``models/lensing.py`` builds from them.

On the CPU, in float64 where the point is the algebra: the plain passes
composed as G and Gᵀ against the broadcast formulas they replace (kept here
as the oracle), the adjoint identity, the reduced gradient against
``torch.func.grad`` of ``reduced_value_and_grad``, the certificate against
``_vg_full``'s autograd, and ``zhat_varpro`` against the autograd path it
replaced, rebuilt here. Tests marked ``cuda`` need a card and ``nvcc`` and
skip elsewhere; this file imports no JAX, so they run with

    python -m pytest --noconftest -m cuda tests/test_torch_lens_planes.py

Tolerances: float64 compositions to 1e-12 of the largest entry. The
adjoint identity to 1e-7: the pack scale √2/n is a float32 constant, so
unpack and pack are inverse but not exactly isometric (measured ~3e-9).
Float32 gradients to 2e-6 of the largest entry (measured ≤ 3e-7: the
two routes sum the same few hundred terms in other orders). The kernels
against the plain version evaluated in float64 on the same float32 inputs.
"""

import pytest
import torch

from muse_tpu_torch.models.lensing import lensing_problem
from muse_tpu_torch.ops import lens_planes as lp
from muse_tpu_torch.ops.varpro import batched_varpro, reduced_value_and_grad
from muse_tpu_torch.utils import trace

torch.set_num_threads(1)

CPU = torch.device("cpu")
KERNELS = ("lens_expand_cuda", "lens_combine_cuda", "lens_residual_cuda",
           "lens_spread_cuda", "lens_contract_cuda")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _inputs(n, B, seed=0):
    """Random float64 (z̃, c, d, W, x) at n: a positive spectral scale and
    deflections of a few pixels."""
    g = torch.Generator().manual_seed(seed)
    nr = n // 2 + 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)
    zt, W, x = rnd(B, 2 * n * nr), rnd(B, n, n), rnd(B, n, n)
    c = rnd(n, nr).abs() + 0.1
    d = 2.0 * rnd(B, 2, n, n)
    return zt, c, d, W, x


def _oracle(n, c, d):
    """Today's (G, Gᵀ) before the passes, as ``lin_ops`` wrote them, in
    float64: unpack, herm_sym, the broadcast product with c·S_j, the D
    stack, the plane sum; and the same backwards."""
    K6z = c.double() * lp.derivative_diagonals(n, CPU).cdouble()
    sqw_n = lp._plain_tables(n, CPU)[1].double()
    dx, dy = d.unbind(-3)
    D = torch.stack([torch.ones_like(dx), dx, dy, 0.5 * dx * dx,
                     0.5 * dy * dy, dx * dy], -3)

    def G(zt):
        re, im = zt.chunk(2, -1)
        zf = lp.herm_sym(torch.complex(re, im).reshape(-1, n, n // 2 + 1)
                         / sqw_n)
        return torch.sum(torch.fft.irfft2(zf[..., None, :, :] * K6z,
                                          s=(n, n)) * D, -3)

    def Gt(W):
        F = torch.fft.rfft2(W[..., None, :, :] * D)
        y = lp.herm_sym(torch.sum(F * torch.conj(K6z), -3)) * sqw_n
        return torch.cat([y.real.flatten(-2), y.imag.flatten(-2)], -1)
    return G, Gt


def _plain_pair(n, c, d):
    def G(zt):
        return lp.lens_combine_plain(
            torch.fft.irfft2(lp.lens_expand_plain(zt, c), s=(n, n)), d)

    def Gt(W):
        return lp.lens_contract_plain(torch.fft.rfft2(lp.lens_spread_plain(
            W, d)), c)
    return G, Gt


@pytest.mark.parametrize("n", [15, 16, 32])
def test_plain_passes_compose_to_todays_pair(n):
    zt, c, d, W, _ = _inputs(n, 3)
    G0, Gt0 = _oracle(n, c, d)
    G, Gt = _plain_pair(n, c, d)
    assert _rel(G(zt), G0(zt)) <= 1e-12
    assert _rel(Gt(W), Gt0(W)) <= 1e-12


@pytest.mark.parametrize("n", [15, 16])
def test_plain_residual_form(n):
    """The residual form gives r = x − F, Σr² a lane and the cotangents
    r·∂F/∂d, which autograd of ½Σr² over d confirms; without r, the same
    sums and cotangents."""
    zt, c, d, _, x = _inputs(n, 2, seed=1)
    P6 = torch.fft.irfft2(lp.lens_expand_plain(zt, c), s=(n, n))
    r, rr, A = lp.lens_residual_plain(P6, d, x)
    no_r, rr1, A1 = lp.lens_residual(P6, d, x, keep_r=False)
    assert no_r is None
    torch.testing.assert_close((rr1, A1), (rr, A), rtol=0, atol=0)
    torch.testing.assert_close(r, x - lp.lens_combine_plain(P6, d),
                               rtol=0, atol=0)
    torch.testing.assert_close(rr, (r * r).sum((-2, -1)), rtol=1e-14,
                               atol=0)
    dd = d.clone().requires_grad_(True)
    half = 0.5 * ((x - lp.lens_combine_plain(P6, dd)) ** 2).sum()
    (grad_d,) = torch.autograd.grad(half, dd)
    assert _rel(A, -grad_d) <= 1e-12


@pytest.mark.parametrize("n", [15, 16])
def test_adjoint_identity(n):
    """⟨G z̃, w⟩ = ⟨z̃, Gᵀ w⟩ of the plain passes, in float64."""
    zt, c, d, W, _ = _inputs(n, 3, seed=2)
    G, Gt = _plain_pair(n, c, d)
    Gz, Gtw = G(zt), Gt(W)
    lhs = (Gz * W).sum((-2, -1))
    rhs = (zt * Gtw).sum(-1)
    scale = Gz.flatten(1).norm(dim=-1) * W.flatten(1).norm(dim=-1)
    assert float(((lhs - rhs).abs() / scale).max()) <= 1e-7


def _lane_inputs(p, n, B, dtype):
    g = torch.Generator().manual_seed(n)
    ops = p.varpro_ops(torch.tensor([0.5]))
    U = 0.5 * torch.randn((B, n * n), generator=g, dtype=dtype)
    uz = torch.randn((B, n, n), generator=g, dtype=dtype)
    xs = torch.stack([p.sample_x_z(g, 0.5)[0] for _ in range(B)]).to(dtype)
    Zt = ops["pack"](torch.fft.rfft2(uz))
    return ops, (U, Zt, uz.reshape(B, -1), xs)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-6)])
@pytest.mark.parametrize("n", [15, 16])
def test_reduced_gradient_is_autograds(n, dtype, tol):
    """The explicit reduced value and gradient (``value_and_grad``, the
    f_and_g of the main path) against ``torch.func.grad`` of
    ``reduced_value_and_grad`` through ``obs_op``."""
    p = lensing_problem(n=n, device=CPU)
    ops, (U, Zt, _, xs) = _lane_inputs(p, n, 3, dtype)
    f, g = ops["value_and_grad"](xs)(U, Zt)
    f0, g0 = reduced_value_and_grad(ops["obs_op"], xs, 0.04)(U, Zt)
    torch.testing.assert_close(f, f0, rtol=tol, atol=0)
    assert _rel(g, g0) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-6)])
@pytest.mark.parametrize("n", [15, 16])
def test_certificate_is_vg_full(n, dtype, tol):
    """The explicit certificate over [u_φ; u_z] against ``_vg_full``
    (autograd of −log_like), at u_z = irfft2(unpack(z̃))."""
    p = lensing_problem(n=n, device=CPU)
    ops, (U, Zt, uz, xs) = _lane_inputs(p, n, 3, dtype)
    f, g = ops["certificate"](xs, U, Zt, uz)
    f0, g0 = p.value_and_grad(xs, torch.tensor([0.5]))(torch.cat([U, uz],
                                                                 -1))
    torch.testing.assert_close(f, f0, rtol=tol, atol=0)
    assert _rel(g, g0) <= tol


@pytest.mark.parametrize("theta,z_tol", [(-1.0, 1e-4), (0.0, 1e-2)])
def test_zhat_varpro_matches_the_autograd_path(theta, z_tol):
    """``zhat_varpro`` at 16² against the path it replaced, rebuilt here:
    the broadcast (G, Gᵀ), autograd's reduced gradient and ``_vg_full``'s
    certificate. Same flags and objectives within 1e-5 (relative); on the
    CPU no kernel launches. The MAPs: at θ = −1 (7-13 reduced iterations)
    the float32 trajectories agree to 8e-7 of the largest entry, held to
    1e-4; at θ = 0 (32-69 iterations) the two roundings part the
    trajectories (iteration counts differ by up to 5) and the MAPs agree
    to the MAP tolerance's scale, 4e-3, held to 1e-2."""
    n, B, atol = 16, 4, 1e-2
    n2 = n * n
    p = lensing_problem(n=n, solver="varpro", device=CPU)
    th = torch.tensor([theta])
    g = torch.Generator().manual_seed(7)
    xs = torch.stack([p.sample_x_z(g, theta)[0] for _ in range(B)])
    Z0 = torch.zeros((B, 2 * n2))

    before = trace.counters()
    entries = p.zhat_varpro.polish_entries
    Z, aux = p.custom_zhat(xs, Z0, th, atol)
    assert p.zhat_varpro.polish_entries == entries
    assert all(trace.counters()[f"{k}.launches"]
               == before[f"{k}.launches"] for k in KERNELS)

    ops = p.varpro_ops(th)
    budgets = p.solver_budgets

    def oracle_lin_ops(Up):
        G0, Gt0 = _oracle(n, ops["scale"], ops["deflection"](Up).double())
        return (lambda Zt: G0(Zt.double()).float()), \
            (lambda W: Gt0(W.double()).float())

    res = batched_varpro(
        ops["obs_op"], xs, Z0[:, :n2], ops["pack"](torch.fft.rfft2(
            Z0[:, n2:].reshape(B, n, n))), sigma2=0.04, g_atol=atol,
        max_outer=budgets["gn_max_outer"],
        inner_maxiter=budgets["varpro_inner_cg_maxiter"],
        max_ls=budgets["varpro_max_ls"], m=10,
        precond_lin=ops["precond_lin"], lin_sup=ops["lin_sup"],
        lin_ops=oracle_lin_ops)
    uz = torch.fft.irfft2(ops["unpack"](res.z_lin), s=(n, n)).reshape(B, -1)
    Z0_ref = torch.cat([res.u_nl, uz], -1)
    f0, g0 = p.value_and_grad(xs, th)(Z0_ref)
    conv0 = g0.abs().amax(-1) < atol
    torch.testing.assert_close(aux["converged"], conv0, rtol=0, atol=0)
    assert bool(conv0.all())
    assert _rel(Z, Z0_ref) <= z_tol
    torch.testing.assert_close(aux["neg_logp"], f0, rtol=1e-5, atol=0)



# ---- the kernels, on a card ------------------------------------------ #

def _card_inputs(n, B, dev, seed):
    """Float32 inputs of every pass at (B, n) drawn on the card: a packed
    z̃, a positive spectral scale, deflections of a few pixels, six pixel
    planes, six spectra, W and x."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nr = n // 2 + 1

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)
    return {"zt": rnd(B, 2 * n * nr), "c": rnd(n, nr).abs() + 0.1,
            "d": 2.0 * rnd(B, 2, n, n), "P6": rnd(B, 6, n, n),
            "F6": rnd(B, 6, n, nr, dtype=torch.complex64),
            "W": rnd(B, n, n), "x": rnd(B, n, n)}


def _against_plain(name, args, tol, shared=()):
    """The kernel ``lp.<name>_cuda`` on float32 ``args`` against the plain
    version on the same values in float64: each output within ``tol`` of
    the largest entry of its reference; one launch; a rerun bitwise equal;
    lane 0 bitwise its launch alone (the ``args`` at the indices ``shared``
    are not per lane)."""
    kernel = getattr(lp, f"{name}_cuda")
    plain = getattr(lp, f"{name}_plain")

    def run(*a):
        out = kernel(*a)
        return out if isinstance(out, tuple) else (out,)
    before = kernel.launches
    got = run(*args)
    assert kernel.launches == before + 1
    want = plain(*[a.to(torch.complex128 if a.is_complex() else torch.float64)
                   for a in args])
    for k, w in zip(got, want if isinstance(want, tuple) else (want,)):
        assert _rel(k.to(w.dtype), w) <= tol, (name, _rel(k.to(w.dtype), w))
    assert all(torch.equal(a, b) for a, b in zip(got, run(*args)))
    alone = run(*[a if i in shared else a[:1].contiguous()
                  for i, a in enumerate(args)])
    assert all(torch.equal(a, b[:1]) for a, b in zip(alone, got))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8, 65])
@pytest.mark.parametrize("n", [256, 257, 1024])
def test_kernels_match_their_plain_versions(cuda, n, B):
    v = _card_inputs(n, B, cuda, seed=1000 * B + n)
    _against_plain("lens_expand", (v["zt"], v["c"]), 1e-6, shared=(1,))
    _against_plain("lens_combine", (v["P6"], v["d"]), 1e-6)
    _against_plain("lens_residual", (v["P6"], v["d"], v["x"]), 1e-6)
    r, rr, A = lp.lens_residual_cuda(v["P6"], v["d"], v["x"])
    no_r, rr1, A1 = lp.lens_residual_cuda(v["P6"], v["d"], v["x"],
                                          keep_r=False)
    assert no_r is None and torch.equal(rr1, rr) and torch.equal(A1, A)
    _against_plain("lens_spread", (v["W"], v["d"]), 1e-6)
    _against_plain("lens_contract", (v["F6"], v["c"]), 1e-6, shared=(1,))


@pytest.mark.cuda
def test_varpro_on_the_card_launches_the_kernels(cuda):
    """A ``zhat_varpro`` call at 64² launches every pass, and its G and Gᵀ
    keep the adjoint identity."""
    n, B = 64, 3
    p = lensing_problem(n=n, device=cuda)
    th = torch.tensor([0.0], device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    xs = torch.stack([p.sample_x_z(g, 0.0)[0] for _ in range(B)])
    before = trace.counters()
    _, aux = p.custom_zhat(xs, torch.zeros((B, 2 * n * n), device=cuda), th,
                           1e-2)
    after = trace.counters()
    assert all(after[f"{k}.launches"] > before[f"{k}.launches"]
               for k in KERNELS)
    assert bool(aux["converged"].all())
    ops = p.varpro_ops(th)
    G, Gt = ops["lin_ops"](0.5 * torch.randn((B, n * n), generator=g,
                                             device=cuda))
    Zt = torch.randn((B, 2 * n * (n // 2 + 1)), generator=g, device=cuda)
    W = torch.randn((B, n, n), generator=g, device=cuda)
    Gz, Gtw = G(Zt).double(), Gt(W).double()
    lhs = (Gz * W.double()).sum((-2, -1))
    rhs = (Zt.double() * Gtw).sum(-1)
    scale = Gz.flatten(1).norm(dim=-1) * W.double().flatten(1).norm(dim=-1)
    assert float(((lhs - rhs).abs() / scale).max()) <= 1e-5
