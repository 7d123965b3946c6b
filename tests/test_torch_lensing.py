"""The lensing model of the port against muse_tpu's, function by function
and as a whole fit, on the same numpy inputs (made from a seed, or drawn by
muse_tpu and handed over as numpy).

n = 16 and n = 33: an even and an odd grid meet the hermitian
symmetrization of the packed spectrum differently (two self-conjugate
columns, or one). Tolerances:

  * rtol 1e-5 (of the largest entry) for the remap, the sampler
    completion, the density, the score, the preconditioners and the
    operator pair: the same float32 arithmetic through another FFT;
  * the adjoint identity |⟨Gz, w⟩ − ⟨z, Gᵀw⟩| ≤ 1e-5·‖Gz‖‖w‖ and the
    explicit Gᵀ against the AD transpose to 1e-5 of its largest entry;
  * a whole fit on muse_tpu's whites at weak lensing (one basin): per-lane
    scores within 1e-4, θ̂ within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import muse_tpu
import muse_tpu.models.lensing as jl
import muse_tpu.ops.varpro as jvp
import muse_tpu_torch
from muse_tpu.solver.compiled import CompiledProblem as JCompiled
from muse_tpu.theta import ThetaSpec as JSpec
from muse_tpu_torch import check_self_consistency, convert
from muse_tpu_torch.models import lensing as tl
from muse_tpu_torch.solver.compiled import CompiledProblem as TCompiled
from muse_tpu_torch.theta import ThetaSpec as TSpec
from muse_tpu_torch.utils.tree import TreeSpec
from torch_parity import (assert_fits_agree, fits_on_jax_whites,
                          lensing_fits_side_by_side)

torch.set_num_threads(1)

CPU = "cpu"
SIZES = [16, 33]


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _fields(n, k, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, n)).astype(np.float32) for _ in range(k)]


@functools.lru_cache(maxsize=None)
def _pair(n, amp=False, solver="varpro"):
    """(muse_tpu problem, port problem) on the same data."""
    pj = jl.lensing_problem(n, infer_z_amp=amp, solver=solver,
                            data_key=jax.random.PRNGKey(1))
    pt = tl.lensing_problem(n, infer_z_amp=amp, solver=solver,
                            x_obs=np.asarray(pj.x), device=CPU)
    return pj, pt


def _theta(amp):
    return np.array([0.4, -0.2], np.float32) if amp else np.float32(0.4)


# ------------------------------------------------------------------ #
# the remap operators
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n", SIZES)
def test_derivative_diagonals_are_hermitian_consistent(n):
    """The spectral diagonals keep a real field's spectrum one that a real
    field has (cuFFT's complex-to-real transform is undefined otherwise),
    and on a CPU they give the plain {1, ikx, iky, −kx², −ky², −kx·ky}
    products' fields, which drop the same Nyquist entries (1e-6 of the
    largest entry)."""
    K = tl.derivative_diagonals(n, CPU)
    torch.testing.assert_close(tl.herm_sym(K), K, rtol=0, atol=0)
    ky, kx = tl.k_grids(n, CPU)
    plain = [1.0 + 0j, 1j * kx, 1j * ky, -(kx ** 2), -(ky ** 2), -(kx * ky)]
    zf = torch.fft.rfft2(_t(_fields(n, 1)[0]))
    spec = zf * K
    torch.testing.assert_close(tl.herm_sym(spec), spec, rtol=0,
                               atol=1e-6 * float(spec.abs().max()))
    for j, mult in enumerate(plain):
        want = torch.fft.irfft2(zf * mult, s=(n, n))
        _close(torch.fft.irfft2(spec[j], s=(n, n)), want, rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_taylor_lens_and_gradient_field_match_jax(n):
    z, phi = _fields(n, 2)
    dxj, dyj = jl.gradient_field(jnp.asarray(phi))
    dxt, dyt = tl.gradient_field(_t(phi))
    _close(dxt, dxj)
    _close(dyt, dyj)
    _close(tl.taylor_lens(_t(z), 0.3 * dxt, 0.3 * dyt),
           jl.taylor_lens(jnp.asarray(z), 0.3 * dxj, 0.3 * dyj))
    # no deflection, no remap
    torch.testing.assert_close(
        tl.taylor_lens(_t(z), torch.zeros(n, n), torch.zeros(n, n)), _t(z),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_bilinear_warp_matches_jax(n):
    z, dx, dy = _fields(n, 3, seed=1)
    _close(tl.bilinear_warp(_t(z), _t(0.7 * dx), _t(0.7 * dy)),
           jl.bilinear_warp(jnp.asarray(z), jnp.asarray(0.7 * dx),
                            jnp.asarray(0.7 * dy)))
    # an integer shift is a roll
    one = torch.ones(n, n)
    torch.testing.assert_close(tl.bilinear_warp(_t(z), 2 * one, -one),
                               torch.roll(_t(z), (1, -2), (0, 1)))


# ------------------------------------------------------------------ #
# the model's functions
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_model_functions_match_jax(n, amp):
    """x_of_white, log_like and the analytic grad_theta (against muse_tpu's
    and against AD), for θ = log A_φ and for θ = (log A_φ, log A_z)."""
    pj, pt = _pair(n, amp)
    uz, uphi, e = _fields(n, 3, seed=2)
    th = _theta(amp)
    xj, zj = pj.x_of_white(tuple(jnp.asarray(v) for v in (uz, uphi, e)), th)
    xt, zt = pt.x_of_white((_t(uz), _t(uphi), _t(e)), _t(th))
    _close(xt, xj)
    assert sorted(zt) == ["uphi", "uz"]
    assert torch.equal(zt["uz"], _t(uz)) and torch.equal(zt["uphi"], _t(uphi))

    x = _fields(n, 1, seed=3)[0]
    uj = {"uz": jnp.asarray(uz), "uphi": jnp.asarray(uphi)}
    ut = {"uz": _t(uz), "uphi": _t(uphi)}
    lj = float(pj.log_like(jnp.asarray(x), uj, th))
    lt = float(pt.log_like(_t(x), ut, _t(th)))
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    gj = np.asarray(pj.grad_theta_log_like(jnp.asarray(x), uj, th))
    gt = pt.grad_theta_log_like(_t(x), ut, _t(th))
    assert gt.shape == gj.shape
    _close(gt, gj)
    g_ad = torch.func.grad(lambda t: pt.log_like(_t(x), ut, t))(_t(th))
    _close(gt, g_ad, rtol=1e-4)
    assert abs(float(pt.log_prior(_t(th))) - float(pj.log_prior(th))) < 1e-6


def test_flat_latent_is_uphi_then_uz():
    """The solvers' flat layout [uφ; u_z] is what the sorted-key TreeSpec
    gives the dict latent, as muse_tpu's ravel_pytree does."""
    n = 16
    _, pt = _pair(n)
    _, z = pt.sample_x_z(torch.Generator().manual_seed(0), torch.tensor(0.0))
    flat = TreeSpec(z).flatten(z)
    assert torch.equal(flat[:n * n], z["uphi"].reshape(-1))
    assert torch.equal(flat[n * n:], z["uz"].reshape(-1))
    from jax.flatten_util import ravel_pytree
    fj, _ = ravel_pytree({k: jnp.asarray(v.numpy()) for k, v in z.items()})
    np.testing.assert_array_equal(flat.numpy(), np.asarray(fj))


@pytest.mark.parametrize("n", SIZES)
def test_self_consistency(n):
    assert check_self_consistency(_pair(n)[1], 0.3)
    assert check_self_consistency(_pair(n, amp=True)[1], np.array([0.3, 0.1]))


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_preconditioners_match_jax(n, amp):
    """h_precond (one lane) against muse_tpu's, and the batched _precond2
    of the Newton solves against it lane by lane."""
    pj, pt = _pair(n, amp)
    th = np.atleast_1d(_theta(amp))
    w = np.random.default_rng(4).standard_normal((3, 2 * n * n)
                                                 ).astype(np.float32)
    want = np.stack([np.asarray(pj.suggested_h_precond(
        jnp.asarray(w[i]), None, jnp.asarray(th))) for i in range(3)])
    got = torch.stack([pt.suggested_h_precond(_t(w[i]), None, _t(th))
                       for i in range(3)])
    _close(got, want)
    _close(pt.precond(_t(th))(_t(w)), want)
    # SPD: ⟨w, M⁻¹w⟩ > 0
    assert float((got * _t(w)).sum(-1).min()) > 0


# ------------------------------------------------------------------ #
# the explicit operator pair of the VarPro inner solve
# ------------------------------------------------------------------ #

@pytest.fixture(scope="module", params=SIZES)
def pair_ops(request):
    """(n, muse_tpu's obs_op and (G, Gᵀ), the port's, inputs) at strong
    lensing, θ = 0.5, where dx and dy are large. muse_tpu's operators are
    captured from the call its zhat_varpro makes."""
    n = request.param
    captured = {}
    orig = jvp.batched_varpro

    def spy(obs_op, xs, U0, Z0, **kw):
        captured.update(obs_op=obs_op, lin_ops=kw["lin_ops"],
                        lin_sup=kw["lin_sup"],
                        precond_lin=kw["precond_lin"])
        return orig(obs_op, xs, U0, Z0, max_outer=1,
                    **{k: v for k, v in kw.items() if k != "max_outer"})

    pj, pt = _pair(n)
    jvp.batched_varpro = spy
    try:
        xs = jnp.asarray(np.stack(_fields(n, 3, seed=5)))
        pj.custom_zhat(xs, jnp.zeros((3, 2 * n * n), jnp.float32),
                       jnp.asarray([0.5], jnp.float32), 1e-2)
    finally:
        jvp.batched_varpro = orig
    rng = np.random.default_rng(6)
    Up = (0.5 * rng.standard_normal((3, n * n))).astype(np.float32)
    Zt = rng.standard_normal((3, 2 * n * (n // 2 + 1))).astype(np.float32)
    W = rng.standard_normal((3, n, n)).astype(np.float32)
    ops = pt.varpro_ops(torch.tensor([0.5]))
    return {"n": n, "jax": captured, "ops": ops, "Up": Up, "Zt": Zt, "W": W}


def test_G_and_Gt_match_jax(pair_ops):
    Up, Zt, W = pair_ops["Up"], pair_ops["Zt"], pair_ops["W"]
    Gj, Gtj = pair_ops["jax"]["lin_ops"](jnp.asarray(Up))
    G, Gt = pair_ops["ops"]["lin_ops"](_t(Up))
    _close(G(_t(Zt)), Gj(jnp.asarray(Zt)))
    _close(Gt(_t(W)), Gtj(jnp.asarray(W)))
    _close(pair_ops["ops"]["obs_op"](_t(Up), _t(Zt)),
           pair_ops["jax"]["obs_op"](jnp.asarray(Up), jnp.asarray(Zt)))
    _close(G(_t(Zt)), pair_ops["ops"]["obs_op"](_t(Up), _t(Zt)))
    _close(pair_ops["ops"]["lin_sup"](_t(Zt)),
           pair_ops["jax"]["lin_sup"](jnp.asarray(Zt)))
    _close(pair_ops["ops"]["precond_lin"](_t(Zt)),
           pair_ops["jax"]["precond_lin"](jnp.asarray(Zt)))


def test_adjoint_identity(pair_ops):
    """⟨G z, w⟩ = ⟨z, Gᵀ w⟩, the sums taken in float64."""
    G, Gt = pair_ops["ops"]["lin_ops"](_t(pair_ops["Up"]))
    Zt, W = _t(pair_ops["Zt"]), _t(pair_ops["W"])
    Gz, Gtw = G(Zt), Gt(W)
    lhs = (Gz.double() * W.double()).sum((-2, -1))
    rhs = (Zt.double() * Gtw.double()).sum(-1)
    scale = Gz.double().flatten(1).norm(dim=-1) * W.double().flatten(1).norm(
        dim=-1)
    assert float(((lhs - rhs).abs() / scale).max()) <= 1e-5


def test_explicit_transpose_matches_the_ad_transpose(pair_ops):
    """The hand-written Gᵀ against the vjp of obs_op(U, ·), the pair that
    batched_varpro takes without ``lin_ops``."""
    ops, Up = pair_ops["ops"], _t(pair_ops["Up"])
    _, Gt = ops["lin_ops"](Up)
    vjp_fn = torch.func.vjp(lambda V: ops["obs_op"](Up, V),
                            torch.zeros_like(_t(pair_ops["Zt"])))[1]
    W = _t(pair_ops["W"])
    _close(Gt(W), vjp_fn(W)[0])


def test_pack_is_an_isometry_onto_consistent_spectra(pair_ops):
    """pack(rfft2(u)) has the norm of u, unpack inverts it, and unpack of
    any packed vector is hermitian-consistent (irfft2 ∘ rfft2 keeps it)."""
    n, ops = pair_ops["n"], pair_ops["ops"]
    u = _t(np.stack(_fields(n, 2, seed=7)))
    zt = ops["pack"](torch.fft.rfft2(u))
    torch.testing.assert_close(zt.norm(dim=-1), u.flatten(1).norm(dim=-1),
                               rtol=1e-5, atol=0)
    back = torch.fft.irfft2(ops["unpack"](zt), s=(n, n))
    torch.testing.assert_close(back, u, rtol=0, atol=1e-5)
    zf = ops["unpack"](_t(pair_ops["Zt"]))
    again = torch.fft.rfft2(torch.fft.irfft2(zf, s=(n, n)))
    torch.testing.assert_close(again, zf, rtol=0,
                               atol=1e-5 * float(zf.abs().max()))


# ------------------------------------------------------------------ #
# construction: budgets, warm start, solvers, device
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n", [16, 128, 512])
def test_solver_budgets_equal_jax(n):
    x = np.zeros((n, n), np.float32)
    pj = jl.lensing_problem(n, x_obs=jnp.asarray(x))
    pt = tl.lensing_problem(n, x_obs=x, device=CPU)
    assert pt.solver_budgets == pj.solver_budgets
    assert pt.solver_budgets["solver"] == "varpro"       # "auto"


def test_explicit_budgets_are_respected():
    x = np.zeros((512, 512), np.float32)
    pt = tl.lensing_problem(512, x_obs=x, gn_cg_maxiter=77, gn_max_outer=9,
                            solver="newton", device=CPU)
    pj = jl.lensing_problem(512, x_obs=jnp.asarray(x), gn_cg_maxiter=77,
                            gn_max_outer=9, solver="newton")
    assert pt.solver_budgets == pj.solver_budgets
    assert pt.solver_budgets["varpro_inner_cg_maxiter"] == 77


@pytest.mark.parametrize("n", SIZES)
def test_suggested_z0_matches_jax(n):
    pj, pt = _pair(n)
    z0 = convert.latent(pj.suggested_z0, CPU)
    for k in ("uphi", "uz"):
        torch.testing.assert_close(pt.suggested_z0[k], z0[k], rtol=0,
                                   atol=1e-5)
    assert not pt.suggested_z0["uphi"].any()


@pytest.mark.parametrize("solver", ["auto", "varpro", "newton", "gn",
                                    "lbfgs"])
def test_every_solver_value_solves_the_map(solver):
    """Each solver brings 3 lanes at weak lensing under the tolerance, to
    the same MAP (one basin there; sup|g| < 1e-2 pins z to a few 1e-2)."""
    n = 16
    pt = tl.lensing_problem(n, solver=solver, x_obs=_pair(n)[1].x.numpy(),
                            device=CPU)
    assert (pt.custom_zhat is None) == (solver == "lbfgs")
    spec = TSpec.from_example(0.0)
    comp = TCompiled(pt, spec, np.array([-1.0]))
    th = torch.tensor([-1.0])
    xs, _ = comp._sample_batch([1, 2, 3], [th] * 3)
    Z, aux = comp._solve_maps(xs, torch.zeros((3, comp.nz)), th, 1e-2)
    assert aux["converged"].all() and not aux["failed"].any()
    ref = _pair(n, solver="newton")[1].custom_zhat(
        xs, torch.zeros((3, comp.nz)), th, 1e-3)[0]
    assert float((Z - ref).abs().max()) < 5e-2


def test_bad_solver_and_missing_card_raise():
    with pytest.raises(ValueError, match="solver"):
        tl.lensing_problem(8, solver="sgd", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tl.lensing_problem(8)


# ------------------------------------------------------------------ #
# the slice as a whole
# ------------------------------------------------------------------ #

def test_muse_step_white_matches_jax():
    """The same whites, θ, warm starts and lane ids through both packages'
    muse_step_white at weak lensing, the MAPs solved to 1e-3 (at 1e-2 the
    data lane's score moves by 4e-4 with the iteration its solve stops
    at): scores within 1e-4, Z within 1e-4·max|Z|, the same convergence
    flags."""
    n, B = 16, 5
    pj, pt = _pair(n)
    jspec, tspec = JSpec.from_example(0.0), TSpec.from_example(0.0)
    jc = JCompiled(pj, jspec, jspec.flatten(0.0))
    tc = TCompiled(pt, tspec, np.array([0.0]))
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    W_j = jc.sample_whites(keys)
    th = np.array([-1.0], np.float32)
    lanes = np.arange(B)
    Z0 = np.zeros((B, jc.nz), np.float32)
    out_j = jc.muse_step_white(jnp.asarray(th), jnp.asarray(th), W_j,
                               jnp.asarray(Z0), jnp.asarray(lanes),
                               jnp.float32(1e-3))
    W_t = convert.whites_from_arrays(*(np.asarray(w) for w in W_j),
                                     device=CPU)
    assert len(W_t) == 3
    out_t = tc.muse_step_white(_t(th), _t(th), W_t, _t(Z0), _t(lanes), 1e-3)
    _close(out_t["g"], out_j["g"], rtol=1e-4)
    Zj = np.asarray(out_j["Z"])
    np.testing.assert_allclose(out_t["Z"].numpy(), Zj, rtol=0,
                               atol=1e-4 * np.abs(Zj).max())
    np.testing.assert_array_equal(out_t["converged"].numpy(),
                                  np.asarray(out_j["converged"]))


def test_fit_on_jax_whites_matches_muse_tpu():
    """muse_fit of both packages on the same data and the same whites, at
    weak lensing (data drawn at θ = −1, fit from −1.2 with the Wiener warm
    start): per-lane scores within 1e-4, θ̂ within 1e-3."""
    n = 16
    pj = jl.lensing_problem(n, theta_true=-1.0,
                            data_key=jax.random.PRNGKey(2))
    pt = tl.lensing_problem(n, x_obs=np.asarray(pj.x), device=CPU)
    rj, rt = fits_on_jax_whites(pj, pt, -1.2, 8, z0=pj.suggested_z0,
                                alpha=0.4, maxsteps=4, theta_rtol=1e-6)
    assert len(rt.history) == len(rj.history) == 4
    assert_fits_agree(rj, rt)
    assert not any(h["map_failed"].any() for h in rt.history)


def test_lbfgs_fit_flags_no_more_lanes_than_muse_tpu():
    """The lensing demo's fit settings with ``solver="lbfgs"`` (the generic
    batched L-BFGS) in both packages, on the same data and whites. The
    plain Armijo test has no float32 floor in either package, so a lane's
    line search can spend its trials near the MAP tolerance 3e-3 and the
    lane is flagged failed and frozen: muse_tpu's fit flags lanes here (5
    over its 21 steps), the port's flags no more than it (0 over 12), and
    the two θ̂ agree within 5e-3 (measured 5e-4; the step counts differ)."""
    rj, rt = lensing_fits_side_by_side(16, 7, "lbfgs")
    failed_j = sum(int(np.asarray(h["map_failed"]).sum()) for h in rj.history)
    failed_t = sum(int(h["map_failed"].sum()) for h in rt.history)
    assert failed_t <= failed_j
    np.testing.assert_allclose(np.asarray(rt.theta), np.asarray(rj.theta),
                               rtol=0, atol=5e-3)


def test_implicit_H_with_the_model_preconditioner_matches_jax():
    """get_H's implicit mode on muse_tpu's whites: forward-mode AD through
    the FFT chain, the HVP and the Fourier CG preconditioner. H within 1e-2
    relative (float32 HVPs solved by CG to 1e-6)."""
    n = 16
    pj, pt = _pair(n)
    jspec, tspec = JSpec.from_example(0.0), TSpec.from_example(0.0)
    jc = JCompiled(pj, jspec, jspec.flatten(0.0))
    tc = TCompiled(pt, tspec, np.array([0.0]))
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    th = np.array([-1.0], np.float32)
    Hj, _ = jc.h_implicit_with(pj.suggested_h_precond)(
        keys, jnp.asarray(th), jnp.float32(1e-3), 100, 1e-6, False)
    W_t = convert.whites_from_arrays(
        *(np.asarray(w) for w in jc.sample_whites(keys)), device=CPU)
    Ht, resid = tc.h_implicit_from_whites(W_t, _t(th), 1e-3, 100, 1e-6, False,
                                          pt.suggested_h_precond)
    Hj = np.asarray(Hj)
    assert Ht.shape == Hj.shape == (3, 1, 1)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-2)
    assert float(resid.max()) < 1e-2
