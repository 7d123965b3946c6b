"""The port's foundations: seeds, θ specs, results, distributions, device
rules, the no-JAX import rule, and the paths not ported yet."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import stats

from muse_tpu.theta import ThetaSpec as JSpec
import muse_tpu_torch
from muse_tpu_torch import MuseResult, SimpleMuseProblem, ThetaSpec
from muse_tpu_torch.distributions import MvNormal, Normal
from muse_tpu_torch.models import (grf_field_problem, grf_problem,
                                   grf_spectral_problem)
from muse_tpu_torch.parallel import SimsMesh
from muse_tpu_torch.solver import CompiledProblem
from muse_tpu_torch.utils import (dummy_seed, lane_generator, resolve_device,
                                  sim_seeds)
from muse_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sim_seeds_fixed_and_prefix():
    a = sim_seeds(7, 10)
    assert a == sim_seeds(7, 10)                  # CRN: same seed, same sims
    assert sim_seeds(7, 25)[:10] == a             # superset prefix
    assert len(set(a)) == 10
    assert set(a).isdisjoint(sim_seeds(8, 10))
    assert set(a).isdisjoint(sim_seeds(7, 10, salt=1))
    assert dummy_seed(7) not in sim_seeds(7, 100)
    assert all(0 <= s < 2 ** 63 for s in a)
    with pytest.raises(ValueError):
        sim_seeds(-1, 3)


def test_lane_generator_reproduces_draws():
    a = torch.randn(5, generator=lane_generator(sim_seeds(3, 2)[1], "cpu"))
    b = torch.randn(5, generator=lane_generator(sim_seeds(3, 2)[1], "cpu"))
    assert torch.equal(a, b)


def test_import_leaves_jax_out():
    code = ("import sys, muse_tpu_torch, muse_tpu_torch.models, "
            "muse_tpu_torch.convert, muse_tpu_torch.ops.kernels; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_tf32_is_off_after_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("theta", [
    0.5, np.array([0.1, -0.2]), {"b": 1.0, "a": np.array([2.0, 3.0])},
    np.arange(6.0).reshape(2, 3), (0.4, -0.7),
    {"s": 0.5, "m": np.array([[1.0, -2.0], [0.25, 3.0]])}])
def test_theta_spec_round_trips_like_jax(theta):
    spec = ThetaSpec.from_example(theta)
    jspec = JSpec.from_example(theta)
    assert spec.names == jspec.names and spec.n == jspec.n
    assert spec.scalar == bool(jspec.scalar)
    flat = spec.flatten(theta)
    np.testing.assert_allclose(flat, np.asarray(jspec.flatten(theta)),
                               rtol=1e-7)
    user, juser = spec.to_user(flat), jspec.to_user(jspec.flatten(theta))
    assert type(user) is type(juser)
    if isinstance(theta, dict):
        assert sorted(user) == sorted(juser)
        for k in theta:
            np.testing.assert_allclose(user[k], theta[k])
            assert np.shape(user[k]) == np.shape(juser[k])
    else:
        np.testing.assert_allclose(user, theta)
        assert np.shape(user) == np.shape(juser)
    # tensors: differentiable unflatten
    t = torch.as_tensor(flat, dtype=torch.float32).requires_grad_(True)
    tree = spec.unflatten(t)
    sum((v ** 2).sum() for v in tree_leaves(tree)).backward()
    torch.testing.assert_close(t.grad, 2 * t.detach())
    torch.testing.assert_close(spec.flatten(tree), t.detach())


@pytest.mark.parametrize("theta", [{"a": {"b": 1.0}}, (0.1, np.ones(2))])
def test_theta_spec_refuses_what_jax_refuses(theta):
    with pytest.raises((TypeError, ValueError)):
        JSpec.from_example(theta)
    with pytest.raises((TypeError, ValueError)):
        ThetaSpec.from_example(theta)


def _blocks_problems(dim=80, blocks=5):
    """(muse_tpu problem, port problem) of a funnel whose five blocks take
    their log-variances from θ = {"s": (2, 2), "t": scalar}, in θ's flat
    order, on muse_tpu's data drawn at θ = 0."""
    import jax
    import jax.numpy as jnp
    import muse_tpu

    bs = dim // blocks

    def lv_j(th):
        return jnp.concatenate([jnp.ravel(th["s"]), jnp.reshape(th["t"], (1,))])

    def white_j(key):
        k1, k2 = jax.random.split(key)
        return jax.random.normal(k1, (dim,)), jax.random.normal(k2, (dim,))

    def x_of_white_j(W, th):
        z = jnp.repeat(jnp.exp(lv_j(th) / 2), bs) * W[0]
        return z + W[1], z

    def log_like_j(x, z, th):
        lv = jnp.repeat(lv_j(th), bs)
        return -0.5 * (jnp.sum((x - z) ** 2) + jnp.sum(z ** 2 * jnp.exp(-lv))
                       + jnp.sum(lv))

    def lv_t(th):
        return torch.cat([th["s"].reshape(-1), th["t"].reshape(1)])

    def white_t(gen):
        return (torch.randn(dim, generator=gen),
                torch.randn(dim, generator=gen))

    def x_of_white_t(W, th):
        z = torch.exp(lv_t(th) / 2).repeat_interleave(bs) * W[0]
        return z + W[1], z

    def log_like_t(x, z, th):
        lv = lv_t(th).repeat_interleave(bs)
        return -0.5 * (((x - z) ** 2).sum() + (z ** 2 * torch.exp(-lv)).sum()
                       + lv.sum())

    th_true = {"s": jnp.zeros((2, 2)), "t": jnp.float32(0.0)}
    x = x_of_white_j(white_j(jax.random.PRNGKey(42)), th_true)[0]
    pj = muse_tpu.SimpleMuseProblem(
        x, lambda k, th: x_of_white_j(white_j(k), th), log_like_j,
        lambda th: -jnp.sum(lv_j(th) ** 2) / 18, sample_white=white_j,
        x_of_white=x_of_white_j)
    pt = SimpleMuseProblem(
        torch.tensor(np.asarray(x)),
        lambda g, th: x_of_white_t(white_t(g), th), log_like_t,
        lambda th: -(lv_t(th) ** 2).sum() / 18, sample_white=white_t,
        x_of_white=x_of_white_t)
    return pj, pt


def test_fit_with_a_structured_theta_matches_jax():
    """muse_fit with a dict θ holding a (2, 2) leaf, both packages on the
    same data and whites: the same scores and θ̂, handed back in θ's
    structure under muse_tpu's names; then the port's own muse with its
    covariance, in that structure."""
    from torch_parity import assert_fits_agree, fits_on_jax_whites

    pj, pt = _blocks_problems()
    theta0 = {"s": np.full((2, 2), 0.2), "t": -0.1}
    rj, rt = fits_on_jax_whites(pj, pt, theta0, 24, theta_rtol=1e-2)
    assert_fits_agree(rj, rt)
    assert rt.theta_names == rj.theta_names == (
        "s[0]", "s[1]", "s[2]", "s[3]", "t")
    uj, ut = rj.theta_user, rt.theta_user
    assert sorted(ut) == ["s", "t"] and isinstance(ut["t"], float)
    assert np.shape(ut["s"]) == np.shape(uj["s"]) == (2, 2)
    np.testing.assert_allclose(ut["s"], np.asarray(uj["s"]), atol=1e-3)
    np.testing.assert_allclose(ut["t"], float(uj["t"]), atol=1e-3)

    res = muse_tpu_torch.muse(pt, theta0, nsims=24, theta_rtol=1e-2,
                              grad_z_atol=1e-3, get_covariance=True, seed=3)
    assert res.Sigma.shape == (5, 5) and np.isfinite(res.sigma).all()
    assert np.shape(res.theta_user["s"]) == (2, 2)


def test_result_save_load_round_trip(tmp_path):
    res = MuseResult(theta=np.array([0.3]), H=np.array([[2.0]]),
                     J=np.array([[3.0]]), Sigma=np.array([[0.25]]),
                     gs=[np.array([1.0]), np.array([2.0])],
                     history=[{"theta": np.array([0.3]),
                               "zhat_dat": torch.ones(3)}],
                     key=5)
    f = str(tmp_path / "r.pkl")
    res.save(f)
    back = muse_tpu_torch.load_result(f)
    np.testing.assert_array_equal(back.theta, res.theta)
    assert back.key == 5 and len(back.gs) == 2
    np.testing.assert_array_equal(back.history[0]["zhat_dat"], np.ones(3))
    assert back.dist == Normal(0.3, 0.5)
    assert "0.3" in repr(back)


def test_distributions_match_scipy():
    n = Normal(0.3, 2.0)
    np.testing.assert_allclose(n.log_prob(np.array([0.0, 1.5])).numpy(),
                               stats.norm(0.3, 2.0).logpdf([0.0, 1.5]))
    cov = np.array([[2.0, 0.6], [0.6, 1.0]])
    mv = MvNormal(np.array([0.1, -0.2]), cov)
    x = np.array([[0.0, 0.0], [1.0, -1.0]])
    np.testing.assert_allclose(
        mv.log_prob(x).numpy(),
        stats.multivariate_normal([0.1, -0.2], cov).logpdf(x))
    draws = mv.sample(lane_generator(0, "cpu"), (20000,)).numpy()
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.06)
    assert n.sample(lane_generator(0, "cpu"), (4,)).shape == (4,)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        grf_field_problem(n=8, device="cuda")


def test_problem_device_defaults_to_the_card():
    """A problem given no device and no tensor to take it from resolves
    the card at first use; a tensor's device, or an explicit one, wins."""
    f = lambda *a: None                                   # noqa: E731
    p = SimpleMuseProblem(np.zeros(3), f, f)
    if torch.cuda.is_available():
        assert p.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            p.device
    assert SimpleMuseProblem(torch.zeros(3), f, f).device.type == "cpu"
    assert SimpleMuseProblem(np.zeros(3), f, f, device="cpu").device == \
        torch.device("cpu")


def test_paths_not_ported_yet_raise():
    """Adaptive FD get_H and a problem without custom_zhat (the generic
    L-BFGS MAPs) run now; the paths left out raise and say where they
    stand in the ROADMAP, and the pixel grf_problem built for a field axis
    refuses the generic L-BFGS and names the route that runs it."""
    p = grf_field_problem(n=8, device="cpu")
    res = muse_tpu_torch.muse(p, 0.5, nsims=4, maxsteps=2)
    muse_tpu_torch.get_H(res, p, nsims=2, fd_order="adaptive")
    assert len(res.Hs) == 2 and res.metadata["fd_adaptive"]
    q = SimpleMuseProblem(p.x, p.sample_x_z, p.log_like)    # no custom_zhat
    r = muse_tpu_torch.muse(q, 0.5, nsims=4, maxsteps=2)
    assert r.history[0]["map_iterations"].max() > 0
    field = SimsMesh.__new__(SimsMesh)       # a mesh with a field axis, as
    field.field_axis = "field"               # far as the check reads it
    with pytest.raises(ValueError, match="gathered route"):
        grf_problem(n=8, mesh=field, solver="lbfgs", device="cpu")
    with pytest.raises(TypeError, match="SimsMesh"):
        grf_spectral_problem(n=8, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CompiledProblem(p, ThetaSpec.from_example(0.5),
                        np.array([0.5])).certifier


@pytest.mark.parametrize("fd_order,err", [(7, ValueError),
                                          ("adaptive", None)])
def test_get_H_checks_fd_order_first(fd_order, err):
    """An unknown fd_order raises even when the result already holds every
    H asked for; a known one (adaptive included) returns. Either way the
    result is left as it was."""
    p = grf_field_problem(n=8, device="cpu")
    res = muse_tpu_torch.muse(p, 0.5, nsims=4, maxsteps=2,
                              get_covariance=True)
    n_H, H = len(res.Hs), res.H.copy()
    assert n_H > 0
    if err is None:
        muse_tpu_torch.get_H(res, p, nsims=n_H, fd_order=fd_order)
    else:
        with pytest.raises(err):
            muse_tpu_torch.get_H(res, p, nsims=n_H, fd_order=fd_order)
    assert len(res.Hs) == n_H
    np.testing.assert_array_equal(res.H, H)
