"""The port's PPL, bijectors and distributions (``muse_tpu_torch/ppl.py``,
``transforms.py``, ``distributions.py``) against ``muse_tpu``'s on shared
values, and PPL models through the port's full pipeline.

Densities are compared on the same numpy values (``substitute`` fixes the
sites), at rtol 1e-5 (float32 sums of a few hundred terms). Samplers are
held to their distributions' moments at 4 standard errors (the two
packages draw different numbers, so only the law can agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from torch.func import grad, jacfwd

import muse_tpu
from muse_tpu import distributions as jd
from muse_tpu import ppl as jppl
from muse_tpu import transforms as jtf
import muse_tpu_torch
from muse_tpu_torch import check_self_consistency, convert
from muse_tpu_torch import distributions as td
from muse_tpu_torch import ppl as tppl
from muse_tpu_torch import transforms as ttf
from muse_tpu_torch.utils import lane_generator

torch.set_num_threads(1)

D, G, NI = 48, 3, 4


# ------------------------------------------------------------------ #
# distributions
# ------------------------------------------------------------------ #

# (name, params, values to evaluate at, the scipy law)
DISTS = [
    ("Normal", (0.3, 1.7), lambda r: r.normal(size=64),
     stats.norm(0.3, 1.7)),
    ("LogNormal", (0.2, 0.6), lambda r: r.lognormal(size=64),
     stats.lognorm(0.6, scale=np.exp(0.2))),
    ("HalfNormal", (1.3,), lambda r: np.abs(r.normal(size=64)),
     stats.halfnorm(scale=1.3)),
    ("Uniform", (2.0, 5.0), lambda r: r.uniform(1.5, 5.5, size=64),
     stats.uniform(2.0, 3.0)),
    ("Exponential", (1.5,), lambda r: r.exponential(size=64),
     stats.expon(scale=1 / 1.5)),
    ("Gamma", (2.5, 1.5), lambda r: r.gamma(2.0, size=64),
     stats.gamma(2.5, scale=1 / 1.5)),
    ("Gamma", (0.4, 2.0), lambda r: r.gamma(0.5, size=64),
     stats.gamma(0.4, scale=0.5)),
    ("Beta", (2.0, 3.5), lambda r: r.beta(2.0, 2.0, size=64),
     stats.beta(2.0, 3.5)),
    ("StudentT", (4.0, 0.5, 2.0), lambda r: r.standard_t(3.0, size=64),
     stats.t(4.0, 0.5, 2.0)),
]
IDS = [f"{n}{p}" for n, p, *_ in DISTS]


@pytest.mark.parametrize("name,params,values,law", DISTS, ids=IDS)
def test_log_prob_matches_jax_and_scipy(name, params, values, law):
    x = values(np.random.default_rng(0)).astype(np.float32)
    lt = getattr(td, name)(*params).log_prob(torch.tensor(x)).numpy()
    lj = np.asarray(getattr(jd, name)(*params).log_prob(jnp.asarray(x)))
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
    inside = np.isfinite(law.logpdf(x))
    np.testing.assert_allclose(lt[inside], law.logpdf(x)[inside], rtol=1e-4,
                               atol=1e-4)
    assert (lt[~inside] == -np.inf).all()


@pytest.mark.parametrize("name,params,values,law", DISTS, ids=IDS)
def test_sampler_moments(name, params, values, law):
    n = 40000
    d = getattr(td, name)(*params)
    s = d.sample(lane_generator(5, "cpu"), (n,))
    assert s.shape == (n,) and s.dtype == torch.float32
    s = s.double().numpy()
    assert np.isfinite(s).all()
    if name == "StudentT":             # heavy tails: the median and IQR
        np.testing.assert_allclose(np.median(s), law.median(), atol=0.05)
        q = np.percentile(s, [25, 75])
        np.testing.assert_allclose(q, law.ppf([0.25, 0.75]), atol=0.08)
        return
    se = law.std() / np.sqrt(n)
    assert abs(s.mean() - law.mean()) < 4 * se
    assert abs(s.var() / law.var() - 1) < 0.05
    # the same generator seed draws the same numbers
    again = d.sample(lane_generator(5, "cpu"), (n,)).double().numpy()
    np.testing.assert_array_equal(s, again)


def test_mvnormal_diag_and_expand():
    rng = np.random.default_rng(2)
    loc, sd = rng.normal(size=5), rng.uniform(0.5, 2, size=5)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    lt = td.MvNormalDiag(torch.tensor(loc, dtype=torch.float32),
                         torch.tensor(sd, dtype=torch.float32)).log_prob(
        torch.tensor(x))
    lj = jd.MvNormalDiag(jnp.asarray(loc, jnp.float32),
                         jnp.asarray(sd, jnp.float32)).log_prob(x)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    draws = td.MvNormalDiag(torch.tensor(loc), torch.tensor(sd)).sample(
        lane_generator(1, "cpu"), (20000, 5)).numpy()
    np.testing.assert_allclose(draws.mean(0), loc, atol=4 * sd.max() / 140)
    np.testing.assert_allclose(draws.std(0) / sd, 1, atol=0.03)
    e = td.Normal(0.0, 2.0).expand((3, 4))
    assert e.shape == (3, 4) and e.support == "real"
    assert e.sample(lane_generator(0, "cpu")).shape == (3, 4)
    # a scalar value under an expansion counts once per element
    assert e.log_prob(torch.tensor(0.5)).shape == (3, 4)
    assert td.Gamma(2.0, 1.0).expand((2,)).bijector().name == "log"


def test_log_prob_passes_vmap_and_grad():
    d = td.Gamma(2.0, 1.5)
    x = torch.tensor([[0.5, 1.0], [2.0, 3.0]])
    g = torch.func.vmap(grad(lambda v: d.log_prob(v).sum()))(x)
    np.testing.assert_allclose(g.numpy(), (1.0 / x - 1.5).numpy(), rtol=1e-6)


# ------------------------------------------------------------------ #
# bijectors
# ------------------------------------------------------------------ #

BIJ = [("Identity", ()), ("Log", ()), ("Softplus", ()), ("Logit", ()),
       ("Logit", (2.0, 5.0)), ("Affine", (-2.5, 0.7))]


@pytest.mark.parametrize("name,args", BIJ, ids=[f"{n}{a}" for n, a in BIJ])
def test_bijector_matches_jax_and_its_jacobian(name, args):
    lo, hi = (args if name == "Logit" and args else (0.0, 1.0))
    x = np.float32(np.random.default_rng(4).uniform(
        lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo), size=6))
    bt, bj = getattr(ttf, name)(*args), getattr(jtf, name)(*args)
    xt = torch.tensor(x)
    y = bt.forward(xt)
    np.testing.assert_allclose(y.numpy(), np.asarray(bj.forward(x)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bt.inverse(y).numpy(), x, rtol=1e-5)
    ldj = float(bt.log_det_jacobian(xt))
    np.testing.assert_allclose(ldj, float(bj.log_det_jacobian(x)),
                               rtol=1e-5, atol=1e-5)
    J = jacfwd(bt.forward)(xt.double())
    np.testing.assert_allclose(ldj, float(torch.logdet(J)), rtol=1e-4,
                               atol=1e-4)


def test_blockwise_and_from_support():
    bt = ttf.Blockwise([ttf.Identity(), ttf.Log(), ttf.Logit(2.0, 5.0)],
                       [2, 1, 2])
    bj = jtf.Blockwise([jtf.Identity(), jtf.Log(), jtf.Logit(2.0, 5.0)],
                       [2, 1, 2])
    x = np.float32([0.3, -1.2, 0.7, 2.5, 4.9])
    y = bt.forward(torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(bj.forward(x)),
                               rtol=1e-5)
    np.testing.assert_allclose(bt.inverse(y).numpy(), x, rtol=1e-5)
    np.testing.assert_allclose(float(bt.log_det_jacobian(torch.tensor(x))),
                               float(bj.log_det_jacobian(x)), rtol=1e-5)
    assert ttf.from_support("positive").name == "log"
    with pytest.raises(KeyError):
        ttf.from_support("simplex")


# ------------------------------------------------------------------ #
# the PPL: the same two models in both packages
# ------------------------------------------------------------------ #

def t_funnel():
    theta = tppl.sample("theta", td.Normal(0.0, 3.0))
    z = tppl.sample("z", td.Normal(0.0, torch.exp(theta / 2)).expand((D,)))
    tppl.sample("x", td.Normal(z, 1.0))


def j_funnel():
    theta = jppl.sample("theta", jd.Normal(0.0, 3.0))
    z = jppl.sample("z", jd.Normal(0.0, jnp.exp(theta / 2)).expand((D,)))
    jppl.sample("x", jd.Normal(z, 1.0))


def _hier(ppl, dist):
    """A positive hyper (tau, Log-linked), a plate of groups with a
    positive latent (s), a nested plate of items, a θ-only factor and a
    deterministic site."""
    def model():
        tau = ppl.sample("tau", dist.HalfNormal(1.0))
        mu = ppl.sample("mu", dist.Normal(0.0, 2.0))
        with ppl.plate("groups", G):
            u = ppl.sample("u", dist.Normal(mu, tau))
            s = ppl.sample("s", dist.LogNormal(-1.0, 0.3))
            with ppl.plate("items", NI):
                ppl.sample("x", dist.Normal(u, s))
        ppl.factor("tilt", -0.5 * tau ** 2)
        ppl.deterministic("u_mean", u.mean())
    return model


t_hier = _hier(tppl, td)
j_hier = _hier(jppl, jd)


def _values(model_name):
    rng = np.random.default_rng(7)
    if model_name == "funnel":
        theta = {"theta": np.float32(0.4)}
        z = {"z": rng.normal(size=D).astype(np.float32)}
        x = {"x": rng.normal(size=D).astype(np.float32)}
    else:
        theta = {"mu": np.float32(0.3), "tau": np.float32(0.8)}
        z = {"s": rng.normal(-1, 0.2, size=G).astype(np.float32),
             "u": rng.normal(size=G).astype(np.float32)}
        x = {"x": rng.normal(size=(NI, G)).astype(np.float32)}
    return theta, z, x


def _problems(model_name, params):
    _, _, x = _values(model_name)
    tm, jm = ((t_funnel, j_funnel) if model_name == "funnel"
              else (t_hier, j_hier))
    pt = tppl.PPLMuseProblem(tm, observed=convert.observed(x, "cpu"),
                             params=params)
    pj = jppl.PPLMuseProblem(jm, observed=x, params=params)
    return pt, pj


@pytest.mark.parametrize("model_name,params", [
    ("funnel", ("theta",)), ("hier", ("mu", "tau")), ("hier", None)])
def test_ppl_densities_match_jax(model_name, params):
    pt, pj = _problems(model_name, params)
    assert pt.params == pj.params and pt.latent_vars == pj.latent_vars
    assert pt.device == torch.device("cpu")
    theta, z, x = _values(model_name)
    theta = {k: v for k, v in theta.items() if k in pt.params}
    for k in pt.params:                 # inferred roots take site shapes
        theta.setdefault(k, np.full(tuple(pt._discovery[k]["value"].shape),
                                    0.2, np.float32))
    z = {k: v for k, v in z.items() if k in pt.latent_vars}

    def tt(d):
        return {k: torch.tensor(v) for k, v in d.items()}

    np.testing.assert_allclose(
        float(pt.log_like(tt(x), tt(z), tt(theta))),
        float(pj.log_like(x, z, theta)), rtol=1e-5)
    np.testing.assert_allclose(float(pt.log_prior(tt(theta))),
                               float(pj.log_prior(theta)), rtol=1e-5,
                               atol=1e-6)
    assert pt._prior_factors == pj._prior_factors
    # θ's blockwise bijector over the flat θ in sorted-key order
    flat = np.concatenate([np.reshape(theta[k], -1)
                           for k in sorted(theta)]).astype(np.float32)
    if pj.theta_bijector is None:
        assert pt.theta_bijector is None
    else:
        bt, bj = pt.theta_bijector, pj.theta_bijector
        assert [b.name for b in bt.bijectors] == [b.name for b in
                                                  bj.bijectors]
        np.testing.assert_allclose(bt.forward(torch.tensor(flat)).numpy(),
                                   np.asarray(bj.forward(flat)), rtol=1e-6)
        np.testing.assert_allclose(
            float(bt.log_det_jacobian(torch.tensor(flat))),
            float(bj.log_det_jacobian(flat)), rtol=1e-6)


def test_ppl_sample_shapes_and_links():
    pt, _ = _problems("hier", ("mu", "tau"))
    x, z = pt.sample_x_z(lane_generator(3, "cpu"),
                         {"mu": torch.tensor(0.1), "tau": torch.tensor(0.5)})
    assert x["x"].shape == (NI, G)
    assert z["u"].shape == (G,) and z["s"].shape == (G,)
    assert (z["s"] < 0).all()            # log-linked LogNormal(−1, 0.3)
    assert pt.theta_bijector.sizes == [1, 1]
    assert check_self_consistency(pt, {"mu": 0.2, "tau": 0.7})


def test_ppl_observed_shape_and_site_errors():
    with pytest.raises(ValueError, match="broadcast"):
        tppl.PPLMuseProblem(t_funnel, observed={"x": torch.zeros(2, D)})
    with pytest.raises(ValueError, match="not sites"):
        tppl.PPLMuseProblem(t_funnel, observed={"x": torch.zeros(D)},
                            params=("sigma",))
    with pytest.raises(ValueError, match="factor"):
        tppl.PPLMuseProblem(t_hier, observed={"x": torch.zeros(NI, G)},
                            params=("tilt",))
    with pytest.raises(RuntimeError, match="no seed"):
        t_funnel()


@pytest.fixture(scope="module")
def funnel_x():
    g = torch.Generator().manual_seed(42)
    z = torch.randn(D, generator=g)
    return z + torch.randn(D, generator=g)


def test_muse_on_a_model_function(funnel_x):
    """muse(model_fn, θ₀, observed=...) builds the problem from θ₀'s keys
    and runs the full pipeline; θ̂ lands near the exact marginal MLE."""
    res = muse_tpu_torch.muse(t_funnel, {"theta": 1.0},
                              observed={"x": funnel_x}, nsims=24,
                              theta_rtol=1e-3, get_covariance=True, seed=1)
    mle = float(np.log((funnel_x.double() ** 2).sum().item() / D - 1))
    assert res.theta_names == ("theta",)
    assert abs(float(res.theta[0]) - mle) < \
        3 * float(res.sigma[0]) / np.sqrt(24) + 0.02
    # get_J and get_H take the model function too
    r2 = muse_tpu_torch.MuseResult()
    muse_tpu_torch.get_J(r2, t_funnel, {"theta": float(res.theta[0])},
                         observed={"x": funnel_x}, nsims=8)
    muse_tpu_torch.get_H(r2, t_funnel, observed={"x": funnel_x}, nsims=2,
                         theta0={"theta": float(res.theta[0])})
    assert r2.J.shape == r2.H.shape == (1, 1) and r2.H[0, 0] > 0
    with pytest.raises(ValueError, match="observed"):
        muse_tpu_torch.muse(t_funnel, {"theta": 1.0})


def test_positive_hyper_fit_with_volume_factor(funnel_x):
    """A LogNormal-scale hyper: θ runs in log space through Blockwise, with
    the volume factor, and the fit matches muse_tpu's on the same data
    within Monte-Carlo error."""
    def t_model():
        s = tppl.sample("s", td.LogNormal(0.0, 1.0))
        z = tppl.sample("z", td.Normal(0.0, s).expand((D,)))
        tppl.sample("x", td.Normal(z, 1.0))

    def j_model():
        s = jppl.sample("s", jd.LogNormal(0.0, 1.0))
        z = jppl.sample("z", jd.Normal(0.0, s).expand((D,)))
        jppl.sample("x", jd.Normal(z, 1.0))

    x = funnel_x.numpy()
    pt = muse_tpu_torch.model_problem(t_model, {"s": 1.0},
                                      observed={"x": funnel_x})
    assert isinstance(pt.theta_bijector, ttf.Blockwise)
    rt = muse_tpu_torch.muse(pt, {"s": 1.0}, nsims=24, theta_rtol=1e-3,
                             get_covariance=True, seed=2)
    rj = muse_tpu.muse(j_model, {"s": 1.0}, observed={"x": x}, nsims=24,
                       theta_rtol=1e-3, get_covariance=True,
                       key=jax.random.PRNGKey(2))
    assert rt.theta[0] > 0 and np.isfinite(rt.sigma[0])
    bound = 3 * np.hypot(rt.sigma[0], rj.sigma[0]) / np.sqrt(24) + 0.05
    assert abs(rt.theta[0] - rj.theta[0]) < bound
