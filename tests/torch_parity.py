"""Shared by the tests of the PyTorch port: run muse_tpu's fit and the
port's on the SAME whites.

muse_tpu's ``muse_fit`` draws its lanes' θ-independent whites from
``[fold_in(key, 2**31 - 1)] + sim_keys(key, nsims)``. The same keys through
the JAX problem's ``sample_white`` give the same arrays, which
``convert.whites_from_arrays`` hands to the port; the port's fit then runs
on them in place of its own draws, so both fits see the same data, the
same simulations and the same θ₀, and differ by float32 rounding only.

Run as a script, it prints the lensing demo's fit of both packages side by
side, step by step (θ, the lanes flagged failed, the lanes left
unconverged):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/torch_parity.py N NSIMS SOLVER [ATOL]
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

import muse_tpu
import muse_tpu_torch
from muse_tpu.utils.keys import sim_keys
from muse_tpu_torch import convert
from muse_tpu_torch.solver.compiled import CompiledProblem
from muse_tpu_torch.theta import ThetaSpec


def fits_on_jax_whites(pj, pt, theta0, nsims, *, z0=None, seed=1, **fit_kw):
    """(muse_tpu's MuseResult, the port's) of ``muse_fit`` from ``theta0``
    with ``nsims`` simulations whose whites muse_tpu drew. ``z0`` is the
    JAX side's warm start (converted for the port)."""
    key = jax.random.PRNGKey(seed)
    rj = muse_tpu.MuseResult()
    muse_tpu.muse_fit(rj, pj, theta0, key=key, nsims=nsims, z0=z0, **fit_kw)

    keys = jnp.concatenate([jax.random.fold_in(key, 2 ** 31 - 1)[None],
                            sim_keys(key, nsims)])
    W = convert.whites_from_arrays(
        *(np.asarray(w) for w in jax.vmap(pj.sample_white)(keys)),
        device="cpu")
    spec = ThetaSpec.from_example(theta0)
    comp = CompiledProblem(pt, spec, np.atleast_1d(
        np.asarray(theta0, np.float64)))
    comp.sample_whites = lambda seeds, x_only=False: W   # one chunk of lanes
    rt = muse_tpu_torch.muse_fit(
        muse_tpu_torch.MuseResult(), pt, theta0, nsims=nsims, seed=seed,
        compiled=comp, z0=None if z0 is None else convert.latent(z0, "cpu"),
        **fit_kw)
    return rj, rt


def assert_fits_agree(rj, rt, g_rtol=1e-4, theta_atol=1e-3):
    """The first iteration's per-lane scores (same θ₀, same sims) within
    ``g_rtol`` of their largest entry, and θ̂ within ``theta_atol``."""
    gj = np.asarray(rj.history[0]["g_like_sims"])
    gt = np.asarray(rt.history[0]["g_like_sims"])
    np.testing.assert_allclose(gt, gj, rtol=g_rtol,
                               atol=g_rtol * np.abs(gj).max())
    np.testing.assert_allclose(np.asarray(rt.theta), np.asarray(rj.theta),
                               rtol=0, atol=theta_atol)


def lensing_fits_side_by_side(n, nsims, solver, grad_z_atol=3e-3):
    """(muse_tpu's MuseResult, the port's) of the lensing demo's fit
    (examples/lensing_demo.py without its step clamp: data at θ = 0.3, θ₀ =
    0, the Wiener warm start, alpha = 0.3, Broyden, theta_rtol = 3e-4, at
    most 30 steps) at size ``n`` with ``solver`` in both packages, on the
    same data and whites."""
    import muse_tpu.models.lensing as jl
    from muse_tpu_torch.models import lensing as tl

    pj = jl.lensing_problem(n, theta_true=0.3, solver=solver,
                            data_key=jax.random.PRNGKey(7))
    pt = tl.lensing_problem(n, solver=solver, x_obs=np.asarray(pj.x),
                            device="cpu")
    return fits_on_jax_whites(pj, pt, 0.0, nsims, z0=pj.suggested_z0,
                              alpha=0.3, Hinv_update="broyden",
                              grad_z_atol=grad_z_atol, theta_rtol=3e-4,
                              maxsteps=30)


if __name__ == "__main__":
    n, nsims, solver = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    atol = float(sys.argv[4]) if len(sys.argv) > 4 else 3e-3
    for name, r in zip(("muse_tpu", "muse_tpu_torch"),
                       lensing_fits_side_by_side(n, nsims, solver, atol)):
        print(f"{name}: θ̂ {np.asarray(r.theta)} in {len(r.history)} steps")
        for i, h in enumerate(r.history):
            failed = np.flatnonzero(np.asarray(h["map_failed"])).tolist()
            open_ = np.flatnonzero(~np.asarray(h["map_converged"])).tolist()
            print(f"  step {i + 1}: θ {float(np.asarray(h['theta'])[0]):+.5f}"
                  f" failed lanes {failed} unconverged {open_}")
