"""MUSE vs HMC on the 512-dim noisy funnel: the port of examples/muse_vs_hmc.py.

The runnable analog of the reference docs' MUSE-vs-NUTS comparison
(MuseInference.jl docs/src/index.md): both methods target the same
hierarchical posterior; MUSE gets the θ marginal from a few hundred latent
MAP solves where HMC must sample the full 513-dimensional joint. A 1-D
quadrature of the closed-form marginal is the oracle both are judged by;
the HMC is the contender being timed, not an oracle.

Run:  python -m muse_tpu_torch.examples.muse_vs_hmc [--dim 512 --nsims 100]
      (add --device cpu to run on the CPU)
"""

import argparse
import time

import numpy as np
import torch
from torch.func import grad

from muse_tpu_torch import SimpleMuseProblem, muse
from muse_tpu_torch.utils import (lane_generator, resolve_device,
                                  synchronize)


def build_problem(dim, data_seed, device):
    def sample_x_z(gen, theta):
        z = torch.exp(theta / 2) * torch.randn(dim, generator=gen,
                                               device=gen.device)
        return z + torch.randn(dim, generator=gen, device=gen.device), z

    def log_like(x, z, theta):
        return -0.5 * (torch.sum((x - z) ** 2)
                       + torch.sum(z ** 2) / torch.exp(theta) + dim * theta)

    x_obs, _ = sample_x_z(lane_generator(data_seed, device),
                          torch.tensor(0.0, device=device))
    return SimpleMuseProblem(x_obs, sample_x_z, log_like,
                             log_prior=lambda th: -th ** 2 / 18), x_obs


def hmc_joint(log_post, q0, gen, *, n_samples=2000, n_leapfrog=30,
              step=0.02, burn=500):
    """Plain fixed-step HMC over the joint (θ, z), one chain, on q0's
    device; the accept test and the draws stay there (no host sync)."""
    grad_lp = grad(log_post)

    def leapfrog(q, p):
        p = p + 0.5 * step * grad_lp(q)
        for _ in range(n_leapfrog - 1):
            q = q + step * p
            p = p + step * grad_lp(q)
        q = q + step * p
        return q, p + 0.5 * step * grad_lp(q)

    q, lp = q0, log_post(q0)
    thetas = torch.empty(n_samples, dtype=q0.dtype, device=q0.device)
    accepts = torch.empty(n_samples, dtype=torch.bool, device=q0.device)
    for i in range(n_samples):
        p = torch.randn(q.shape, generator=gen, device=q.device)
        q_new, p_new = leapfrog(q, p)
        lp_new = log_post(q_new)
        log_accept = (lp_new - 0.5 * torch.sum(p_new ** 2)
                      - lp + 0.5 * torch.sum(p ** 2))
        accept = torch.log(torch.rand((), generator=gen,
                                      device=q.device)) < log_accept
        q = torch.where(accept, q_new, q)
        lp = torch.where(accept, lp_new, lp)
        thetas[i], accepts[i] = q[0], accept
    burn = min(burn, n_samples // 3)     # short runs: keep ≥2/3 of chain
    return thetas[burn:].cpu().numpy(), float(accepts.float().mean())


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--nsims", type=int, default=100)
    ap.add_argument("--hmc-samples", type=int, default=2000)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no fall back to "
                         "the CPU)")
    return ap.parse_args(argv)



def main(argv=None):
    """Run the demo; returns the exact, MUSE and HMC estimates and walls."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    prob, x_obs = build_problem(args.dim, 42, dev)

    # ---- exact marginal posterior (quadrature oracle) ----
    # this funnel has a closed-form marginal, x ~ N(0, (1+e^θ)·I): a 1D
    # quadrature of P(θ|x) is the ground truth BOTH methods chase
    x2 = float(torch.sum(x_obs.double() ** 2))
    th_grid = np.linspace(-4, 4, 8001)
    logp = (-0.5 * (x2 / (1 + np.exp(th_grid))
                    + args.dim * np.log(1 + np.exp(th_grid)))
            - th_grid ** 2 / 18)
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mu_ex = float((w * th_grid).sum())
    sd_ex = float(np.sqrt((w * (th_grid - mu_ex) ** 2).sum()))
    print(f"exact: θ = {mu_ex:+.4f} ± {sd_ex:.4f}   (1D quadrature of "
          "the closed-form marginal)")

    # ---- MUSE ----
    synchronize(dev)
    t0 = time.perf_counter()
    res = muse(prob, 1.0, nsims=args.nsims, maxsteps=30, theta_rtol=1e-3,
               get_covariance=True, seed=1)
    synchronize(dev)
    t_muse = time.perf_counter() - t0
    th_muse, sig_muse = float(res.theta[0]), float(res.sigma[0])
    print(f"MUSE:  θ = {th_muse:+.4f} ± {sig_muse:.4f}   "
          f"({t_muse:.1f}s, {args.nsims} sims)  "
          f"[MUSE − exact = {th_muse - mu_ex:+.3f}]")

    # ---- HMC on the joint (θ, z) ----
    def log_post(q):
        theta, z = q[0], q[1:]
        return prob.log_like(x_obs, z, theta) + prob.log_prior(theta)

    q0 = torch.cat([torch.ones(1, device=dev), torch.zeros(args.dim,
                                                           device=dev)])
    gen = torch.Generator(device=dev).manual_seed(2)
    synchronize(dev)
    t0 = time.perf_counter()
    thetas, acc = hmc_joint(log_post, q0, gen, n_samples=args.hmc_samples)
    t_hmc = time.perf_counter() - t0
    print(f"HMC:   θ = {thetas.mean():+.4f} ± {thetas.std():.4f}   "
          f"({t_hmc:.1f}s, accept {acc:.2f}, "
          f"{args.hmc_samples} samples × 30 leapfrog)")

    print(f"\nagreement: Δμ = {abs(th_muse - thetas.mean()):.3f}  "
          f"(σ ≈ {sig_muse:.3f});  speedup ×{t_hmc / t_muse:.1f} "
          "(plain fixed-step HMC mixes poorly in the funnel neck — "
          f"judge both against the exact line above; {dev})", flush=True)
    # MUSE must match the exact marginal tightly; HMC is the contender
    # being timed, not the oracle (its funnel bias is the point)
    assert abs(th_muse - mu_ex) < 0.5 * sd_ex, \
        "MUSE missed the exact marginal posterior"
    return {"exact": mu_ex, "exact_sd": sd_ex, "muse": th_muse,
            "muse_sigma": sig_muse, "muse_s": t_muse, "hmc": thetas.mean(),
            "hmc_sd": thetas.std(), "hmc_s": t_hmc, "accept": acc}


if __name__ == "__main__":
    main()
