"""Noisy-funnel model family — the reference's canonical test problem.

Counterpart of ``muse_tpu/models/funnel.py``:

θ ~ N(0, 3²),  z ~ N(0, e^θ I_D),  x ~ N(z, I_D)   (test/runtests.jl:14-18,
docstring example src/simple.jl:56-77). Scalar-θ and vector-θ variants;
the latter gives each of K blocks its own log-variance θ_k.

Closed forms the tests use as oracles:
  ẑ(x, θ) = x·a/(1+a) with a = e^θ            (Wiener filter)
  H(θ₀)    = ½ D a₀²/(1+a₀)²                   (d E[s]/dθ_sim)
  marginal MLE θ̂ = log(Σx²/D − 1)              (x ~ N(0, (1+a) I))

Both declare the CRN white split (``problem.py``): two (D,) normal draws
(w₁, then w₂) from the lane's generator, completed by z = e^{θ/2}·w₁,
x = z + w₂. The latent MAPs have no ``custom_zhat``: they are the generic
batched L-BFGS. The data are ``x_obs`` when given, else drawn at
``theta_true`` from ``data_seed``; ``convert.x_obs`` carries data over
from the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..adapters.simple import SimpleMuseProblem
from ..utils.device import resolve_device
from ..utils.keys import lane_generator

__all__ = ["funnel_problem", "vector_funnel_problem", "funnel_analytic_H"]


def _white_pair(dim: int):
    def sample_white(gen):
        return (torch.randn(dim, generator=gen, device=gen.device),
                torch.randn(dim, generator=gen, device=gen.device))
    return sample_white


def _data(x_obs, sample_x_z, theta_true, data_seed, dev):
    if x_obs is None:
        x_obs, _ = sample_x_z(lane_generator(data_seed, dev), theta_true)
        return x_obs
    if isinstance(x_obs, torch.Tensor):
        x_obs = x_obs.detach().cpu().numpy()
    return torch.tensor(np.asarray(x_obs, np.float32), device=dev)


def funnel_problem(dim: int = 512, *, x_obs=None, theta_true: float = 0.0,
                   data_seed: int = 42, prior_std: float = 3.0,
                   device="cuda") -> SimpleMuseProblem:
    """Scalar-θ noisy funnel (reference src/simple.jl:56-77)."""
    dev = resolve_device(device)
    sample_white = _white_pair(dim)

    def x_of_white(W, theta):
        w1, w2 = W
        z = torch.exp(theta / 2) * w1
        return z + w2, z

    def sample_x_z(gen, theta):
        return x_of_white(sample_white(gen), theta)

    def log_like(x, z, theta):
        return -0.5 * (torch.sum((x - z) ** 2)
                       + torch.sum(z ** 2) / torch.exp(theta) + dim * theta)

    def log_prior(theta):
        return -theta ** 2 / (2 * prior_std ** 2)

    x = _data(x_obs, sample_x_z, torch.tensor(float(theta_true), device=dev),
              data_seed, dev)
    prob = SimpleMuseProblem(x, sample_x_z, log_like, log_prior, device=dev,
                             sample_white=sample_white, x_of_white=x_of_white)
    prob.name = "funnel_problem"
    return prob


def vector_funnel_problem(dim: int = 256, blocks: int = 4, *, x_obs=None,
                          theta_true=None, data_seed: int = 42,
                          prior_std: float = 3.0,
                          device="cuda") -> SimpleMuseProblem:
    """Vector-θ funnel: K blocks of size dim//K, each with its own θ_k."""
    if dim % blocks:
        raise ValueError(f"dim {dim} is not a multiple of blocks {blocks}")
    dev = resolve_device(device)
    bs = dim // blocks
    sample_white = _white_pair(dim)

    def x_of_white(W, theta):
        w1, w2 = W
        z = torch.exp(theta / 2).repeat_interleave(bs) * w1
        return z + w2, z

    def sample_x_z(gen, theta):
        return x_of_white(sample_white(gen), theta)

    def log_like(x, z, theta):
        inv_var = torch.exp(-theta).repeat_interleave(bs)
        return -0.5 * (torch.sum((x - z) ** 2) + torch.sum(z ** 2 * inv_var)
                       + bs * torch.sum(theta))

    def log_prior(theta):
        return -torch.sum(theta ** 2) / (2 * prior_std ** 2)

    th_true = torch.zeros(blocks, device=dev) if theta_true is None else \
        torch.as_tensor(np.asarray(theta_true, np.float32), device=dev)
    x = _data(x_obs, sample_x_z, th_true, data_seed, dev)
    prob = SimpleMuseProblem(x, sample_x_z, log_like, log_prior, device=dev,
                             sample_white=sample_white, x_of_white=x_of_white)
    prob.name = "vector_funnel_problem"
    return prob


def funnel_analytic_H(theta0: float, dim: int) -> float:
    """d E_θ[s(θ₀)]/dθ at θ=θ₀ for the scalar funnel (see module doc)."""
    a = np.exp(theta0)
    return 0.5 * dim * a * a / (1 + a) ** 2
