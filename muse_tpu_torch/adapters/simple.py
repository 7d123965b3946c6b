"""SimpleMuseProblem — define a MUSE problem from raw closures.

Counterpart of ``muse_tpu/adapters/simple.py`` (the reference's
``SimpleMuseProblem``, ``src/simple.jl:79-95``): the user supplies ``x``,
``sample_x_z(generator, θ)``, ``log_like(x, z, θ)`` and an optional
``log_prior(θ)``; θ- and z-gradients come from ``torch.func``.

Example (the reference docstring's 512-dim noisy funnel)::

    import torch
    from muse_tpu_torch import SimpleMuseProblem, muse

    def sample_x_z(gen, theta):
        z = torch.exp(theta / 2) * torch.randn(512, generator=gen)
        x = z + torch.randn(512, generator=gen)
        return x, z

    def log_like(x, z, theta):
        return -0.5 * (((x - z) ** 2).sum() + (z ** 2).sum() / torch.exp(theta)
                       + 512 * theta)

    x, _ = sample_x_z(torch.Generator().manual_seed(42), torch.tensor(0.0))
    prob = SimpleMuseProblem(x, sample_x_z, log_like, lambda t: -t**2 / 18)
    result = muse(prob, 1.0, nsims=100, theta_rtol=1e-3, get_covariance=True)

Without ``custom_zhat`` the latent MAPs are the generic batched L-BFGS
(``ops/lbfgs.py``). Without ``device`` the problem takes ``x``'s device
when ``x`` is a tensor, and the card otherwise (here the CPU: the
generator and x live there).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..problem import MuseProblem

__all__ = ["SimpleMuseProblem"]


class SimpleMuseProblem(MuseProblem):

    def __init__(self,
                 x: Any,
                 sample_x_z: Callable,
                 log_like: Callable,
                 log_prior: Optional[Callable] = None,
                 theta_bijector=None,
                 volume_factor: bool = True,
                 zhat_guess_from_truth: Optional[Callable] = None,
                 custom_zhat=None,
                 grad_theta_log_like: Optional[Callable] = None,
                 device=None,
                 sample_white: Optional[Callable] = None,
                 x_of_white: Optional[Callable] = None,
                 x_white_parts=None):
        self.x = x
        if device is None and isinstance(x, torch.Tensor):
            device = x.device
        if device is not None:      # else the card, at first use
            self.device = device
        self._sample_x_z = sample_x_z
        self._log_like = log_like
        self._log_prior = log_prior
        self.theta_bijector = theta_bijector
        self.volume_factor = volume_factor
        self._zhat_guess = zhat_guess_from_truth
        self.custom_zhat = custom_zhat
        self.grad_theta_log_like = grad_theta_log_like
        # the CRN white split (problem.py): sample_x_z(g, θ) ≡
        # x_of_white(sample_white(g), θ)
        self.sample_white = sample_white
        self.x_of_white = x_of_white
        self.x_white_parts = x_white_parts

    def sample_x_z(self, generator, theta):
        return self._sample_x_z(generator, theta)

    def log_like(self, x, z, theta):
        return self._log_like(x, z, theta)

    def log_prior(self, theta):
        if self._log_prior is None:
            return super().log_prior(theta)
        return self._log_prior(theta)

    def zhat_guess_from_truth(self, x, z, theta):
        if self._zhat_guess is None:
            return super().zhat_guess_from_truth(x, z, theta)
        return self._zhat_guess(x, z, theta)
