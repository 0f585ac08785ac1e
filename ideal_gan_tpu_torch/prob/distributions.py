"""The Normal and Rician map posteriors (port of
`ideal_gan_tpu/prob/distributions.py`), the outputs of a Bayesian UNet
head: `Normal` with a tanh activation, `Rician` otherwise.

Numerics follow the JAX package: the Bessel functions through the
exponentially scaled `torch.special.i0e` / `i1e` (differentiable), σ
floored at 1e-10, the Rician's log_prob zeroed for x ≤ 0, its mean and
variance through the Laguerre-½ polynomial. Samplers take an explicit
`torch.Generator` (`Rician.sample` also a `prob.noise` source).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.nn import functional as F
from torch.special import i0e, i1e

from .noise import as_noise

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def softplus_lb(x: torch.Tensor, lb: float = 1e-5) -> torch.Tensor:
    """softplus with a lower bound: softplus(x) + lb."""
    return F.softplus(x) + lb


@dataclasses.dataclass
class Normal:
    """Normal distribution N(loc, scale²)."""

    loc: torch.Tensor
    scale: torch.Tensor

    def mean(self) -> torch.Tensor:
        return self.loc

    def variance(self) -> torch.Tensor:
        return torch.square(self.scale)

    def stddev(self) -> torch.Tensor:
        return self.scale

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * torch.square(z) - torch.log(self.scale) - _HALF_LOG_2PI

    def sample(self, generator: torch.Generator,
               sample_shape=()) -> torch.Tensor:
        """loc + scale·N(0, 1) of shape sample_shape + loc's, drawn from
        `generator` (on loc's device)."""
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.loc + self.scale * eps

    def kl_to_std_normal(self) -> torch.Tensor:
        """KL(N(loc, scale²) ‖ N(0, 1)) elementwise."""
        var = torch.square(self.scale)
        return 0.5 * (torch.square(self.loc) + var - torch.log(var) - 1.0)


@dataclasses.dataclass
class Rician:
    """Rician distribution: ν ≥ 0 the noncentrality (signal) parameter,
    σ > 0 the noise scale, floored at 1e-10."""

    nu: torch.Tensor
    sigma: torch.Tensor
    sigma_floor: float = 1e-10

    def _sig(self) -> torch.Tensor:
        return torch.clamp(self.sigma, min=self.sigma_floor)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """log x − 2 log σ − (x² + ν²)/2σ² + log I0(xν/σ²), with
        log I0(z) = log i0e(z) + |z|; 0 where x ≤ 0."""
        sig = self._sig()
        sig2 = torch.square(sig)
        xp = torch.clamp(x, min=self.sigma_floor)
        z = xp * self.nu / sig2
        log_i0 = torch.log(i0e(z)) + torch.abs(z)
        lp = (torch.log(xp) - 2.0 * torch.log(sig)
              - (torch.square(xp) + torch.square(self.nu)) / (2.0 * sig2)
              + log_i0)
        return torch.where(x > 0, lp, torch.zeros_like(lp))

    @staticmethod
    def _laguerre_half(x: torch.Tensor) -> torch.Tensor:
        """L½(x) for x ≤ 0 through the scaled Bessels, where e^{x/2}
        cancels their rescaling: (1 − x)·i0e(−x/2) − x·i1e(−x/2)."""
        half = -0.5 * x
        return (1.0 - x) * i0e(half) - x * i1e(half)

    def mean(self) -> torch.Tensor:
        sig = self._sig()
        arg = -0.5 * torch.square(self.nu) / torch.square(sig)
        return sig * math.sqrt(math.pi / 2.0) * self._laguerre_half(arg)

    def variance(self) -> torch.Tensor:
        sig = self._sig()
        return (2.0 * torch.square(sig) + torch.square(self.nu)
                - torch.square(self.mean()))

    def mode_param(self) -> torch.Tensor:
        """ν, the trainers' 'clean signal' point estimate."""
        return self.nu

    def sample(self, generator, sample_shape=()) -> torch.Tensor:
        """√((ν + σX)² + (σY)²) with X, Y ~ N(0, 1) of shape sample_shape +
        ν's, X drawn before Y from `generator` (a `torch.Generator` on ν's
        device, or a `prob.noise` source)."""
        shape = tuple(sample_shape) + tuple(self.nu.shape)
        noise = as_noise(generator)
        x, y = (noise.normal(shape, self.nu) for _ in range(2))
        sig = self._sig()
        return torch.sqrt(torch.square(self.nu + sig * x)
                          + torch.square(sig * y))
