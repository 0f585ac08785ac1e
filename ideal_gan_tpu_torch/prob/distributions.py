"""The Rician map posterior (port of `ideal_gan_tpu/prob/distributions.py`'s
`Rician`), the output of a Bayesian UNet head with a non-tanh activation.

Numerics follow the JAX package: the Bessel functions through the
exponentially scaled `torch.special.i0e` / `i1e` (differentiable), σ
floored at 1e-10, log_prob zeroed for x ≤ 0, mean and variance through the
Laguerre-½ polynomial. Not ported yet (ROADMAP Queue 1 item 5): `sample`,
and `Normal` (the tanh head), which the magnitude trainer does not use.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.special import i0e, i1e


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
