"""Diffusion β schedules (port of `ideal_gan_tpu/diffusion/schedules.py`).

β, α = 1 − β and ᾱ = cumprod(α) are built in float64 numpy and then cast
to float32, as the JAX package builds them, so both packages hold the same
bits. `to(device)` moves the three tables to the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    beta: torch.Tensor       # (T,)
    alpha: torch.Tensor      # (T,)
    alpha_bar: torch.Tensor  # (T,)

    @property
    def timesteps(self) -> int:
        return self.beta.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(t.to(device) for t in self))


def _from_beta(beta: np.ndarray) -> DiffusionSchedule:
    alpha = 1.0 - beta
    alpha_bar = np.cumprod(alpha)
    return DiffusionSchedule(*(torch.from_numpy(a.astype(np.float32))
                               for a in (beta, alpha, alpha_bar)))


def linear_beta_schedule(timesteps: int, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> DiffusionSchedule:
    return _from_beta(np.linspace(beta_start, beta_end, timesteps,
                                  dtype=np.float64))


def cosine_beta_schedule(timesteps: int, s: float = 0.008,
                         max_beta: float = 0.999) -> DiffusionSchedule:
    t = np.arange(timesteps + 1, dtype=np.float64) / timesteps
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    alpha_bar = f / f[0]
    beta = np.clip(1.0 - alpha_bar[1:] / alpha_bar[:-1], 0.0, max_beta)
    return _from_beta(beta)
