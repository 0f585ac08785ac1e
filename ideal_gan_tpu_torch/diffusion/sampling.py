"""Diffusion forward noising and reverse samplers (port of
`ideal_gan_tpu/diffusion/sampling.py`).

The JAX samplers run the reverse chain as one `lax.scan`; here the chain is
a plain loop over t, one denoiser call a step. Random draws: a
`torch.Generator` cannot reproduce `jax.random`'s values, so every function
takes its noise as an optional argument (`noise`, `t`, `z`; the samplers
`x_init` and `zs`, one z per step), drawn from `generator` on the tensors'
device where it is not given.

The reference's quirks are kept: the DDIM step takes α (not ᾱ) at t − 1,
the strided DDIM timesteps are `arange(T − 1, −1, −(T // n))[:n]`, and the
DDPM step adds √β_t·z at t = 0 too.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .schedules import DiffusionSchedule


def _normal(shape, like: torch.Tensor | None, generator, device=None,
            dtype=torch.float32) -> torch.Tensor:
    if like is not None:
        device, dtype = like.device, like.dtype
    return torch.randn(shape, generator=generator, device=device,
                       dtype=dtype)


def forward_noise(x0: torch.Tensor, t: torch.Tensor, sched: DiffusionSchedule,
                  noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
    """(x_t, ε) with x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε; t (nb,) integer."""
    if noise is None:
        noise = _normal(x0.shape, x0, generator)
    shape = (-1,) + (1,) * (x0.ndim - 1)
    ab = sched.alpha_bar[t]
    sab = torch.sqrt(ab).reshape(shape)
    somab = torch.sqrt(1.0 - ab).reshape(shape)
    return sab * x0 + somab * noise, noise


def sample_timesteps(num: int, timesteps: int,
                     generator: torch.Generator | None = None,
                     device=None) -> torch.Tensor:
    """Uniform timesteps in [0, T), (num,) int64."""
    return torch.randint(0, timesteps, (num,), generator=generator,
                         device=device)


def ddpm_reverse_step(x_t: torch.Tensor, pred_noise: torch.Tensor, t: int,
                      sched: DiffusionSchedule, z: torch.Tensor | None = None,
                      generator: torch.Generator | None = None):
    """One DDPM posterior step at the integer timestep t."""
    alpha_t = sched.alpha[t]
    alpha_bar_t = sched.alpha_bar[t]
    eps_coef = (1.0 - alpha_t) / torch.sqrt(1.0 - alpha_bar_t)
    mean = (x_t - eps_coef * pred_noise) / torch.sqrt(alpha_t)
    if z is None:
        z = _normal(x_t.shape, x_t, generator)
    return mean + torch.sqrt(sched.beta[t]) * z


def ddim_reverse_step(x_t: torch.Tensor, pred_noise: torch.Tensor, t: int,
                      sigma_t: float, sched: DiffusionSchedule,
                      z: torch.Tensor | None = None,
                      generator: torch.Generator | None = None):
    """One DDIM step at the integer timestep t, with the reference's α (not
    ᾱ) at t − 1."""
    alpha_bar_t = sched.alpha_bar[t]
    alpha_tm1 = sched.alpha[max(t - 1, 0)]
    pred_x0 = (x_t - torch.sqrt(1.0 - alpha_bar_t) * pred_noise) / torch.sqrt(
        alpha_bar_t)
    pred = torch.sqrt(alpha_tm1) * pred_x0
    pred = pred + torch.sqrt(torch.clamp(
        1.0 - alpha_tm1 - sigma_t ** 2, min=0.0)) * pred_noise
    if z is None:
        z = _normal(x_t.shape, x_t, generator)
    return pred + sigma_t * z


def ddim_timesteps(timesteps: int, n_steps: int) -> list[int]:
    """The strided DDIM timesteps, T − 1 downwards by T // n_steps, the
    first n_steps of them."""
    return list(range(timesteps - 1, -1, -(timesteps // n_steps)))[:n_steps]


def _chain(denoise_fn: Callable, step: Callable, ts: Sequence[int], shape,
           generator, x_init, zs, device):
    x = x_init if x_init is not None else _normal(shape, None, generator,
                                                  device)
    for i, t in enumerate(ts):
        t_b = torch.full((shape[0],), t, dtype=torch.long, device=x.device)
        eps = denoise_fn(x, t_b)
        x = step(x, eps, t, None if zs is None else zs[i])
    return x


def ddpm_sample(denoise_fn: Callable, shape, sched: DiffusionSchedule,
                generator: torch.Generator | None = None,
                x_init: torch.Tensor | None = None, zs=None,
                device=None) -> torch.Tensor:
    """The full DDPM reverse chain over t = T − 1 … 0: `denoise_fn(x, t)`
    → ε̂, t (nb,) int64. `sched` lies on the latents' device (`device`,
    by default the schedule's)."""
    return _chain(denoise_fn, lambda x, eps, t, z: ddpm_reverse_step(
        x, eps, t, sched, z, generator), range(sched.timesteps - 1, -1, -1),
        shape, generator, x_init, zs, device or sched.beta.device)


def ddim_sample(denoise_fn: Callable, shape, sched: DiffusionSchedule,
                n_steps: int, sigma: float = 0.0,
                generator: torch.Generator | None = None,
                x_init: torch.Tensor | None = None, zs=None,
                device=None) -> torch.Tensor:
    """The strided DDIM reverse chain (`ddim_timesteps`)."""
    return _chain(denoise_fn, lambda x, eps, t, z: ddim_reverse_step(
        x, eps, t, sigma, sched, z, generator),
        ddim_timesteps(sched.timesteps, n_steps), shape, generator, x_init,
        zs, device or sched.beta.device)
