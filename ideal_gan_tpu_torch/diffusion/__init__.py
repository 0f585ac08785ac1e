"""DDPM/DDIM schedules and samplers (port of `ideal_gan_tpu/diffusion/`)."""

from .sampling import (
    ddim_reverse_step,
    ddim_sample,
    ddim_timesteps,
    ddpm_reverse_step,
    ddpm_sample,
    forward_noise,
    sample_timesteps,
)
from .schedules import (
    DiffusionSchedule,
    cosine_beta_schedule,
    linear_beta_schedule,
)

__all__ = [
    "DiffusionSchedule", "linear_beta_schedule", "cosine_beta_schedule",
    "forward_noise", "sample_timesteps", "ddpm_reverse_step",
    "ddim_reverse_step", "ddim_timesteps", "ddpm_sample", "ddim_sample",
]
