"""Heteroscedastic and Rician likelihood losses and the phase disparity
metric (port of `ideal_gan_tpu/losses/heteroscedastic.py`).

`var_mse` keeps the reference's exact form: it divides the squared error by
the standard deviation (not the variance), floors σ² at 1e-5 and adds
log σ. `var_mse_r2` is the Rician NLL with the log-I0 through
`torch.special.i0e`; `rician_nll` the mean NLL under a `prob.Rician`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.special import i0e


def var_mse(y_true: torch.Tensor, y_pred: torch.Tensor,
            var_floor: float = 1e-5) -> torch.Tensor:
    """mean((y − μ)²/σ + log σ), the last-channel half of y_pred carrying
    the variance map σ²."""
    idx = y_pred.shape[-1] // 2
    var_map = torch.clamp(y_pred[..., idx:], min=var_floor)
    std_map = torch.sqrt(var_map)
    msd = torch.square(y_true - y_pred[..., :idx])
    return torch.mean(msd / std_map + torch.log(std_map))


def var_mse_r2(y_true: torch.Tensor, y_pred: torch.Tensor,
               var_floor: float = 1e-5,
               default_var: float = 1e-2) -> torch.Tensor:
    """Rician negative log-likelihood of magnitudes: −mean[log y − log σ²
    − (y² + ν²)/2σ² + log i0e(yν/σ²) + yν/σ²], y_pred [ν, σ²] (σ² =
    `default_var` with one channel)."""
    if y_pred.shape[-1] > 1:
        idx = y_pred.shape[-1] // 2
        var_map = y_pred[..., idx:]
    else:
        idx = 1
        var_map = torch.full_like(y_pred[..., :idx], default_var)
    nu = y_pred[..., :idx]
    var_map = torch.clamp(var_map, min=var_floor)
    zero = torch.zeros_like(var_map)
    loglik = torch.where(y_true > 1e-5,
                         torch.log(torch.clamp(y_true, min=1e-30)),
                         torch.zeros_like(y_true))
    loglik = loglik - torch.log(var_map)
    loglik = loglik - torch.where(
        var_map > 0, (torch.square(y_true) + torch.square(nu))
        / (2 * var_map), zero)
    z = torch.where(var_map > 0, y_true * nu / var_map, zero)
    i0e_z = i0e(z)
    loglik = loglik + torch.where(i0e_z > 0.0, torch.log(i0e_z),
                                  torch.zeros_like(i0e_z))
    return torch.mean(-(loglik + z))


def rician_nll(y_true: torch.Tensor, dist) -> torch.Tensor:
    """Mean negative log-likelihood under a `prob.Rician` posterior."""
    return -torch.mean(dist.log_prob(y_true))


def absolute_phase_disparity(y_true: torch.Tensor,
                             y_pred: torch.Tensor) -> torch.Tensor:
    """Magnitude-weighted |∠(y·ŷ*)| per batch element; the inputs carry
    [magnitude, phase/π] in their last two channels."""
    t_mag = y_true[..., :1]
    t_re = t_mag * torch.cos(y_true[..., 1:] * np.pi)
    t_im = t_mag * torch.sin(y_true[..., 1:] * np.pi)
    p_re = y_pred[..., :1] * torch.cos(y_pred[..., 1:] * np.pi)
    p_im = y_pred[..., :1] * torch.sin(y_pred[..., 1:] * np.pi)
    pha = torch.atan2(-t_re * p_im + t_im * p_re, t_re * p_re + t_im * p_im)
    dims = tuple(range(1, y_true.ndim))
    num = torch.sum(t_mag * pha.abs(), dim=dims)
    den = torch.sum(t_mag, dim=dims)
    return torch.where(den > 0, num / den, torch.zeros_like(den))
