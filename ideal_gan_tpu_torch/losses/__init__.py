"""Losses of the port."""

from .gan import adversarial_losses, r1_regularization
from .heteroscedastic import (absolute_phase_disparity, rician_nll, var_mse,
                              var_mse_r2)
from .regs import l1_mean, total_variation, total_variation_2d

__all__ = ["absolute_phase_disparity", "adversarial_losses", "l1_mean",
           "r1_regularization", "rician_nll", "total_variation",
           "total_variation_2d", "var_mse", "var_mse_r2"]
