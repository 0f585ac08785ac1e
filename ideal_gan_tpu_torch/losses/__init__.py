"""Losses of the port."""

from .regs import l1_mean, total_variation, total_variation_2d

__all__ = ["l1_mean", "total_variation", "total_variation_2d"]
