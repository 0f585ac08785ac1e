"""Spatial regularizers: total variation and L1 (port of
`ideal_gan_tpu/losses/regs.py`)."""

from __future__ import annotations

import torch


def total_variation_2d(img: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV summed per image for NHWC tensors, matching
    tf.image.total_variation: Σ|∂x| + Σ|∂y| per batch element."""
    dh = (img[:, 1:, :, :] - img[:, :-1, :, :]).abs()
    dw = (img[:, :, 1:, :] - img[:, :, :-1, :]).abs()
    return dh.sum(dim=(1, 2, 3)) + dw.sum(dim=(1, 2, 3))


def total_variation(maps: torch.Tensor) -> torch.Tensor:
    """Σ over the batch of per-image TV; accepts (nb, H, W, C) or MEBCRN
    rows (nb, 1, H, W, C)."""
    if maps.ndim == 5:
        maps = maps[:, 0]
    return total_variation_2d(maps).sum()


def l1_mean(maps: torch.Tensor) -> torch.Tensor:
    """Σ over the batch of mean |x| per element."""
    return maps.abs().mean(dim=tuple(range(1, maps.ndim))).sum()
