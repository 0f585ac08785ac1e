"""Training-time augmentation (port of `ideal_gan_tpu/data/augment.py`'s
`random_geometric` and `random_echo_count`). A `torch.Generator` takes the
place of a JAX key: the draws differ from the JAX package's, the
distribution is the same."""

from __future__ import annotations

import numpy as np
import torch


def random_geometric(generator: torch.Generator,
                     x: torch.Tensor) -> torch.Tensor:
    """Random 90° rotation (k ∈ {0, 1, 2}), then horizontal and vertical
    flips each with probability 1/2, over the spatial axes (2, 3) of a
    MEBCRN tensor (nb, k, H, W, c) with square images. Returns a
    contiguous tensor."""
    k = int(torch.randint(0, 3, (), generator=generator))
    flip_lr, flip_ud = (torch.rand(2, generator=generator) < 0.5).tolist()
    x = torch.rot90(x, k, dims=(2, 3))
    if flip_lr:
        x = torch.flip(x, dims=(3,))
    if flip_ud:
        x = torch.flip(x, dims=(2,))
    return x.contiguous()


def random_echo_count(rng: np.random.Generator, lo: int = 3,
                      hi: int = 7) -> int:
    """Host-side random echo count in [lo, hi) (shape-changing)."""
    return int(rng.integers(lo, hi))
