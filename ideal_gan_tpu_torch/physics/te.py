"""Echo-time (TE) train generation (port of `ideal_gan_tpu/physics/te.py`).

TE arrays are (batch, n_echoes, 1) float32 tensors. The randomized train
takes a `torch.Generator` where the JAX package takes a key: the draws
differ, the distribution is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import DTE_1p5T, DTE_3T, TE1_1p5T, TE1_3T


def te_train(n_ech: int, bs: int = 1, te1: float = TE1_1p5T,
             dte: float = DTE_1p5T, device="cpu") -> torch.Tensor:
    """Deterministic uniformly-spaced TE train, shape (bs, n_ech, 1)."""
    te = te1 + dte * np.arange(n_ech, dtype=np.float32)
    te = torch.as_tensor(te, dtype=torch.float32, device=device)[None, :, None]
    return te.expand(bs, n_ech, 1).contiguous()


def te_train_for_field(n_ech: int, bs: int = 1, field: float = 1.5,
                       device="cpu") -> torch.Tensor:
    """The reference protocol TE train for a field strength (1.5 T or 3 T)."""
    if float(field) == 3.0:
        return te_train(n_ech, bs, TE1_3T, DTE_3T, device)
    return te_train(n_ech, bs, TE1_1p5T, DTE_1p5T, device)


def sample_te_train(generator: torch.Generator, n_ech: int, bs: int = 1,
                    te1_min: float = 1.0e-3, te1_d: float = 1.4e-3,
                    dte_min: float = 1.6e-3, dte_d: float = 1.0e-3,
                    dte_jitter: float = 1e-4, device="cpu") -> torch.Tensor:
    """Randomized TE train of the reference distribution: TE1 ~ U(te1_min,
    te1_min + te1_d); a common spacing dTE_c ~ U(dte_min, dte_min + dte_d);
    per-echo spacings dTE_n ~ N(dTE_c, dte_jitter²). The same train is
    tiled across the batch. Drawn on the CPU from `generator`; returns
    (bs, n_ech, 1) float32 on `device`."""
    u = torch.rand(2, generator=generator, dtype=torch.float64)
    te1 = te1_min + u[0] * te1_d
    dte_c = dte_min + u[1] * dte_d
    dte = dte_c + dte_jitter * torch.randn(n_ech - 1, generator=generator,
                                           dtype=torch.float64)
    te = te1 + torch.cat([torch.zeros(1, dtype=torch.float64),
                          torch.cumsum(dte, 0)])
    te = te.float()[None, :, None].expand(bs, n_ech, 1)
    return te.contiguous().to(device)
