"""Echo-time (TE) train generation (port of `ideal_gan_tpu/physics/te.py`).

TE arrays are (batch, n_echoes, 1) float32 tensors. The randomized train
(`sample_te_train`) is not ported yet.
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
