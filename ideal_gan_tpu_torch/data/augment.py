"""Training-time augmentation (port of `ideal_gan_tpu/data/augment.py`'s
`random_geometric`, `random_fm_scale`, `bipolar_phase_row`,
`random_echo_count` and `random_phase_offset`). A `torch.Generator` takes the place of a JAX key: the
draws differ from the JAX package's, the distribution is the same.

The tensor augmentations a trainer's loop body applies to its host batch
each run inside the profiler range `AUGMENT_RANGE`."""

from __future__ import annotations

import numpy as np
import torch

# the profiler range around each tensor augmentation of a batch
AUGMENT_RANGE = "batch augment"


@torch.profiler.record_function(AUGMENT_RANGE)
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


@torch.profiler.record_function(AUGMENT_RANGE)
def random_fm_scale(generator: torch.Generator, maps: torch.Tensor,
                    mean: float) -> torch.Tensor:
    """Scale the field-map channel (row 2, channel 0 of MEBCRN maps (nb, k,
    H, W, 2)) by one random N(mean, 0.25²) factor. Returns a new tensor."""
    scale = mean + 0.25 * float(torch.randn((), generator=generator))
    out = maps.clone()
    out[:, 2, ..., 0] *= scale
    return out


@torch.profiler.record_function(AUGMENT_RANGE)
def bipolar_phase_row(generator: torch.Generator,
                      maps: torch.Tensor) -> torch.Tensor:
    """Append a synthetic bipolar-gradient phase row to MEBCRN maps (nb, k,
    H, W, 2): a horizontal linear ramp x·U(0.1, 0.5) + U(0, 0.01) over
    x ∈ [-1, 1], zero where the field map is zero, imaginary part 0."""
    x_lim, x_off = torch.rand(2, generator=generator).tolist()
    x_lim, x_off = 0.1 + 0.4 * x_lim, 0.01 * x_off
    wdt = maps.shape[3]
    ramp = torch.linspace(-1.0, 1.0, wdt, dtype=maps.dtype,
                          device=maps.device) * x_lim + x_off
    fm = maps[:, 2:3, ..., 0:1]
    bp = torch.where(fm != 0.0, ramp[None, None, None, :, None],
                     torch.zeros_like(fm))
    row = torch.cat([bp, torch.zeros_like(bp)], dim=-1)
    return torch.cat([maps, row], dim=1)


def random_echo_count(rng: np.random.Generator, lo: int = 3,
                      hi: int = 7) -> int:
    """Host-side random echo count in [lo, hi) (shape-changing)."""
    return int(rng.integers(lo, hi))


@torch.profiler.record_function(AUGMENT_RANGE)
def random_phase_offset(generator: torch.Generator | None, acqs: torch.Tensor,
                        maps: torch.Tensor, unwrapped: bool = False,
                        offset: float | None = None):
    """A global phase offset U(−π/2, π/2) on the acquisitions (nb, ne, H,
    W, 2) and on the mag/phase map rows (nb, 3, H, W, 2), with the JAX
    package's indexing of the reference: rows 1 and 2 both become (φ, φ)
    with φ = row-1 channel 1 + offset/π, wrapped into [−π, π] unless
    `unwrapped`. `offset` (a float) is taken instead of a draw from
    `generator`. Returns (acqs, maps)."""
    if offset is None:
        offset = float((torch.rand((), generator=generator) - 0.5) * np.pi)
    mag = torch.sqrt(torch.sum(torch.square(acqs), dim=-1, keepdim=True))
    pha = torch.atan2(acqs[..., 1:], acqs[..., :1])
    acqs = torch.cat([mag * torch.cos(pha + offset),
                      mag * torch.sin(pha + offset)], dim=-1)
    b_pha = maps[:, 1:, :, :, 1:2] + offset / np.pi
    if not unwrapped:
        b_pha = torch.where(b_pha < -np.pi, b_pha + 2 * np.pi, b_pha)
        b_pha = torch.where(b_pha > np.pi, b_pha - 2 * np.pi, b_pha)
    out_pha = torch.cat([b_pha, b_pha, maps[:, 1:, :, :, 2:]], dim=-1)
    return acqs, torch.cat([maps[:, :1], out_pha], dim=1)
