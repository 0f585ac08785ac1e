"""MEBCRN ↔ legacy layout converters (port of `ideal_gan_tpu/data/layouts.py`
on torch tensors).

The framework's canonical tensor layout is MEBCRN — acquisitions
(batch, n_echoes, H, W, 2[re, im]) and maps (batch, n_maps, H, W, 2) — with
map rows [water, fat, (field-map, R2*)]. The legacy 4-D channel-interleaved
layout (batch, H, W, 2·ne) survives in older models; these converters keep
parity with the reference (data.py:262-329). Each runs on the device of its
input and is differentiable.
"""

from __future__ import annotations

import numpy as np
import torch


def acqs_from_mebcrn(a: torch.Tensor) -> torch.Tensor:
    """(nb, ne, H, W, 2) → legacy (nb, H, W, 2·ne) with channels
    interleaved [re1, im1, re2, im2, ...] (reference `A_from_MEBCRN`)."""
    nb, ne, hgt, wdt, _ = a.shape
    return torch.movedim(a, 1, 3).reshape(nb, hgt, wdt, 2 * ne)


def acqs_to_mebcrn(a: torch.Tensor) -> torch.Tensor:
    """Legacy (nb, H, W, 2·ne) interleaved → (nb, ne, H, W, 2)."""
    nb, hgt, wdt, ch = a.shape
    return torch.movedim(a.reshape(nb, hgt, wdt, ch // 2, 2), 3, 1)


def maps_from_mebcrn(b: torch.Tensor, mag_and_phase: bool = False,
                     c_pha: float = 3.0) -> torch.Tensor:
    """MEBCRN maps → legacy (nb, H, W, 6) = [Wr, Wi, Fr, Fi, R2*, FM]
    (reference `B_from_MEBCRN`).

    With `mag_and_phase`, rows are the [(FF,·),(PD,R2*),(pha,FM)]
    parameterization and water/fat are rebuilt from magnitude and the
    common phase scaled by c_pha·π (the reference's indexing, kept as is).
    """
    if mag_and_phase:
        pha = c_pha * b[:, 1, :, :, 1:2] * np.pi
        w_r = b[:, 0, :, :, :1] * torch.cos(pha)
        w_i = b[:, 0, :, :, :1] * torch.sin(pha)
        f_r = b[:, 0, :, :, 1:2] * torch.cos(pha)
        f_i = b[:, 0, :, :, 1:2] * torch.sin(pha)
        r2 = b[:, 0, :, :, 2:]
        fm = b[:, 1, :, :, 2:]
        return torch.cat([w_r, w_i, f_r, f_i, r2, fm], dim=-1)
    pm = b[:, 2]
    return torch.cat([b[:, 0], b[:, 1], pm[..., 1:], pm[..., :1]], dim=-1)


def maps_to_mebcrn(b: torch.Tensor, mode: str = "All") -> torch.Tensor:
    """Legacy maps → MEBCRN (reference `B_to_MEBCRN`).

    mode 'WF':    (nb,H,W,2)=[|W|,|F|] → (nb,2,H,W,2) with zero imag.
    mode 'PM':    (nb,H,W,2)=[R2*,FM] → (nb,1,H,W,2)=(FM,R2*).
    mode 'WF-PM': (nb,H,W,4)=[|W|,|F|,R2*,FM] → (nb,3,H,W,2).
    mode 'All':   (nb,H,W,6)=[Wr,Wi,Fr,Fi,R2*,FM] → (nb,3,H,W,2).
    """
    def real_row(x):  # (nb, H, W, 1) → (nb, 1, H, W, 2) with zero imag
        return torch.cat([x, torch.zeros_like(x)], -1)[:, None]

    if mode == "WF":
        return torch.cat([real_row(b[..., :1]), real_row(b[..., 1:])], dim=1)
    if mode == "PM":
        return torch.cat([b[..., 1:], b[..., :1]], dim=-1)[:, None]
    if mode == "WF-PM":
        pm = torch.cat([b[..., 3:], b[..., 2:3]], -1)[:, None]
        return torch.cat([real_row(b[..., :1]), real_row(b[..., 1:2]), pm],
                         dim=1)
    if mode == "All":
        pm = torch.cat([b[..., 5:], b[..., 4:5]], -1)[:, None]
        return torch.cat([b[..., :2][:, None], b[..., 2:4][:, None], pm],
                         dim=1)
    raise ValueError(f"unknown mode {mode!r}")


def mag_phase_to_complex_mebcrn(b: torch.Tensor) -> torch.Tensor:
    """Mag/phase MEBCRN rows [(FF,0),(PD,R2*),(pha,FM)] → complex rows
    [water, fat, (FM, R2*)] — inverse of the loader's mag_and_phase
    derivation with the 4π phase convention."""
    ff = b[:, 0, ..., 0]
    pd = b[:, 1, ..., 0]
    r2s = b[:, 1, ..., 1]
    pha = b[:, 2, ..., 0] * 4.0 * np.pi
    fm = b[:, 2, ..., 1]
    water = (1.0 - ff) * pd
    fat = ff * pd
    w_row = torch.stack([water * torch.cos(pha), water * torch.sin(pha)], -1)
    f_row = torch.stack([fat * torch.cos(pha), fat * torch.sin(pha)], -1)
    pm_row = torch.stack([fm, r2s], -1)
    return torch.stack([w_row, f_row, pm_row], dim=1)
