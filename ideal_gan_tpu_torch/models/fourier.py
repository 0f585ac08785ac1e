"""Fourier-domain view of complex images (port of
`ideal_gan_tpu/models/fourier.py`): the 2-D FFT of the (re, im) channels,
fftshifted, with a multi-echo (nb, ne, H, W, 2) tensor folded into the
batch and unfolded again. No parameters."""

from __future__ import annotations

import torch


def fourier_layer(x: torch.Tensor, multi_echo: bool = True) -> torch.Tensor:
    ini_shape = x.shape
    if multi_echo and x.ndim == 5:
        x = x.reshape((-1,) + tuple(x.shape[2:]))
    z = torch.complex(x[..., 0], x[..., 1])
    zf = torch.fft.fftshift(torch.fft.fft2(z, dim=(1, 2)), dim=(1, 2))
    out = torch.stack([zf.real, zf.imag], dim=-1).to(x.dtype)
    if multi_echo and len(ini_shape) == 5:
        out = out.reshape(ini_shape)
    return out
