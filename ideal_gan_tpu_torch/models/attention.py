"""SAGAN self-attention and AdaIN conditioning (port of
`ideal_gan_tpu/models/attention.py`).

Plain `torch.matmul`/`softmax`, as the JAX package computes it with einsum
outside any kernel. With a compute `dtype` the attention's projections,
products and softmax run in it, and γ (float32) promotes the residual sum
to float32, as in the JAX package; AdaIN follows its inputs' dtypes, so a
bf16 content normalized in bf16 meets the float32 style's √var and mean
and comes out float32, as jnp's promotion gives.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import dtype_conv


class SelfAttention(nn.Module):
    """f/g (C/8) and h (C) 1×1 convs, attention softmax(g·fᵀ) over the
    flattened spatial tokens with no 1/√d scale, learnable scalar γ
    initialized to 0, residual output. NCHW in and out."""

    def __init__(self, channels: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        cf = max(channels // 8, 1)
        self.f = nn.Conv2d(channels, cf, 1, bias=False)
        self.g = nn.Conv2d(channels, cf, 1, bias=False)
        self.h = nn.Conv2d(channels, channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, c, h, w = x.shape
        fm = dtype_conv(self.f, x, self.dtype).flatten(2)  # (b, cf, N)
        gm = dtype_conv(self.g, x, self.dtype).flatten(2).transpose(1, 2)
        hm = dtype_conv(self.h, x, self.dtype).flatten(2).transpose(1, 2)
        beta = torch.softmax(torch.matmul(gm, fm), dim=-1)  # (b, N, N)
        o = torch.matmul(beta, hm).transpose(1, 2).reshape(b, c, h, w)
        return self.gamma * o + x

    def init_params(self, generator: torch.Generator) -> None:
        for conv in (self.f, self.g, self.h):
            nn.init.xavier_uniform_(conv.weight, generator=generator)
        nn.init.zeros_(self.gamma)


def adain(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """Adaptive instance normalization with the reference's statistics
    (its α = 1, ε = 1e-5): content (nb, C, H, W) normalized by its
    per-channel (H, W) moments, then scaled and shifted by the *scalar*
    per-sample moments of the style vector (nb, S). Both variances are
    biased (ddof 0), as `jnp.var`."""
    s_mean = style.mean(dim=1)[:, None, None, None]
    s_var = style.var(dim=1, unbiased=False)[:, None, None, None]
    c_mean = content.mean(dim=(2, 3), keepdim=True)
    c_var = content.var(dim=(2, 3), unbiased=False, keepdim=True)
    normalized = (content - c_mean) / torch.sqrt(c_var + 1e-5)
    return normalized * torch.sqrt(s_var) + s_mean
