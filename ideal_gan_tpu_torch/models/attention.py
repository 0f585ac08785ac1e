"""SAGAN self-attention (port of `ideal_gan_tpu/models/attention.py`).

Plain `torch.matmul`/`softmax`, as the JAX package computes it with einsum
outside any kernel. AdaIN conditioning is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class SelfAttention(nn.Module):
    """f/g (C/8) and h (C) 1×1 convs, attention softmax(g·fᵀ) over the
    flattened spatial tokens with no 1/√d scale, learnable scalar γ
    initialized to 0, residual output. NCHW in and out."""

    def __init__(self, channels: int):
        super().__init__()
        cf = max(channels // 8, 1)
        self.f = nn.Conv2d(channels, cf, 1, bias=False)
        self.g = nn.Conv2d(channels, cf, 1, bias=False)
        self.h = nn.Conv2d(channels, channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, c, h, w = x.shape
        fm = self.f(x).flatten(2)                   # (b, cf, N)
        gm = self.g(x).flatten(2).transpose(1, 2)   # (b, N, cf)
        hm = self.h(x).flatten(2).transpose(1, 2)   # (b, N, c)
        beta = torch.softmax(torch.matmul(gm, fm), dim=-1)  # (b, N, N)
        o = torch.matmul(beta, hm).transpose(1, 2).reshape(b, c, h, w)
        return self.gamma * o + x

    def init_params(self, generator: torch.Generator) -> None:
        for conv in (self.f, self.g, self.h):
            nn.init.xavier_uniform_(conv.weight, generator=generator)
        nn.init.zeros_(self.gamma)
