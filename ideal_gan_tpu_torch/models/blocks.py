"""Shared CNN building blocks (port of `ideal_gan_tpu/models/blocks.py`).

Activations are NCHW inside the models. Norm order follows the reference:
conv → activation → norm. Only instance norm is ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def get_activation(name):
    if callable(name):
        return name
    return {
        "relu": F.relu,
        # the reference reaches leaky_relu through tf.nn.leaky_relu, whose
        # default slope is 0.2
        "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        "none": lambda x: x,
        None: lambda x: x,
    }[name]


class Norm(nn.GroupNorm):
    """Instance norm as one group per channel, ε = 1e-3 (the keras value the
    JAX package matches)."""

    def __init__(self, channels: int, kind: str = "instance_norm",
                 epsilon: float = 1e-3):
        if kind != "instance_norm":
            raise NotImplementedError(
                f"Norm {kind!r} is not ported yet (ROADMAP Queue 1)")
        super().__init__(channels, channels, eps=epsilon)


class ConvBlock(nn.Module):
    """Two 3×3 convs, each followed by the activation and the norm."""

    def __init__(self, in_channels: int, filters: int,
                 activation: str = "relu", norm: str = "instance_norm"):
        super().__init__()
        self.act = get_activation(activation)
        self.conv1 = nn.Conv2d(in_channels, filters, 3, padding=1, bias=False)
        self.norm1 = Norm(filters, norm)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.norm2 = Norm(filters, norm)

    def forward(self, x):
        x = self.norm1(self.act(self.conv1(x)))
        return self.norm2(self.act(self.conv2(x)))


class Upsample(nn.Module):
    """2× upsample by a 2×2 stride-2 transpose convolution."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_channels, filters, 2, stride=2)

    def forward(self, x):
        return self.conv(x)


def he_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    return nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_in),
                           generator=generator)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialization of a model, in the families the JAX
    package uses: He-normal convolutions, Glorot for the 1×1 heads and
    attention projections, orthogonal recurrent kernels, zero biases, unit
    norm scales and γ = 0. A submodule with its own `init_params` method
    initializes its whole subtree itself."""
    for m in module.children():
        if hasattr(m, "init_params"):
            m.init_params(generator)
            continue
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel() if isinstance(m, nn.Conv2d) \
                else m.weight.shape[0] * m.weight[0, 0].numel()
            if m.kernel_size == (1, 1):
                nn.init.xavier_normal_(m.weight, generator=generator)
            else:
                he_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        init_params(m, generator)
