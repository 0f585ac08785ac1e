"""Shared CNN building blocks (port of `ideal_gan_tpu/models/blocks.py`).

Activations are NCHW inside the models. Norm order follows the reference:
conv → activation → norm. Only instance norm is ported.

`SameConv2d` pads as Flax's "SAME" does (XLA's rule: the total padding
max((ceil(n/s) − 1)·s + k − n, 0) split with the smaller half first), which
`nn.Conv2d(padding=k//2)` gets wrong for even kernels and for stride-2
convolutions at even sizes: 2×2 stride 1 pads (0, 1), 3×3 stride 2 (0, 1),
4×4 stride 2 (1, 1), 4×4 stride 1 (1, 2).

A compute `dtype` is Flax's `dtype` field: a block given one casts its input,
kernel and bias to it at use (`dtype_conv`), while its parameters keep
theirs (float32); `None` computes in the parameters' dtype. Norms reduce in
float32 and return the compute dtype, as Flax's GroupNorm does. The
TEEncoder has no compute dtype: the JAX package's runs in float32 always.
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
        # default slope is 0.2; written as Flax's where(x >= 0, ...) so that
        # the derivative at 0 is 1 as in the JAX package (F.leaky_relu's is
        # the slope)
        "leaky_relu": lambda x: torch.where(x >= 0, x, 0.2 * x),
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        "none": lambda x: x,
        None: lambda x: x,
    }[name]


def dtype_conv(conv: nn.Module, x: torch.Tensor, dtype=None):
    """`conv(x)` (an `nn.Conv2d` or a stride-2 `nn.ConvTranspose2d`)
    computed in `dtype`: x, the kernel and the bias cast at use, the
    parameters left as they are; `None` is `conv(x)`."""
    if dtype is None:
        return conv(x)
    w = conv.weight.to(dtype)
    b = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x.to(dtype), w, b, conv.stride)
    return conv._conv_forward(x.to(dtype), w, b)


class Norm(nn.GroupNorm):
    """Instance norm as one group per channel, ε = 1e-3 (the keras value the
    JAX package matches). With a compute `dtype` the statistics and the
    affine map run in float32 and the result is cast to `dtype`."""

    def __init__(self, channels: int, kind: str = "instance_norm",
                 epsilon: float = 1e-3, dtype=None):
        if kind != "instance_norm":
            raise NotImplementedError(
                f"Norm {kind!r} is not ported yet (ROADMAP Queue 1)")
        super().__init__(channels, channels, eps=epsilon)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype is None:
            return super().forward(x)
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(self.dtype)


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of one spatial axis under XLA's "SAME"."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """`nn.Conv2d` with Flax's "SAME" padding (module docstring): a
    symmetric padding is passed to the convolution, an asymmetric one is
    applied with `F.pad` first."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, bias=bias)

    def _conv_forward(self, x, weight, bias):
        (t, b), (l, r) = (same_padding(n, k, s) for n, k, s in zip(
            x.shape[-2:], self.kernel_size, self.stride))
        if t == b and l == r:
            return F.conv2d(x, weight, bias, self.stride, (t, l))
        return F.conv2d(F.pad(x, (l, r, t, b)), weight, bias, self.stride)


class ConvBlock(nn.Module):
    """Two 3×3 convs, each followed by the activation and the norm."""

    def __init__(self, in_channels: int, filters: int,
                 activation: str = "relu", norm: str = "instance_norm",
                 dtype=None):
        super().__init__()
        self.act = get_activation(activation)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, filters, 3, padding=1, bias=False)
        self.norm1 = Norm(filters, norm, dtype=dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.norm2 = Norm(filters, norm, dtype=dtype)

    def forward(self, x):
        x = self.norm1(self.act(dtype_conv(self.conv1, x, self.dtype)))
        return self.norm2(self.act(dtype_conv(self.conv2, x, self.dtype)))


class ResidualBlock(nn.Module):
    """conv → norm → leaky_relu → conv → norm, plus the input (3×3
    convolutions without bias; the JAX block's `groups` and `bayes` have no
    caller on a ported path)."""

    def __init__(self, channels: int, norm: str = "instance_norm",
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.norm1 = Norm(channels, norm, dtype=dtype)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False)
        self.norm2 = Norm(channels, norm, dtype=dtype)

    def forward(self, x):
        h = self.norm1(dtype_conv(self.conv1, x, self.dtype))
        h = get_activation("leaky_relu")(h)
        h = self.norm2(dtype_conv(self.conv2, h, self.dtype))
        return x.to(h.dtype) + h


class Upsample(nn.Module):
    """2× upsample: a 2×2 stride-2 transpose convolution
    ("conv_transpose"), or nearest-neighbour ×2 then a 2×2 "SAME"
    convolution ("interpol_conv")."""

    def __init__(self, in_channels: int, filters: int,
                 method: str = "conv_transpose", dtype=None):
        super().__init__()
        self.dtype = dtype
        self.method = method
        if method == "conv_transpose":
            self.conv = nn.ConvTranspose2d(in_channels, filters, 2, stride=2)
        elif method == "interpol_conv":
            self.conv = SameConv2d(in_channels, filters, 2)
        else:
            raise ValueError(f"unknown upsample method {method!r}")

    def forward(self, x):
        if self.method == "interpol_conv":
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        return dtype_conv(self.conv, x, self.dtype)


class TEEncoder(nn.Module):
    """TE-vector conditioning: an LSTM of `lstm_features` over the echo axis
    (one TE a step, zero initial state), then Dense(filters) and ReLU on
    its last output: the style input of the AdaIN conditioning.

    `torch.nn.LSTM` has Flax's `OptimizedLSTMCell` gates in the same order
    (i, f, g, o; sigmoid gates, tanh cell); Flax's input kernels carry no
    bias, so `lstm.bias_ih_l0` stays 0 and the recurrent bias is
    `lstm.bias_hh_l0`."""

    def __init__(self, filters: int, lstm_features: int = 6):
        super().__init__()
        self.lstm = nn.LSTM(1, lstm_features, batch_first=True)
        self.lstm.bias_ih_l0.requires_grad_(False)  # no such Flax parameter
        self.dense = nn.Linear(lstm_features, filters)

    def forward(self, te):
        """te (nb, ne) or (nb, ne, 1) → (nb, filters)."""
        if te.ndim == 2:
            te = te[..., None]
        y, _ = self.lstm(te.to(self.dense.weight.dtype))
        return F.relu(self.dense(y[:, -1]))

    def init_params(self, generator: torch.Generator) -> None:
        """Flax's initializers: LeCun-normal input kernels, orthogonal
        recurrent kernels, zero biases, He-uniform Dense kernel."""
        n = self.lstm.hidden_size
        with torch.no_grad():
            nn.init.normal_(self.lstm.weight_ih_l0, 0.0, 1.0,
                            generator=generator)  # fan_in 1
            for g in range(4):
                nn.init.orthogonal_(self.lstm.weight_hh_l0[g * n:(g + 1) * n],
                                    generator=generator)
            nn.init.zeros_(self.lstm.bias_ih_l0)
            nn.init.zeros_(self.lstm.bias_hh_l0)
            bound = math.sqrt(6.0 / self.dense.in_features)
            nn.init.uniform_(self.dense.weight, -bound, bound,
                             generator=generator)
            nn.init.zeros_(self.dense.bias)


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
