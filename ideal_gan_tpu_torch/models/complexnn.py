"""Complex-valued network layers and the complex U-Net `PMComplex` (port of
`ideal_gan_tpu/models/complexnn.py`).

Values are torch complex64 tensors, NCHW inside the modules; `PMComplex`
takes and returns complex64 channels-last (nb, H, W, C), as the JAX module
does. A complex convolution is two real convolutions on the real and the
imaginary planes, `w_real` (R) and `w_imag` (I), combined as (RR − II,
RI + IR), "SAME" padded as Flax's.

Activations: `crelu`, `zrelu`, `modrelu` (|z| floored at 1e-7 in the
division), `cardioid` (with angle(0) = 0). The complex batch norm
(Trabelsi et al.) whitens (re, im) jointly by the closed-form inverse
square root of their 2×2 covariance, then applies the complex affine
(Γ, β); its running statistics (momentum 0.9, ε 1e-4, variances starting at
1/√2) move in every train-mode call (Flax skips that move only in `init`,
which the port has no counterpart of).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import he_normal_, same_conv2d

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def crelu(z: torch.Tensor) -> torch.Tensor:
    """relu of the real and of the imaginary part."""
    return torch.complex(F.relu(z.real), F.relu(z.imag))


def zrelu(z: torch.Tensor) -> torch.Tensor:
    """z where its phase is in [0, π/2] (both parts ≥ 0), else 0."""
    keep = (z.real >= 0) & (z.imag >= 0)
    return torch.where(keep, z, torch.zeros_like(z))


def modrelu(z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(|z| + b)·z/|z|, with |z| floored at 1e-7 in the division;
    `bias` broadcasts against z (per channel: (C, 1, 1) for NCHW)."""
    mag = torch.abs(z)
    scale = F.relu(mag + bias) / torch.clamp(mag, min=1e-7)
    return z * scale


def cardioid(z: torch.Tensor) -> torch.Tensor:
    """½·(1 + cos ∠z)·z, with ∠0 = 0."""
    return 0.5 * (1.0 + torch.cos(torch.angle(z))) * z


_ACTS = {"crelu": crelu, "zrelu": zrelu, "cardioid": cardioid,
         None: lambda z: z, "none": lambda z: z}


def _planes(z: torch.Tensor):
    return z.real.contiguous(), z.imag.contiguous()


class ComplexConv(nn.Module):
    """Complex 2-D convolution (R + iI) * (x_r + i·x_i) with the optional
    complex bias (`bias_real`, `bias_imag`) and `activation` ("modrelu" with
    its per-channel `modrelu_bias`). NCHW complex in and out."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 strides: int = 1, activation: str | None = "crelu",
                 use_bias: bool = True):
        super().__init__()
        kh, kw = kernel_size
        self.strides = strides
        self.activation = activation
        self.w_real = nn.Parameter(torch.empty(features, in_channels, kh, kw))
        self.w_imag = nn.Parameter(torch.empty(features, in_channels, kh, kw))
        if use_bias:
            self.bias_real = nn.Parameter(torch.zeros(features))
            self.bias_imag = nn.Parameter(torch.zeros(features))
        else:
            self.bias_real = self.bias_imag = None
        self.modrelu_bias = nn.Parameter(torch.zeros(features)) \
            if activation == "modrelu" else None

    def forward(self, z):
        xr, xi = _planes(z)

        def conv(x, w):
            return same_conv2d(x, w, None, self.strides)

        out_r = conv(xr, self.w_real) - conv(xi, self.w_imag)
        out_i = conv(xr, self.w_imag) + conv(xi, self.w_real)
        if self.bias_real is not None:
            out_r = out_r + self.bias_real[:, None, None]
            out_i = out_i + self.bias_imag[:, None, None]
        out = torch.complex(out_r, out_i)
        if self.activation == "modrelu":
            return modrelu(out, self.modrelu_bias[:, None, None])
        return _ACTS[self.activation](out)

    def init_params(self, generator: torch.Generator) -> None:
        """He-normal planes, zero biases."""
        with torch.no_grad():
            for w in (self.w_real, self.w_imag):
                he_normal_(w, w[0].numel(), generator)
            for b in (self.bias_real, self.bias_imag, self.modrelu_bias):
                if b is not None:
                    b.zero_()


class ComplexConvTranspose(nn.Module):
    """Complex 2×2 stride-2 transpose convolution: two real transpose
    convolutions with their biases, combined as (R(x_r) − I(x_i)) +
    i·(I(x_r) + R(x_i)), as the JAX module combines them. NCHW complex in
    and out."""

    def __init__(self, in_channels: int, features: int, kernel_size=(2, 2),
                 strides=(2, 2)):
        super().__init__()
        self.w_real = nn.ConvTranspose2d(in_channels, features, kernel_size,
                                         stride=strides)
        self.w_imag = nn.ConvTranspose2d(in_channels, features, kernel_size,
                                         stride=strides)

    def forward(self, z):
        xr, xi = _planes(z)
        return torch.complex(self.w_real(xr) - self.w_imag(xi),
                             self.w_imag(xr) + self.w_real(xi))

    def init_params(self, generator: torch.Generator) -> None:
        """LeCun-normal kernels (Flax's default, fan-in of its (kh, kw,
        Cin) kernel), zero biases."""
        with torch.no_grad():
            for conv in (self.w_real, self.w_imag):
                w = conv.weight  # (Cin, Cout, kh, kw)
                fan_in = w.shape[0] * w[0, 0].numel()
                nn.init.normal_(w, 0.0, fan_in ** -0.5, generator=generator)
                conv.bias.zero_()


def complex_max_pool_2x2(z: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max pooling on |z| over NCHW complex, carrying the
    winner's complex value. A window's four values are taken in the JAX
    function's order, (dx, dy): down its first column, then down its
    second; the first of equal maxima wins (as `jnp.argmax`)."""
    b, c, h, w = z.shape
    win = z.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 5, 3)
    win = win.reshape(b, c, h // 2, w // 2, 4)
    idx = torch.argmax(torch.abs(win), dim=-1, keepdim=True)
    re, im = _planes(win)
    return torch.complex(torch.gather(re, -1, idx),
                         torch.gather(im, -1, idx))[..., 0]


class ComplexBatchNorm(nn.Module):
    """Trabelsi-style complex batch normalization over NCHW complex (module
    docstring): buffers `mean_r`, `mean_i`, `vrr`, `vii`, `vri`; parameters
    `gamma_rr`, `gamma_ii` (1/√2), `gamma_ri`, `beta_r`, `beta_i` (0)."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 epsilon: float = 1e-4):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        for name in ("mean_r", "mean_i", "vri"):
            self.register_buffer(name, torch.zeros(channels))
        for name in ("vrr", "vii"):
            self.register_buffer(name, torch.full((channels,), _INV_SQRT2))
        self.gamma_rr = nn.Parameter(torch.full((channels,), _INV_SQRT2))
        self.gamma_ii = nn.Parameter(torch.full((channels,), _INV_SQRT2))
        self.gamma_ri = nn.Parameter(torch.zeros(channels))
        self.beta_r = nn.Parameter(torch.zeros(channels))
        self.beta_i = nn.Parameter(torch.zeros(channels))

    def forward(self, z, train: bool = True):
        xr, xi = _planes(z)
        red = (0, 2, 3)

        def col(v):
            return v[:, None, None]

        if train:
            mu_r, mu_i = xr.mean(dim=red), xi.mean(dim=red)
            cr, ci = xr - col(mu_r), xi - col(mu_i)
            vrr = torch.mean(cr * cr, dim=red) + self.epsilon
            vii = torch.mean(ci * ci, dim=red) + self.epsilon
            vri = torch.mean(cr * ci, dim=red)
            with torch.no_grad():
                m = self.momentum
                for buf, batch in ((self.mean_r, mu_r), (self.mean_i, mu_i),
                                   (self.vrr, vrr), (self.vii, vii),
                                   (self.vri, vri)):
                    buf.mul_(m).add_((1.0 - m) * batch)
        else:
            cr, ci = xr - col(self.mean_r), xi - col(self.mean_i)
            vrr, vii, vri = self.vrr, self.vii, self.vri
        # inverse square root of [[vrr, vri], [vri, vii]] in closed form
        tau = vrr + vii
        s = torch.sqrt(vrr * vii - vri * vri)
        t = torch.sqrt(tau + 2.0 * s)
        inv_st = 1.0 / (s * t)
        wrr, wii, wri = col((vii + s) * inv_st), col((vrr + s) * inv_st), \
            col(-vri * inv_st)
        nr = wrr * cr + wri * ci
        ni = wri * cr + wii * ci
        g_rr, g_ii, g_ri = col(self.gamma_rr), col(self.gamma_ii), \
            col(self.gamma_ri)
        return torch.complex(g_rr * nr + g_ri * ni + col(self.beta_r),
                             g_ri * nr + g_ii * ni + col(self.beta_i))

    def init_params(self, generator: torch.Generator) -> None:
        """Flax's initial values: Γ = diag(1/√2), β = 0, running means and
        vri 0, running variances 1/√2."""
        with torch.no_grad():
            for v in (self.gamma_rr, self.gamma_ii, self.vrr, self.vii):
                v.fill_(_INV_SQRT2)
            for v in (self.gamma_ri, self.beta_r, self.beta_i, self.mean_r,
                      self.mean_i, self.vri):
                v.zero_()


class _ComplexBlock(nn.Module):
    """Two [3×3 complex conv without bias, crelu, complex batch norm]."""

    def __init__(self, in_channels: int, filters: int):
        super().__init__()
        self.conv1 = ComplexConv(in_channels, filters, use_bias=False)
        self.norm1 = ComplexBatchNorm(filters)
        self.conv2 = ComplexConv(filters, filters, use_bias=False)
        self.norm2 = ComplexBatchNorm(filters)

    def forward(self, z, train: bool):
        z = self.norm1(self.conv1(z), train)
        return self.norm2(self.conv2(z), train)


class PMComplex(nn.Module):
    """The fully complex U-Net: `num_layers` levels of a complex block and
    a complex max-pool (the width doubling from `filters`), a bottom block,
    then per level a complex transpose conv (halving the width), the skip
    concatenated and a block; a 1×1 complex conv to one channel with bias
    and the cardioid. (nb, H, W, in_channels) complex64 → (nb, H, W, 1)
    complex64; H and W multiples of 2^num_layers."""

    def __init__(self, in_channels: int, filters: int = 72,
                 num_layers: int = 4):
        super().__init__()
        self.down = nn.ModuleList()
        cin, f = in_channels, filters
        for _ in range(num_layers):
            self.down.append(_ComplexBlock(cin, f))
            cin, f = f, f * 2
        self.bottom = _ComplexBlock(cin, f)
        self.up = nn.ModuleList()
        self.dec = nn.ModuleList()
        for _ in range(num_layers):
            self.up.append(ComplexConvTranspose(f, f // 2))
            self.dec.append(_ComplexBlock(f, f // 2))
            f //= 2
        self.head = ComplexConv(f, 1, (1, 1), activation="cardioid")

    def forward(self, z, train: bool = True):
        z = z.permute(0, 3, 1, 2)
        skips = []
        for block in self.down:
            z = block(z, train)
            skips.append(z)
            z = complex_max_pool_2x2(z)
        z = self.bottom(z, train)
        for up, block, skip in zip(self.up, self.dec, reversed(skips)):
            z = block(torch.cat([up(z), skip], dim=1), train)
        return self.head(z).permute(0, 2, 3, 1)

    def init_params(self, generator: torch.Generator) -> None:
        """Flax's initializers (module by module, `init_params` of each)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_params"):
                m.init_params(generator)
