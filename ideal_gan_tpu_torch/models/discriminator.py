"""The discriminators (port of `ideal_gan_tpu/models/discriminator.py`):
the spectral-norm PatchGAN, the latent critic `CriticZ` and the SGAN
feature extractor / residual generator.

Spectral normalization follows Flax's `nn.SpectralNorm`, not
`torch.nn.utils.spectral_norm`, which differs in three ways (it skips the
power step in eval mode, lays the weight out (out, in·kh·kw) and
normalizes by max(‖x‖, ε)). Here, as in Flax:

- the kernel is taken as the (kh·kw·in, out) matrix W of its HWIO layout,
  and the power-iteration vector u is (1, out);
- one power step runs on every call, whether the statistics are updated or
  not: v = l2(u·Wᵀ), u' = l2(v·W), with l2(x) = x·rsqrt(Σx² + 1e-12);
- σ = v·W·u'ᵀ with u' and v held constant for the gradient, and the
  convolution uses W / σ (W itself where σ = 0);
- u' and σ are written back (the buffers `u`, `sigma`, Flax's
  `batch_stats`) only with `update_stats`; the bias is not normalized.

A call may start from given statistics instead of the buffers (`stats`,
{conv name: u}, as `stats()` returns them): the trainer's R1 critic reads
the statistics from before the d-step's two updating passes.

SGAN normalizes with Flax's `BatchNorm` (`FlaxBatchNorm`), whose semantics
are not `nn.BatchNorm2d`'s: momentum 0.99 on the running statistics (torch
writes 0.01 for the same rule), ε 1e-5, and the running variance updated
with the biased batch variance (torch's module takes the unbiased one).
"""

from __future__ import annotations

import torch
from torch import nn

from .attention import SelfAttention
from .blocks import Norm, SameConv2d, get_activation, he_normal_


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x) + eps)


class SNConv2d(nn.Module):
    """A "SAME" convolution whose kernel is spectrally normalized as Flax's
    `SpectralNorm` does (module docstring)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, bias: bool = True, groups: int = 1):
        super().__init__()
        self.conv = SameConv2d(in_channels, out_channels, kernel,
                               stride=stride, bias=bias, groups=groups)
        self.register_buffer("u", torch.zeros(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, x, update_stats: bool, u=None):
        w = self.conv.weight
        # (kh·kw·in/groups, out)
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
        with torch.no_grad():
            u0 = self.u if u is None else u
            v = _l2_normalize(u0 @ mat.T)
            u1 = _l2_normalize(v @ mat)
        sigma = (v @ mat @ u1.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u1)
                self.sigma.copy_(sigma)
        w_bar = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        return self.conv._conv_forward(x, w_bar, self.conv.bias)


class PatchGAN(nn.Module):
    """Spectral-norm convolutions (an `in_kernel` stride-2 one with bias,
    then `n_downsamplings` − 1 stride-2 and one stride-1 `n_kernel` ones
    without bias, each with a norm, widths doubling up to 16·dim),
    leaky_relu(0.2) after each, optional self-attention, and an `n_kernel`
    one-channel logit map; every convolution in `n_groups` groups (so that,
    as in the JAX module, only one group builds: the logit map has one
    channel). The cGAN input is concatenated on the channels; with
    `multi_echo` the echo axis of a (nb, ne, H, W, C) input is folded into
    the batch. Returns the logits (nb·ne, h, w, 1)."""

    def __init__(self, in_channels: int, dim: int = 64,
                 n_downsamplings: int = 3, cgan: bool = False,
                 multi_echo: bool = False, self_attention: bool = True,
                 norm: str = "instance_norm", in_kernel: int = 4,
                 n_kernel: int = 4, n_groups: int = 1):
        super().__init__()
        self.cgan, self.multi_echo = cgan, multi_echo
        cin = 2 * in_channels if cgan else in_channels
        dims = [dim]
        for _ in range(n_downsamplings):
            dims.append(min(dims[-1] * 2, dim * 16))
        g = n_groups
        self.convs = nn.ModuleList([SNConv2d(cin, dims[0], in_kernel, 2,
                                             groups=g)])
        self.norms = nn.ModuleList()
        for i in range(1, n_downsamplings + 1):
            stride = 2 if i < n_downsamplings else 1
            self.convs.append(SNConv2d(dims[i - 1], dims[i], n_kernel, stride,
                                       bias=False, groups=g))
            self.norms.append(Norm(dims[i], norm))
        self.attn = SelfAttention(dims[-1]) if self_attention else None
        self.convs.append(SNConv2d(dims[-1], 1, n_kernel, 1, groups=g))

    def forward(self, x, x2=None, update_stats: bool = True, stats=None):
        """x (nb, ne, H, W, C) (with `multi_echo`) or (nb, H, W, C); x2 the
        cGAN condition of x's shape. `update_stats` writes the power
        iteration's u and σ; `stats` ({"convs.i": u}) starts it from those
        instead of the buffers."""
        if self.cgan:
            x = torch.cat([x, x2], dim=-1)
        if self.multi_echo and x.ndim == 5:
            x = x.reshape((-1,) + tuple(x.shape[2:]))
        x = x.permute(0, 3, 1, 2)
        leaky = get_activation("leaky_relu")

        def conv(i, h):
            u = None if stats is None else stats[f"convs.{i}"]
            return self.convs[i](h, update_stats, u)

        x = leaky(conv(0, x))
        for i, norm in enumerate(self.norms, start=1):
            x = leaky(norm(conv(i, x)))
        if self.attn is not None:
            x = self.attn(x)
        return conv(len(self.convs) - 1, x).permute(0, 2, 3, 1)

    def stats(self) -> dict:
        """{"convs.i": a copy of u}: the power iteration's state now."""
        return {f"convs.{i}": c.u.detach().clone()
                for i, c in enumerate(self.convs)}

    def init_params(self, generator: torch.Generator) -> None:
        """He-normal kernels (the logit conv Glorot-normal), zero biases,
        unit norm scales, Glorot-uniform attention with γ = 0, u ~ N(0, 1)
        and σ = 1 (Flax's initial `batch_stats`)."""
        with torch.no_grad():
            last = len(self.convs) - 1
            for i, c in enumerate(self.convs):
                w = c.conv.weight
                if i == last:
                    rf = w[0, 0].numel()
                    std = (2.0 / (w.shape[1] * rf + w.shape[0] * rf)) ** 0.5
                    nn.init.normal_(w, 0.0, std, generator=generator)
                else:
                    he_normal_(w, w[0].numel(), generator)
                if c.conv.bias is not None:
                    nn.init.zeros_(c.conv.bias)
                c.u.copy_(torch.randn(c.u.shape, generator=generator))
                c.sigma.fill_(1.0)
            for n in self.norms:
                nn.init.ones_(n.weight)
                nn.init.zeros_(n.bias)
            if self.attn is not None:
                self.attn.init_params(generator)


class CriticZ(nn.Module):
    """The latent critic: per level an optional self-attention, a 3×3
    (`kernel`) stride-2 "SAME" convolution with bias and leaky_relu(0.2),
    the width divided by 4 at each level. (nb, h, w, C) in and out."""

    def __init__(self, in_channels: int, dim: int = 64,
                 n_downsamplings: int = 3, kernel: int = 3,
                 self_attention: bool = True):
        super().__init__()
        self.attn = nn.ModuleList()
        self.convs = nn.ModuleList()
        cin = in_channels
        for _ in range(n_downsamplings):
            if self_attention:
                self.attn.append(SelfAttention(cin))
            self.convs.append(SameConv2d(cin, dim, kernel, stride=2))
            cin, dim = dim, dim // 4

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        leaky = get_activation("leaky_relu")
        for i, conv in enumerate(self.convs):
            if len(self.attn):
                x = self.attn[i](x)
            x = leaky(conv(x))
        return x.permute(0, 2, 3, 1)

    def init_params(self, generator: torch.Generator) -> None:
        """He-normal kernels, zero biases, Glorot-uniform attention with
        γ = 0."""
        with torch.no_grad():
            for conv in self.convs:
                he_normal_(conv.weight, conv.weight[0].numel(), generator)
                nn.init.zeros_(conv.bias)
            for attn in self.attn:
                attn.init_params(generator)


class FlaxBatchNorm(nn.Module):
    """Flax's `BatchNorm` over NCHW (module docstring): in train mode the
    batch's mean and biased variance over (N, H, W) normalize, and the
    running statistics (buffers `running_mean`, `running_var`, starting at
    0 and 1) move by momentum·old + (1 − momentum)·batch; out of train mode
    the running statistics normalize. Then the scale and the bias."""

    def __init__(self, channels: int, momentum: float = 0.99,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = True):
        if train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


class SGAN(nn.Module):
    """Feature extractor / residual generator: `num_layers` × [3×3 "SAME"
    conv with bias, `FlaxBatchNorm`, leaky_relu(0.2)], returning the list of
    every layer's features (nb, H, W, F), or with `gen_mode` a last 3×3
    conv back to the input's channels added to the input. (The JAX module's
    `kernel_size` field is read by no layer there and is not ported.)"""

    def __init__(self, in_channels: int, gen_mode: bool = False,
                 num_filters: int = 32, num_layers: int = 5):
        super().__init__()
        self.gen_mode = gen_mode
        widths = [in_channels] + [num_filters] * num_layers
        self.convs = nn.ModuleList(SameConv2d(a, b, 3)
                                   for a, b in zip(widths, widths[1:]))
        self.norms = nn.ModuleList(FlaxBatchNorm(num_filters)
                                   for _ in range(num_layers))
        self.out = SameConv2d(num_filters, in_channels, 3) if gen_mode \
            else None

    def forward(self, x, train: bool = True):
        """x (nb, H, W, C) → the features, or (gen_mode) x + the residual."""
        h = x.permute(0, 3, 1, 2)
        leaky = get_activation("leaky_relu")
        feats = []
        for conv, norm in zip(self.convs, self.norms):
            h = leaky(norm(conv(h), train))
            feats.append(h.permute(0, 2, 3, 1))
        if self.out is None:
            return feats
        return x + self.out(h).permute(0, 2, 3, 1)

    def init_params(self, generator: torch.Generator) -> None:
        """He-normal kernels (the gen_mode output conv LeCun-normal, Flax's
        default), zero biases, unit norm scales; running statistics 0 and
        1."""
        with torch.no_grad():
            for conv in self.convs:
                he_normal_(conv.weight, conv.weight[0].numel(), generator)
                nn.init.zeros_(conv.bias)
            if self.out is not None:
                nn.init.normal_(self.out.weight, 0.0,
                                self.out.weight[0].numel() ** -0.5,
                                generator=generator)
                nn.init.zeros_(self.out.bias)
            for norm in self.norms:
                norm.weight.fill_(1.0)
                norm.bias.zero_()
                norm.running_mean.zero_()
                norm.running_var.fill_(1.0)
