"""PI-VAE encoder and decoders (port of `ideal_gan_tpu/models/vae.py`).

Layouts are the JAX package's at the boundary: the encoder takes echoes
(nb, ne, H, W, Cin) and returns the latent grid channels-last, (nb, h, w,
D) with h = H / 2**num_layers, as a `prob.Normal` with `sd_out` (σ =
relu + 1e-6, as the JAX head floors it) or a tensor, with no activation
on the mean (JAX's `ls_mean_activ="None"`, the only value its trainer
uses); a decoder takes such a grid (nb, h, w, D') and returns (nb, 1, H,
W, n_out) (without `multi_echo`, (nb, H, W, n_out)). Inside, activations
are NCHW. The encoder's front is the multi-echo ConvLSTM
(`models.convlstm`), which runs the ConvLSTM kernels on the card.

Every convolution pads as Flax's "SAME" (`blocks.SameConv2d`), which for the
stride-2 3×3 convolutions at even sizes is (0, 1) and for the decoders'
2×2 upsampling convolutions (0, 1). `dtype` is the compute dtype
(`models.blocks`); with bfloat16 the posterior comes out in bfloat16 and
the trainer upcasts it, as the JAX trainer does.

The Bayesian decoders are built on Flipout convolutions
(`models.bayes.FlipoutConv`): `Decoder(bayes_layer=True)` ends in two
one-channel Flipout heads on the halves of its last features (real and
imaginary), stochastic in train mode; `BayesDecoder` is Flipout throughout,
a stem and two towers whose residual blocks sample even out of train mode,
as the JAX blocks do. Their forwards take the draws' `noise` source
(`prob.noise`); the draws follow the JAX call order, so that a replay of
the JAX draws gives the JAX outputs. `models.bayes.kl_sum` gives their KL.
"""

from __future__ import annotations

import torch
from torch import nn

from ..prob import Normal
from .attention import SelfAttention
from .bayes import FlipoutConv
from .blocks import (Norm, ResidualBlock, SameConv2d, Upsample, dtype_conv,
                     get_activation, he_normal_, init_params)
from .convlstm import ConvLSTM


def _filter_list(filters, num_layers: int) -> list:
    """Per-level widths: an int doubles at every level, a sequence (of
    num_layers + 1 entries) is taken as given (`--n_G_filt_list`)."""
    if isinstance(filters, (list, tuple)):
        filters = list(filters)
        if len(filters) != num_layers + 1:
            raise ValueError(
                f"filter list must have num_layers+1={num_layers + 1} "
                f"entries, got {len(filters)}")
        return filters
    return [filters * 2 ** k for k in range(num_layers + 1)]


def _sa_block(channels: int, norm: str, dtype) -> nn.ModuleList:
    """residual block, self-attention, residual block."""
    return nn.ModuleList([ResidualBlock(channels, norm, dtype=dtype),
                          SelfAttention(channels, dtype=dtype),
                          ResidualBlock(channels, norm, dtype=dtype)])


def _leaky(x):
    return get_activation("leaky_relu")(x)


def _glorot_normal_(w: torch.Tensor, generator: torch.Generator):
    """Flax's glorot_normal over an (out, in/groups, kh, kw) kernel."""
    rf = w[0, 0].numel()
    std = (2.0 / (w.shape[1] * rf + w.shape[0] * rf)) ** 0.5
    return nn.init.normal_(w, 0.0, std, generator=generator)


class Encoder(nn.Module):
    """ConvLSTM front, 3×3 conv stem, then per level the residual blocks and
    a stride-2 3×3 conv, optional res + self-attention + res, a 3×3 conv to
    `encoded_dims` and the latent head."""

    def __init__(self, in_channels: int, encoded_dims: int, filters=36,
                 num_layers: int = 4, num_res_blocks: int = 2,
                 sd_out: bool = True, nl_self_attention: bool = True,
                 norm: str = "instance_norm", dtype=None):
        super().__init__()
        widths = _filter_list(filters, num_layers)
        self.dtype = dtype
        self.sd_out = sd_out
        self.lstm = ConvLSTM(in_channels, widths[0], dtype=dtype)
        self.stem = SameConv2d(widths[0], widths[0], 3)
        self.res = nn.ModuleList()
        self.down = nn.ModuleList()
        for level in range(num_layers):
            self.res.append(nn.ModuleList(
                [ResidualBlock(widths[level], norm, dtype=dtype)
                 for _ in range(num_res_blocks)]))
            self.down.append(SameConv2d(widths[level], widths[level + 1], 3,
                                        stride=2))
        self.sa = _sa_block(widths[-1], norm, dtype) if nl_self_attention \
            else None
        self.head = SameConv2d(widths[-1], encoded_dims, 3)
        if sd_out:
            self.mean = nn.Conv2d(encoded_dims, encoded_dims, 1)
            self.std = nn.Conv2d(encoded_dims, encoded_dims, 1)
        else:
            self.out = nn.Conv2d(encoded_dims, encoded_dims, 1)

    def forward(self, x):
        """x (nb, ne, H, W, Cin) → `Normal` over (nb, h, w, D) with
        `sd_out`, else the (nb, h, w, D) tensor."""
        dt = self.dtype
        x = _leaky(dtype_conv(self.stem, self.lstm(x), dt))
        for blocks, down in zip(self.res, self.down):
            for block in blocks:
                x = block(x)
            x = _leaky(dtype_conv(down, x, dt))
        if self.sa is not None:
            for m in self.sa:
                x = m(x)
        x = dtype_conv(self.head, x, dt)
        if not self.sd_out:
            return dtype_conv(self.out, x, dt).permute(0, 2, 3, 1)
        mean = dtype_conv(self.mean, x, dt)
        std = torch.relu(dtype_conv(self.std, x, dt)) + 1e-6
        return Normal(loc=mean.permute(0, 2, 3, 1),
                      scale=std.permute(0, 2, 3, 1))

    def init_params(self, generator: torch.Generator) -> None:
        """He-normal convolutions (the 1×1 heads too, as Flax's), Flax's
        LeCun-normal for the head without `sd_out`, zero biases."""
        init_params(self, generator)
        with torch.no_grad():
            for conv in ([self.mean, self.std] if self.sd_out else []):
                he_normal_(conv.weight, conv.weight[0].numel(), generator)
            if not self.sd_out:
                nn.init.normal_(self.out.weight, 0.0,
                                self.out.weight[0].numel() ** -0.5,
                                generator=generator)


class Decoder(nn.Module):
    """3×3 conv to `encoded_dims`, 3×3 conv to the widest level, optional res
    + self-attention + res, then per level a nearest ×2 upsample with a 2×2
    conv and the residual blocks (in `n_groups` groups), a norm and the 3×3
    head (in `n_groups` groups) of `n_out` channels with its activation.
    With `bayes_layer` the head has the last level's width, and after its
    activation two one-channel Flipout convolutions with the activation,
    on the first and the second half of its channels, give the real and
    the imaginary output (`n_out` is then 2)."""

    def __init__(self, encoded_dims: int, n_out: int, filters=36,
                 num_layers: int = 4, num_res_blocks: int = 2,
                 output_activation: str = "tanh",
                 nl_self_attention: bool = True,
                 norm: str = "instance_norm", n_groups: int = 1,
                 multi_echo: bool = True, bayes_layer: bool = False,
                 dtype=None):
        super().__init__()
        widths = _filter_list(filters, num_layers)[::-1]
        self.dtype = dtype
        self.multi_echo = multi_echo
        self.bayes_layer = bayes_layer
        self.act = get_activation(output_activation)
        self.conv_in = SameConv2d(encoded_dims, encoded_dims, 3)
        self.conv_wide = SameConv2d(encoded_dims, widths[0], 3)
        self.sa = _sa_block(widths[0], norm, dtype) if nl_self_attention \
            else None
        self.up = nn.ModuleList()
        self.res = nn.ModuleList()
        for level in range(num_layers):
            self.up.append(Upsample(widths[level], widths[level + 1],
                                    method="interpol_conv", dtype=dtype))
            self.res.append(nn.ModuleList(
                [ResidualBlock(widths[level + 1], norm, groups=n_groups,
                               dtype=dtype)
                 for _ in range(num_res_blocks)]))
        self.norm = Norm(widths[-1], norm, dtype=dtype)
        last = widths[-1]
        self.head = SameConv2d(last, last if bayes_layer else n_out, 3,
                               groups=n_groups)
        if bayes_layer:
            self.flip_r = FlipoutConv(last // 2, 1,
                                      activation=output_activation)
            self.flip_i = FlipoutConv(last - last // 2, 1,
                                      activation=output_activation)

    def forward(self, z, train: bool = True, noise=None):
        """z (nb, h, w, D') → (nb, 1, H, W, n_out) (with `multi_echo`).
        With `bayes_layer` in train mode the Flipout heads draw from `noise`
        (`prob.noise`), the real head's draws first."""
        dt = self.dtype
        x = z.permute(0, 3, 1, 2)
        x = _leaky(dtype_conv(self.conv_in, x, dt))
        x = _leaky(dtype_conv(self.conv_wide, x, dt))
        if self.sa is not None:
            for m in self.sa:
                x = m(x)
        for up, blocks in zip(self.up, self.res):
            x = up(x)
            for block in blocks:
                x = block(x)
        out = self.act(dtype_conv(self.head, self.norm(x), dt))
        if self.bayes_layer:
            half = self.flip_r.kernel_mean.shape[1]
            out = torch.cat(
                [flip(part, deterministic=not train, noise=noise)
                 for flip, part in ((self.flip_r, out[:, :half]),
                                    (self.flip_i, out[:, half:]))], dim=1)
        out = out.permute(0, 2, 3, 1)
        return out[:, None] if self.multi_echo else out

    def init_params(self, generator: torch.Generator) -> None:
        """He-normal convolutions, Glorot-normal head, zero biases; the
        upsampling convolutions LeCun-normal (Flax's default)."""
        init_params(self, generator)
        with torch.no_grad():
            _glorot_normal_(self.head.weight, generator)
            _lecun_upsampling_(self.up, generator)


def _lecun_upsampling_(ups, generator: torch.Generator) -> None:
    for up in ups:
        w = up.conv.weight
        nn.init.normal_(w, 0.0, w[0].numel() ** -0.5, generator=generator)


class _BayesTower(nn.Module):
    """One tower of `BayesDecoder`: a leaky Flipout stem to the widest
    level, optional Bayesian res + self-attention + Bayesian res, per level
    a nearest ×2 upsample with a 2×2 conv (halving the width) and the
    Bayesian residual blocks, a norm, and a one-channel Flipout head."""

    def __init__(self, in_channels: int, width: int, num_layers: int,
                 num_res_blocks: int, output_activation, nl_self_attention,
                 norm: str):
        super().__init__()
        self.stem = FlipoutConv(in_channels, width, activation="leaky_relu")
        self.sa = nn.ModuleList([
            ResidualBlock(width, norm, bayes=True), SelfAttention(width),
            ResidualBlock(width, norm, bayes=True)]) \
            if nl_self_attention else None
        self.up = nn.ModuleList()
        self.res = nn.ModuleList()
        for _ in range(num_layers):
            self.up.append(Upsample(width, width // 2,
                                    method="interpol_conv"))
            width //= 2
            self.res.append(nn.ModuleList(
                [ResidualBlock(width, norm, bayes=True)
                 for _ in range(num_res_blocks)]))
        self.norm = Norm(width, norm)
        self.head = FlipoutConv(width, 1, activation=output_activation)

    def forward(self, x, train: bool, noise):
        h = self.stem(x, deterministic=not train, noise=noise)
        if self.sa is not None:
            h = self.sa[0](h, noise)
            h = self.sa[1](h)
            h = self.sa[2](h, noise)
        for up, blocks in zip(self.up, self.res):
            h = up(h)
            for block in blocks:
                h = block(h, noise)
        return self.head(self.norm(h), deterministic=not train, noise=noise)


class BayesDecoder(nn.Module):
    """The fully Flipout decoder: a leaky Flipout stem over the latent, then
    a real and an imaginary tower (`_BayesTower`, `filters·2^num_layers`
    wide at the latent's size) on the first and the second half of its
    channels. The stem and the heads are stochastic in train mode only,
    the towers' residual blocks always (module docstring)."""

    def __init__(self, encoded_dims: int, filters: int = 36,
                 num_layers: int = 4, num_res_blocks: int = 2,
                 output_activation: str | None = None,
                 nl_self_attention: bool = True,
                 norm: str = "instance_norm"):
        super().__init__()
        width = filters * 2 ** num_layers
        half = encoded_dims // 2
        self.stem = FlipoutConv(encoded_dims, encoded_dims,
                                activation="leaky_relu")
        self.towers = nn.ModuleList([
            _BayesTower(c, width, num_layers, num_res_blocks,
                        output_activation, nl_self_attention, norm)
            for c in (half, encoded_dims - half)])

    def forward(self, z, train: bool = True, noise=None):
        """z (nb, h, w, encoded_dims) → (nb, 1, H, W, 2); the draws from
        `noise` (`prob.noise`) in the JAX call order: the stem, then the
        real tower, then the imaginary one."""
        x = self.stem(z.permute(0, 3, 1, 2), deterministic=not train,
                      noise=noise)
        half = x.shape[1] // 2
        out = torch.cat([tower(part, train, noise) for tower, part in
                         zip(self.towers, (x[:, :half], x[:, half:]))], dim=1)
        return out.permute(0, 2, 3, 1)[:, None]

    def init_params(self, generator: torch.Generator) -> None:
        """He-normal Flipout means (log σ = −3), Glorot-uniform attention
        with γ = 0, unit norm scales, zero biases; the upsampling
        convolutions LeCun-normal (Flax's default)."""
        init_params(self, generator)
        with torch.no_grad():
            for tower in self.towers:
                _lecun_upsampling_(tower.up, generator)
