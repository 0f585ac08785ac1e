"""PI-VAE encoder and decoder (port of `ideal_gan_tpu/models/vae.py`'s
`Encoder` and `Decoder` without its Bayesian head; `BayesDecoder` has no
caller on a ported path).

Layouts are the JAX package's at the boundary: the encoder takes echoes
(nb, ne, H, W, Cin) and returns the latent grid channels-last, (nb, h, w,
D) with h = H / 2**num_layers, as a `prob.Normal` with `sd_out` (σ =
relu + 1e-6, as the JAX head floors it) or a tensor, with no activation
on the mean (JAX's `ls_mean_activ="None"`, the only value its trainer
uses); a decoder takes such a grid (nb, h, w, D') and returns (nb, 1, H,
W, n_out). Inside, activations
are NCHW. The encoder's front is the multi-echo ConvLSTM
(`models.convlstm`), which runs the ConvLSTM kernels on the card.

Every convolution pads as Flax's "SAME" (`blocks.SameConv2d`), which for the
stride-2 3×3 convolutions at even sizes is (0, 1) and for the decoders'
2×2 upsampling convolutions (0, 1). `dtype` is the compute dtype
(`models.blocks`); with bfloat16 the posterior comes out in bfloat16 and
the trainer upcasts it, as the JAX trainer does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..prob import Normal
from .attention import SelfAttention
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
    conv and the residual blocks, a norm and the 3×3 head of `n_out`
    channels with its activation."""

    def __init__(self, encoded_dims: int, n_out: int, filters=36,
                 num_layers: int = 4, num_res_blocks: int = 2,
                 output_activation: str = "tanh",
                 nl_self_attention: bool = True,
                 norm: str = "instance_norm", dtype=None):
        super().__init__()
        widths = _filter_list(filters, num_layers)[::-1]
        self.dtype = dtype
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
                [ResidualBlock(widths[level + 1], norm, dtype=dtype)
                 for _ in range(num_res_blocks)]))
        self.norm = Norm(widths[-1], norm, dtype=dtype)
        self.head = SameConv2d(widths[-1], n_out, 3)

    def forward(self, z):
        """z (nb, h, w, D') → (nb, 1, H, W, n_out)."""
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
        return out.permute(0, 2, 3, 1)[:, None]

    def init_params(self, generator: torch.Generator) -> None:
        """He-normal convolutions, Glorot-normal head, zero biases; the
        upsampling convolutions LeCun-normal (Flax's default)."""
        init_params(self, generator)
        with torch.no_grad():
            _glorot_normal_(self.head.weight, generator)
            for up in self.up:
                w = up.conv.weight
                nn.init.normal_(w, 0.0, w[0].numel() ** -0.5,
                                generator=generator)
