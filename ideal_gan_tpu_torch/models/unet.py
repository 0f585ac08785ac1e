"""U-Net and VET-Net (port of `ideal_gan_tpu/models/unet.py::UNet` and
`VETNet`).

`UNet` is ported on the paths `train.unsup.build_models` and
`train.mag.build_model` use: the multi-echo ConvLSTM front
(`me_layer=True`), `num_layers` encoder levels with skip connections, with
`te_input` a TEEncoder and AdaIN after every encoder level's block,
optional self-attention at the first decoder level, a 1×1 head and its
activation, and the σ head (`bayesian`, `std_out`). `VETNet` (the
reference `PM_Generator`) is ported on the path `train.teaug.build_model`
uses: the ConvLSTM front, the shared encoder with LSTM→AdaIN TE
conditioning at every level (`te_input`) or none, and two decoders (R2*
sigmoid, field map tanh). The other options (a `Normal` posterior for a
Bayesian tanh head, the CSE physics layer, echo folding without the
ConvLSTM, dropout) raise NotImplementedError; VET-Net is the ConvLSTM-front
form without dropout, instance norm only, one output channel per decoder
and no "dense_l1" TE mode (MDWF-Net's). ROADMAP.md queues the rest.

Input MEBCRN-like (nb, ne, H, W, Cin); output (nb, 1, H, W, n_out) for the
UNet (a `prob.Rician` of two such maps with `bayesian`, the pair (out, σ)
with `std_out`) and (nb, 1, H, W, [FM, R2*]) for VET-Net, the JAX
package's layouts. Inside, activations are NCHW. H and W must be divisible
by 2**num_layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..prob import Rician
from .attention import SelfAttention, adain
from .blocks import (ConvBlock, TEEncoder, Upsample, get_activation,
                     he_normal_, init_params)
from .convlstm import ConvLSTM


class _SigmaHead(nn.Module):
    """The σ head: Conv 1×1 to 16, ReLU, Conv 1×1 to n_out, sigmoid, with
    Flax's He-uniform and He-normal kernels and zero biases."""

    def __init__(self, in_channels: int, n_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 16, 1)
        self.conv2 = nn.Conv2d(16, n_out, 1)

    def forward(self, x):
        return torch.sigmoid(self.conv2(F.relu(self.conv1(x))))

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            bound = math.sqrt(6.0 / self.conv1.in_channels)
            nn.init.uniform_(self.conv1.weight, -bound, bound,
                             generator=generator)
            he_normal_(self.conv2.weight, 16, generator)
            nn.init.zeros_(self.conv1.bias)
            nn.init.zeros_(self.conv2.bias)


class UNet(nn.Module):
    def __init__(self, in_channels: int, n_out: int = 1,
                 skip_con: bool = True, bayesian: bool = False,
                 std_out: bool = False, me_layer: bool = True,
                 te_input: bool = False, cse_layer: bool = False,
                 filters: int = 72, num_layers: int = 4,
                 dropout: float = 0.0, output_activation: str = "tanh",
                 self_attention: bool = False, norm: str = "instance_norm"):
        super().__init__()
        unported = {"bayesian with a tanh head (Normal; ROADMAP Queue 1 item "
                    "6)": bayesian and output_activation == "tanh",
                    "cse_layer": cse_layer, "me_layer=False": not me_layer,
                    "skip_con=False": not skip_con, "dropout": dropout > 0}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"UNet options {bad} are not ported yet (ROADMAP Queue 1)")
        self.num_layers = num_layers
        self.output_activation = output_activation
        self.te_input = te_input
        self.bayesian = bayesian
        self.lstm = ConvLSTM(in_channels, filters)
        self.down = nn.ModuleList()
        self.te = nn.ModuleList() if te_input else None
        cin, f = filters, filters
        for _ in range(num_layers):
            self.down.append(ConvBlock(cin, f, norm=norm))
            if te_input:
                self.te.append(TEEncoder(f))
            cin, f = f, 2 * f
        self.bottom = ConvBlock(cin, f, norm=norm)
        self.up = nn.ModuleList()
        self.dec = nn.ModuleList()
        self.attn = None
        for level in range(num_layers):
            self.up.append(Upsample(f, f // 2))
            if self_attention and level == 0:
                self.attn = SelfAttention(f)
            self.dec.append(ConvBlock(f, f // 2, norm=norm))
            f //= 2
        self.head = nn.Conv2d(f, n_out, 1)
        self.sigma = _SigmaHead(f, n_out) if bayesian or std_out else None

    def forward(self, x, te=None):
        """x (nb, ne, H, W, Cin); te (nb, ne), needed with `te_input`."""
        if self.te_input and te is None:
            raise ValueError("UNet(te_input=True) needs the TE vector")
        x = self.lstm(x)
        skips = []
        for level, block in enumerate(self.down):
            x = block(x)
            if self.te is not None:
                x = adain(x, self.te[level](te))
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.bottom(x)
        for level, (up, block) in enumerate(zip(self.up, self.dec)):
            x = torch.cat([up(x), skips[-1 - level]], dim=1)
            if self.attn is not None and level == 0:
                x = self.attn(x)
            x = block(x)
        out = get_activation(self.output_activation)(self.head(x))
        out = out.permute(0, 2, 3, 1)[:, None]
        if self.sigma is None:
            return out
        sigma = self.sigma(x).permute(0, 2, 3, 1)[:, None]
        return Rician(nu=out, sigma=sigma) if self.bayesian else (out, sigma)

    def init_params(self, generator: torch.Generator) -> None:
        init_params(self, generator)


class _SharedEncoder(nn.Module):
    """The encoder trunk of the multi-decoder generators: `num_layers`
    conv blocks, each followed (with `te_input`) by AdaIN towards its own
    TEEncoder's style and a 2×2 max-pool, then the bottom block. Returns
    (x, skips)."""

    def __init__(self, in_channels: int, filters: int, num_layers: int,
                 te_input: bool):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.te = nn.ModuleList() if te_input else None
        cin, f = in_channels, filters
        for _ in range(num_layers):
            self.blocks.append(ConvBlock(cin, f))
            if te_input:
                self.te.append(TEEncoder(f))
            cin, f = f, 2 * f
        self.bottom = ConvBlock(cin, f)

    def forward(self, x, te=None):
        skips = []
        for level, block in enumerate(self.blocks):
            x = block(x)
            if self.te is not None:
                x = adain(x, self.te[level](te))
            skips.append(x)
            x = F.max_pool2d(x, 2)
        return self.bottom(x), skips


class _Decoder(nn.Module):
    """One decoder branch: per level upsample → concat skip →
    (self-attention at level 0) → conv block; 1×1 head to one channel and
    its activation. NCHW in, (nb, 1, H, W) out."""

    def __init__(self, filters_top: int, num_layers: int,
                 head_activation: str, self_attention: bool):
        super().__init__()
        self.head_activation = head_activation
        self.up = nn.ModuleList()
        self.blocks = nn.ModuleList()
        self.attn = None
        f = filters_top
        for level in range(num_layers):
            self.up.append(Upsample(f, f // 2))
            if self_attention and level == 0:
                self.attn = SelfAttention(f)
            self.blocks.append(ConvBlock(f, f // 2))
            f //= 2
        self.head = nn.Conv2d(f, 1, 1)

    def forward(self, x, skips):
        for level, (up, block) in enumerate(zip(self.up, self.blocks)):
            x = torch.cat([up(x), skips[-1 - level]], dim=1)
            if self.attn is not None and level == 0:
                x = self.attn(x)
            x = block(x)
        return get_activation(self.head_activation)(self.head(x))


class VETNet(nn.Module):
    """The reference `PM_Generator`, VET-Net with `te_input=True`: ConvLSTM
    multi-echo front, shared encoder with LSTM→AdaIN TE conditioning, two
    decoders (R2* sigmoid, field map tanh). `forward(x, te)` takes echoes
    (nb, ne, H, W, Cin) and the TE vector (nb, ne) and returns (nb, 1, H,
    W, [FM, R2*])."""

    def __init__(self, in_channels: int, te_input: bool = False,
                 filters: int = 72, num_layers: int = 4,
                 r2_self_attention: bool = False,
                 fm_self_attention: bool = True):
        super().__init__()
        self.te_input = te_input
        self.lstm = ConvLSTM(in_channels, filters)
        self.encoder = _SharedEncoder(filters, filters, num_layers, te_input)
        ftop = filters * 2 ** num_layers
        self.dec_r2 = _Decoder(ftop, num_layers, "sigmoid", r2_self_attention)
        self.dec_fm = _Decoder(ftop, num_layers, "tanh", fm_self_attention)

    def forward(self, x, te=None):
        if self.te_input and te is None:
            raise ValueError("VETNet(te_input=True) needs the TE vector")
        x, skips = self.encoder(self.lstm(x), te)
        out = torch.cat([self.dec_fm(x, skips), self.dec_r2(x, skips)], dim=1)
        return out.permute(0, 2, 3, 1)[:, None]

    def init_params(self, generator: torch.Generator) -> None:
        init_params(self, generator)
