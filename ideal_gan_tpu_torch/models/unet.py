"""U-Net (port of `ideal_gan_tpu/models/unet.py::UNet`).

Ported on the path `train.unsup.build_models` uses: the multi-echo ConvLSTM
front (`me_layer=True`), `num_layers` encoder levels with skip connections,
optional self-attention at the first decoder level, a 1×1 head and its
activation. The other options (Bayesian and σ heads, TE conditioning, the
CSE physics layer, echo folding without the ConvLSTM, other norms, dropout,
rematerialization, bf16 compute) raise NotImplementedError; ROADMAP.md
queues them.

Input MEBCRN-like (nb, ne, H, W, Cin); output (nb, 1, H, W, n_out), the JAX
package's layouts. Inside, activations are NCHW. H and W must be divisible
by 2**num_layers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .attention import SelfAttention
from .blocks import ConvBlock, Upsample, get_activation, init_params
from .convlstm import ConvLSTM


class UNet(nn.Module):
    def __init__(self, in_channels: int, n_out: int = 1,
                 skip_con: bool = True, bayesian: bool = False,
                 std_out: bool = False, me_layer: bool = True,
                 te_input: bool = False, cse_layer: bool = False,
                 filters: int = 72, num_layers: int = 4,
                 dropout: float = 0.0, output_activation: str = "tanh",
                 self_attention: bool = False, norm: str = "instance_norm"):
        super().__init__()
        unported = {"bayesian": bayesian, "std_out": std_out,
                    "te_input": te_input, "cse_layer": cse_layer,
                    "me_layer=False": not me_layer,
                    "skip_con=False": not skip_con, "dropout": dropout > 0}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"UNet options {bad} are not ported yet (ROADMAP Queue 1)")
        self.num_layers = num_layers
        self.output_activation = output_activation
        self.lstm = ConvLSTM(in_channels, filters)
        self.down = nn.ModuleList()
        cin, f = filters, filters
        for _ in range(num_layers):
            self.down.append(ConvBlock(cin, f, norm=norm))
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

    def forward(self, x):
        x = self.lstm(x)
        skips = []
        for block in self.down:
            x = block(x)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = self.bottom(x)
        for level, (up, block) in enumerate(zip(self.up, self.dec)):
            x = torch.cat([up(x), skips[-1 - level]], dim=1)
            if self.attn is not None and level == 0:
                x = self.attn(x)
            x = block(x)
        out = get_activation(self.output_activation)(self.head(x))
        return out.permute(0, 2, 3, 1)[:, None]

    def init_params(self, generator: torch.Generator) -> None:
        init_params(self, generator)
