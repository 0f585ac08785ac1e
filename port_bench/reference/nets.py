"""Plain PyTorch copies of the two generators the benchmark serves and
trains, written from their published architecture (jpmeneses/IDEAL-GAN):

- `UNet`: the AI-DEAL nets of `train-IDEAL-unsup.py`: a ConvLSTM over the
  echoes, 4 encoder levels of (conv 3x3, ReLU, instance norm) x 2 and a
  2x2 max-pool, the bottom block, 4 decoder levels of a 2x2 stride-2
  transposed conv, the skip concatenation, self-attention at the first
  decoder level where asked, the same block, and a 1x1 head with its
  activation. Output (nb, 1, H, W, n_out).
- `VETNet`: `PM_Generator(te_input=True)` of `train-IDEAL-TEaug.py`: the
  same ConvLSTM front and encoder, each encoder level followed by AdaIN
  towards the style of its own TE encoder (an LSTM of 6 over the TE train,
  Dense(F) and ReLU), two decoders (R2* sigmoid, field map tanh). Output
  (nb, 1, H, W, [phi, R2*]).

The ConvLSTM is one plain `conv2d` per echo over concat(x_e, h), keras
gate order i, f, g, o, leaky_relu (slope 0.2) as the cell activation and
sigmoid as the recurrent one. Parameter names follow the measured
program's modules so that one state dict loads into both. Instance norm
has epsilon 1e-3; AdaIN uses the style vector's scalar mean and variance
and epsilon 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x):
    return torch.where(x >= 0, x, 0.2 * x)


ACTIVATIONS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid}


class ConvLSTM(nn.Module):
    def __init__(self, cin: int, filters: int):
        super().__init__()
        self.filters = filters
        self.input_conv = nn.Conv2d(cin, 4 * filters, 3, padding=1)
        self.recurrent_conv = nn.Conv2d(filters, 4 * filters, 3, padding=1,
                                        bias=False)

    def forward(self, x):
        """x (nb, ne, H, W, Cin) -> the last hidden state (nb, F, H, W)."""
        nb, ne, h, w, _ = x.shape
        weight = torch.cat([self.input_conv.weight,
                            self.recurrent_conv.weight], dim=1)
        hid = x.new_zeros((nb, self.filters, h, w))
        cell = torch.zeros_like(hid)
        for e in range(ne):
            inp = torch.cat([x[:, e].permute(0, 3, 1, 2), hid], dim=1)
            z = F.conv2d(inp, weight, self.input_conv.bias, padding=1)
            i, f, g, o = torch.split(z, self.filters, dim=1)
            cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * leaky_relu(g)
            hid = torch.sigmoid(o) * leaky_relu(cell)
        return hid


class ConvBlock(nn.Module):
    def __init__(self, cin: int, filters: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 3, padding=1, bias=False)
        self.norm1 = nn.GroupNorm(filters, filters, eps=1e-3)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.norm2 = nn.GroupNorm(filters, filters, eps=1e-3)

    def forward(self, x):
        x = self.norm1(F.relu(self.conv1(x)))
        return self.norm2(F.relu(self.conv2(x)))


class Upsample(nn.Module):
    def __init__(self, cin: int, filters: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, filters, 2, stride=2)

    def forward(self, x):
        return self.conv(x)


class SelfAttention(nn.Module):
    """SAGAN attention over the flattened grid, no 1/sqrt(d) scale, the
    residual weighted by gamma."""

    def __init__(self, channels: int):
        super().__init__()
        cf = max(channels // 8, 1)
        self.f = nn.Conv2d(channels, cf, 1, bias=False)
        self.g = nn.Conv2d(channels, cf, 1, bias=False)
        self.h = nn.Conv2d(channels, channels, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        b, c, hh, ww = x.shape
        fm = self.f(x).flatten(2)
        gm = self.g(x).flatten(2).transpose(1, 2)
        hm = self.h(x).flatten(2).transpose(1, 2)
        beta = torch.softmax(gm @ fm, dim=-1)
        o = (beta @ hm).transpose(1, 2).reshape(b, c, hh, ww)
        return self.gamma * o + x


class TEEncoder(nn.Module):
    def __init__(self, filters: int, features: int = 6):
        super().__init__()
        self.lstm = nn.LSTM(1, features, batch_first=True)
        self.lstm.bias_ih_l0.requires_grad_(False)
        self.dense = nn.Linear(features, filters)

    def forward(self, te):
        y, _ = self.lstm(te[..., None])
        return F.relu(self.dense(y[:, -1]))


def adain(content, style):
    s_mean = style.mean(dim=1)[:, None, None, None]
    s_var = style.var(dim=1, unbiased=False)[:, None, None, None]
    c_mean = content.mean(dim=(2, 3), keepdim=True)
    c_var = content.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (content - c_mean) / torch.sqrt(c_var + 1e-5) \
        * torch.sqrt(s_var) + s_mean


class _Decoder(nn.Module):
    def __init__(self, ftop: int, levels: int, activation: str,
                 attention: bool, n_out: int = 1):
        super().__init__()
        self.activation = ACTIVATIONS[activation]
        self.up, self.blocks = nn.ModuleList(), nn.ModuleList()
        self.attn = None
        f = ftop
        for level in range(levels):
            self.up.append(Upsample(f, f // 2))
            if attention and level == 0:
                self.attn = SelfAttention(f)
            self.blocks.append(ConvBlock(f, f // 2))
            f //= 2
        self.head = nn.Conv2d(f, n_out, 1)

    def forward(self, x, skips):
        for level, (up, block) in enumerate(zip(self.up, self.blocks)):
            x = torch.cat([up(x), skips[-1 - level]], dim=1)
            if self.attn is not None and level == 0:
                x = self.attn(x)
            x = block(x)
        return self.activation(self.head(x))


class UNet(nn.Module):
    def __init__(self, cin: int, filters: int, levels: int = 4,
                 activation: str = "tanh", attention: bool = False):
        super().__init__()
        self.activation = ACTIVATIONS[activation]
        self.lstm = ConvLSTM(cin, filters)
        self.down = nn.ModuleList()
        c, f = filters, filters
        for _ in range(levels):
            self.down.append(ConvBlock(c, f))
            c, f = f, 2 * f
        self.bottom = ConvBlock(c, f)
        self.up, self.dec, self.attn = nn.ModuleList(), nn.ModuleList(), None
        for level in range(levels):
            self.up.append(Upsample(f, f // 2))
            if attention and level == 0:
                self.attn = SelfAttention(f)
            self.dec.append(ConvBlock(f, f // 2))
            f //= 2
        self.head = nn.Conv2d(f, 1, 1)

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
        return self.activation(self.head(x)).permute(0, 2, 3, 1)[:, None]


class _SharedEncoder(nn.Module):
    def __init__(self, cin: int, filters: int, levels: int):
        super().__init__()
        self.blocks, self.te = nn.ModuleList(), nn.ModuleList()
        c, f = cin, filters
        for _ in range(levels):
            self.blocks.append(ConvBlock(c, f))
            self.te.append(TEEncoder(f))
            c, f = f, 2 * f
        self.bottom = ConvBlock(c, f)

    def forward(self, x, te):
        skips = []
        for block, enc in zip(self.blocks, self.te):
            x = adain(block(x), enc(te))
            skips.append(x)
            x = F.max_pool2d(x, 2)
        return self.bottom(x), skips


class VETNet(nn.Module):
    def __init__(self, cin: int, filters: int, levels: int = 4,
                 r2_attention: bool = False, fm_attention: bool = True):
        super().__init__()
        self.lstm = ConvLSTM(cin, filters)
        self.encoder = _SharedEncoder(filters, filters, levels)
        ftop = filters * 2 ** levels
        self.dec_r2 = _Decoder(ftop, levels, "sigmoid", r2_attention)
        self.dec_fm = _Decoder(ftop, levels, "tanh", fm_attention)

    def forward(self, x, te):
        """x (nb, ne, H, W, 2), te (nb, ne) -> (nb, 1, H, W, [phi, R2*])."""
        x, skips = self.encoder(self.lstm(x), te)
        out = torch.cat([self.dec_fm(x, skips), self.dec_r2(x, skips)],
                        dim=1)
        return out.permute(0, 2, 3, 1)[:, None]
