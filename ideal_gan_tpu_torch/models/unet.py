"""U-Net, MDWF-Net and VET-Net (port of `ideal_gan_tpu/models/unet.py::UNet`,
`MDWFNet` and `VETNet`).

`UNet` is ported on the paths `train.unsup.build_models`,
`train.mag.build_model`, `train.teaug.build_model` and `train.sup.build_model`
use: with `me_layer` the multi-echo ConvLSTM front, without it the legacy
4-D input (nb, H, W, C) or a 5-D input (nb, ne, H, W, C) folded into nb·ne
images; `num_layers` encoder levels with skip connections, with `te_input`
a TEEncoder and AdaIN after every encoder level's block, optional
self-attention at the first decoder level, a 1×1 head of `n_out` channels
and its activation, and the σ head (`bayesian`, `std_out`). `VETNet` (the
reference `PM_Generator`) and `MDWFNet` (the reference `MDWF_Generator`)
share `_SharedEncoder`: conv blocks with LSTM→AdaIN TE conditioning at
every level ("adain", VET-Net) or a Dense(TE) + ReLU added at level 1
("dense_l1", MDWF-Net); VET-Net has two decoders (R2* sigmoid, field map
tanh), MDWF-Net three (water/fat sigmoid ×2, R2* relu, field map tanh).
The other options (the CSE physics layer, dropout, no skip connections)
raise NotImplementedError; ROADMAP.md queues them.

`dtype` is the nets' compute dtype (`models.blocks`: every convolution,
norm, attention and the ConvLSTM front compute in it while the parameters
stay float32; the heads' outputs are in it, and the trainers upcast them to
float32 before the physics, as the JAX package does). `remat` recomputes
each conv block and each upsample in the backward
(`torch.utils.checkpoint`); the module tree, and so the state-dict names,
are the same with and without it, so checkpoints interchange. The JAX
package's `_maybe_remat` also wraps the ConvLSTM front; here it is left
out, because rematerializing it frees nothing: `ops.convlstm.convlstm_fused`
already keeps only its inputs (x, the merged kernel, the bias) for the
backward, which recomputes the states itself, so a checkpoint around the
front would keep the same inputs and only add a second forward (6 kernel
launches a net and step at 6 echoes).

Layouts are the JAX package's: the UNet returns (nb, 1, H, W, n_out) with
`me_layer` (with `bayesian` a `prob.Normal` of two such maps for a tanh
head, a `prob.Rician` otherwise; the pair
(out, σ) with `std_out`), (nb, H, W, n_out) on a 4-D input and (nb, ne, H,
W, n_out) on a folded 5-D one; VET-Net returns (nb, 1, H, W, [FM, R2*])
with `me_layer` and [R2*, FM] channel-last without it (folded as the
UNet); MDWF-Net takes the legacy 4-D input and returns (nb, H, W, [|W|,
|F|, R2*, FM]). Inside, activations are NCHW. H and W must be divisible by
2**num_layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..prob import Normal, Rician
from .attention import SelfAttention, adain
from .blocks import (ConvBlock, TEEncoder, Upsample, dtype_conv,
                     get_activation, he_normal_, init_params)
from .convlstm import ConvLSTM

ME = "me"  # the layout tag of the ConvLSTM front's (nb, 1, H, W, C) output


def _run(remat: bool, module: nn.Module, *args):
    """`module(*args)`, rematerialized in the backward under `remat` (and a
    gradient): its activations are recomputed instead of kept."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


def _front(lstm, x):
    """A net's input as the NCHW input of its first block, and the tag of
    its output layout: the ConvLSTM's final state (`ME`) with a front (never
    rematerialized: the module docstring says why); a 5-D (nb, ne, H, W, C)
    folded into nb·ne images, tagged (nb, ne); the legacy 4-D (nb, H, W, C)
    as it is, tagged None."""
    if lstm is not None:
        return lstm(x), ME
    if x.ndim == 5:
        nb, ne = x.shape[:2]
        x = x.reshape(nb * ne, *x.shape[2:])
        return x.permute(0, 3, 1, 2).contiguous(), (nb, ne)
    return x.permute(0, 3, 1, 2).contiguous(), None


def _back(out, layout):
    """NCHW head output → the layout `_front` tagged."""
    out = out.permute(0, 2, 3, 1)
    if layout == ME:
        return out[:, None]
    if layout is not None:
        return out.reshape(*layout, *out.shape[1:])
    return out


class _SigmaHead(nn.Module):
    """The σ head: Conv 1×1 to 16, ReLU, Conv 1×1 to n_out, sigmoid, with
    Flax's He-uniform and He-normal kernels and zero biases."""

    def __init__(self, in_channels: int, n_out: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_channels, 16, 1)
        self.conv2 = nn.Conv2d(16, n_out, 1)

    def forward(self, x):
        x = F.relu(dtype_conv(self.conv1, x, self.dtype))
        return torch.sigmoid(dtype_conv(self.conv2, x, self.dtype))

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
                 self_attention: bool = False, norm: str = "instance_norm",
                 dtype=None, remat: bool = False):
        super().__init__()
        unported = {"cse_layer": cse_layer,
                    "skip_con=False": not skip_con, "dropout": dropout > 0}
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"UNet options {bad} are not ported yet (ROADMAP Queue 1)")
        self.num_layers = num_layers
        self.output_activation = output_activation
        self.te_input = te_input
        self.bayesian = bayesian
        self.dtype, self.remat = dtype, remat
        self.lstm = ConvLSTM(in_channels, filters, dtype=dtype) \
            if me_layer else None
        self.down = nn.ModuleList()
        self.te = nn.ModuleList() if te_input else None
        cin, f = (filters if me_layer else in_channels), filters
        for _ in range(num_layers):
            self.down.append(ConvBlock(cin, f, norm=norm, dtype=dtype))
            if te_input:
                self.te.append(TEEncoder(f))
            cin, f = f, 2 * f
        self.bottom = ConvBlock(cin, f, norm=norm, dtype=dtype)
        self.up = nn.ModuleList()
        self.dec = nn.ModuleList()
        self.attn = None
        for level in range(num_layers):
            self.up.append(Upsample(f, f // 2, dtype=dtype))
            if self_attention and level == 0:
                self.attn = SelfAttention(f, dtype=dtype)
            self.dec.append(ConvBlock(f, f // 2, norm=norm, dtype=dtype))
            f //= 2
        self.head = nn.Conv2d(f, n_out, 1)
        self.sigma = _SigmaHead(f, n_out, dtype) if bayesian or std_out \
            else None

    def forward(self, x, te=None):
        """x (nb, ne, H, W, Cin) with `me_layer`, else (nb, H, W, Cin) or
        (nb, ne, H, W, Cin); te (nb, ne), needed with `te_input`."""
        if self.te_input and te is None:
            raise ValueError("UNet(te_input=True) needs the TE vector")
        remat = self.remat
        x, layout = _front(self.lstm, x)
        skips = []
        for level, block in enumerate(self.down):
            x = _run(remat, block, x)
            if self.te is not None:
                x = adain(x, self.te[level](te))
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = _run(remat, self.bottom, x)
        for level, (up, block) in enumerate(zip(self.up, self.dec)):
            x = torch.cat([_run(remat, up, x), skips[-1 - level]], dim=1)
            if self.attn is not None and level == 0:
                x = self.attn(x)
            x = _run(remat, block, x)
        out = dtype_conv(self.head, x, self.dtype)
        out = _back(get_activation(self.output_activation)(out), layout)
        if self.sigma is None:
            return out
        sigma = _back(self.sigma(x), layout)
        if not self.bayesian:
            return out, sigma
        if self.output_activation == "tanh":
            return Normal(loc=out, scale=sigma)
        return Rician(nu=out, sigma=sigma)

    def init_params(self, generator: torch.Generator) -> None:
        init_params(self, generator)


class _SharedEncoder(nn.Module):
    """The encoder trunk of the multi-decoder generators: `num_layers`
    conv blocks, each followed by a 2×2 max-pool, then the bottom block.
    With `te_input`, TE conditioning in one of the JAX package's two
    modes: "adain", AdaIN after every level's block towards its own
    TEEncoder's style; "dense_l1", Dense(TE vector of `n_echoes`) + ReLU
    broadcast over the grid and added after level 1's max-pool (its
    width, 2·filters). Returns (x, skips)."""

    def __init__(self, in_channels: int, filters: int, num_layers: int,
                 te_input: bool, te_mode: str = "adain",
                 n_echoes: int | None = None, dtype=None,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if te_mode not in ("adain", "dense_l1"):
            raise ValueError(f"unknown TE mode {te_mode!r}")
        self.blocks = nn.ModuleList()
        adain_te = te_input and te_mode == "adain"
        self.te = nn.ModuleList() if adain_te else None
        self.te_dense = (nn.Linear(n_echoes, 2 * filters)
                         if te_input and te_mode == "dense_l1" else None)
        cin, f = in_channels, filters
        for _ in range(num_layers):
            self.blocks.append(ConvBlock(cin, f, dtype=dtype))
            if adain_te:
                self.te.append(TEEncoder(f))
            cin, f = f, 2 * f
        self.bottom = ConvBlock(cin, f, dtype=dtype)

    def forward(self, x, te=None):
        skips = []
        for level, block in enumerate(self.blocks):
            x = _run(self.remat, block, x)
            if self.te is not None:
                x = adain(x, self.te[level](te))
            skips.append(x)
            x = F.max_pool2d(x, 2)
            if self.te_dense is not None and level == 1:
                te_vec = te[..., 0] if te.ndim == 3 else te
                y = F.relu(self.te_dense(
                    te_vec.to(self.te_dense.weight.dtype)))
                x = x + y[:, :, None, None]
        return _run(self.remat, self.bottom, x), skips

    def init_params(self, generator: torch.Generator) -> None:
        """`models.init_params` on the blocks and TEEncoders; the Dense's
        kernel He-uniform (Flax's), its bias 0."""
        init_params(self, generator)
        if self.te_dense is not None:
            with torch.no_grad():
                bound = math.sqrt(6.0 / self.te_dense.in_features)
                nn.init.uniform_(self.te_dense.weight, -bound, bound,
                                 generator=generator)
                nn.init.zeros_(self.te_dense.bias)


class _Decoder(nn.Module):
    """One decoder branch: per level upsample → concat skip →
    (self-attention at level 0) → conv block; 1×1 head to `n_out` channels
    and its activation. NCHW in and out."""

    def __init__(self, filters_top: int, num_layers: int,
                 head_activation: str, self_attention: bool, n_out: int = 1,
                 dtype=None, remat: bool = False):
        super().__init__()
        self.head_activation = head_activation
        self.dtype, self.remat = dtype, remat
        self.up = nn.ModuleList()
        self.blocks = nn.ModuleList()
        self.attn = None
        f = filters_top
        for level in range(num_layers):
            self.up.append(Upsample(f, f // 2, dtype=dtype))
            if self_attention and level == 0:
                self.attn = SelfAttention(f, dtype=dtype)
            self.blocks.append(ConvBlock(f, f // 2, dtype=dtype))
            f //= 2
        self.head = nn.Conv2d(f, n_out, 1)

    def forward(self, x, skips):
        for level, (up, block) in enumerate(zip(self.up, self.blocks)):
            x = torch.cat([_run(self.remat, up, x), skips[-1 - level]], dim=1)
            if self.attn is not None and level == 0:
                x = self.attn(x)
            x = _run(self.remat, block, x)
        return get_activation(self.head_activation)(
            dtype_conv(self.head, x, self.dtype))


class MDWFNet(nn.Module):
    """The reference `MDWF_Generator`: the shared encoder with, under
    `te_input`, the "dense_l1" TE conditioning, and three decoders.
    `forward(x, te)` takes the legacy (nb, H, W, Cin) input and the TE
    vector (nb, ne) and returns (nb, H, W, [|W|, |F| sigmoid, R2* relu,
    FM tanh])."""

    def __init__(self, in_channels: int, filters: int = 72,
                 num_layers: int = 4, te_input: bool = False,
                 n_echoes: int = 6, wf_self_attention: bool = False,
                 r2_self_attention: bool = False,
                 fm_self_attention: bool = True, dtype=None,
                 remat: bool = False):
        super().__init__()
        self.te_input = te_input
        self.encoder = _SharedEncoder(in_channels, filters, num_layers,
                                      te_input, "dense_l1", n_echoes, dtype,
                                      remat)
        ftop = filters * 2 ** num_layers
        kw = dict(dtype=dtype, remat=remat)
        self.dec_wf = _Decoder(ftop, num_layers, "sigmoid",
                               wf_self_attention, n_out=2, **kw)
        self.dec_r2 = _Decoder(ftop, num_layers, "relu", r2_self_attention,
                               **kw)
        self.dec_fm = _Decoder(ftop, num_layers, "tanh", fm_self_attention,
                               **kw)

    def forward(self, x, te=None):
        if x.ndim != 4:
            raise ValueError(f"MDWFNet takes the legacy (nb, H, W, C) "
                             f"layout, got {tuple(x.shape)}")
        if self.te_input and te is None:
            raise ValueError("MDWFNet(te_input=True) needs the TE vector")
        x, skips = self.encoder(_front(None, x)[0], te)
        out = torch.cat([dec(x, skips) for dec in
                         (self.dec_wf, self.dec_r2, self.dec_fm)], dim=1)
        return _back(out, None)

    def init_params(self, generator: torch.Generator) -> None:
        init_params(self, generator)


class VETNet(nn.Module):
    """The reference `PM_Generator`, VET-Net with `te_input=True`: with
    `me_layer` the ConvLSTM multi-echo front, shared encoder with LSTM→AdaIN
    TE conditioning, two decoders of `n_out` channels (R2* sigmoid, field
    map tanh). `forward(x, te)` takes echoes (nb, ne, H, W, Cin) and the TE
    vector (nb, ne) and returns (nb, 1, H, W, [FM, R2*]); without
    `me_layer` it takes (nb, H, W, Cin) or folds (nb, ne, H, W, Cin) and
    returns [R2*, FM] channel-last, as the JAX package."""

    def __init__(self, in_channels: int, te_input: bool = False,
                 filters: int = 72, num_layers: int = 4,
                 r2_self_attention: bool = False,
                 fm_self_attention: bool = True, me_layer: bool = True,
                 n_out: int = 1, dtype=None, remat: bool = False):
        super().__init__()
        self.te_input = te_input
        self.remat = remat
        self.lstm = ConvLSTM(in_channels, filters, dtype=dtype) \
            if me_layer else None
        self.encoder = _SharedEncoder(filters if me_layer else in_channels,
                                      filters, num_layers, te_input,
                                      dtype=dtype, remat=remat)
        ftop = filters * 2 ** num_layers
        self.dec_r2 = _Decoder(ftop, num_layers, "sigmoid", r2_self_attention,
                               n_out, dtype, remat)
        self.dec_fm = _Decoder(ftop, num_layers, "tanh", fm_self_attention,
                               n_out, dtype, remat)

    def forward(self, x, te=None):
        if self.te_input and te is None:
            raise ValueError("VETNet(te_input=True) needs the TE vector")
        x, layout = _front(self.lstm, x)
        x, skips = self.encoder(x, te)
        r2, fm = self.dec_r2(x, skips), self.dec_fm(x, skips)
        out = [fm, r2] if layout == ME else [r2, fm]
        return _back(torch.cat(out, dim=1), layout)

    def init_params(self, generator: torch.Generator) -> None:
        init_params(self, generator)
