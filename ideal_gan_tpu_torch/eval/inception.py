"""The InceptionV3 feature extractor (port of
`ideal_gan_tpu/eval/inception.py`): the trunk of keras' InceptionV3 with
its batch norms folded into a per-channel affine, returning the
global-average-pooled 2048 features, the reference's FID embedding.

Images cross it as (n, H, W, 3); inside, activations are NCHW. Each
convolution is one of the JAX module's `_ConvBN`s (no bias, then scale,
bias and relu), "SAME" (Flax's, so the 1×7, 7×1, 1×3 and 3×1 ones pad
along one axis) or "VALID"; the 3×3 stride-1 average pools are "SAME" and
count the padded zeros, as Flax's `avg_pool` does; the max-pools are 3×3
stride 2 "VALID". The blocks keep their `_ConvBN`s in `convs` in the JAX
module's creation order, so `convert.inception_v3` maps `_ConvBN_i` to
`convs.i`.

ImageNet weights are not downloaded: `init_inception_v3` loads them from
`weights/inception_v3.npz` where one exists (`metrics.weights_path`), else
initializes the trunk from a fixed-seed generator and logs that FID is then
relative only, as the JAX package does (its random init comes from
`PRNGKey(4321)`, which a `torch.Generator` cannot reproduce;
`convert.inception_v3` carries those variables across).
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F
from torch import nn

from .. import convert
from ..models.blocks import same_conv2d
from .metrics import resize_to, weights_path


class _ConvBN(nn.Module):
    """A convolution without bias, the folded batch norm (`scale`, `bias`)
    and relu."""

    def __init__(self, in_channels: int, features: int, kernel,
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(features, in_channels, kh, kw))
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if self.padding == "SAME":
            x = same_conv2d(x, self.weight, None, self.stride)
        else:
            x = F.conv2d(x, self.weight, None, self.stride)
        return F.relu(x * self.scale[:, None, None]
                      + self.bias[:, None, None])


def _avg_pool_same(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


def _max_pool_valid(x):
    return F.max_pool2d(x, 3, 2)


class _InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.convs = nn.ModuleList([
            _ConvBN(cin, 64, 1), _ConvBN(cin, 48, 1), _ConvBN(48, 64, 5),
            _ConvBN(cin, 64, 1), _ConvBN(64, 96, 3), _ConvBN(96, 96, 3),
            _ConvBN(cin, pool_features, 1)])

    def forward(self, x):
        c = self.convs
        return torch.cat([c[0](x), c[2](c[1](x)), c[5](c[4](c[3](x))),
                          c[6](_avg_pool_same(x))], dim=1)


class _InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            _ConvBN(cin, 384, 3, 2, "VALID"), _ConvBN(cin, 64, 1),
            _ConvBN(64, 96, 3), _ConvBN(96, 96, 3, 2, "VALID")])

    def forward(self, x):
        c = self.convs
        return torch.cat([c[0](x), c[3](c[2](c[1](x))), _max_pool_valid(x)],
                         dim=1)


class _InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.convs = nn.ModuleList([
            _ConvBN(cin, 192, 1),
            _ConvBN(cin, c7, 1), _ConvBN(c7, c7, (1, 7)),
            _ConvBN(c7, 192, (7, 1)),
            _ConvBN(cin, c7, 1), _ConvBN(c7, c7, (7, 1)),
            _ConvBN(c7, c7, (1, 7)), _ConvBN(c7, c7, (7, 1)),
            _ConvBN(c7, 192, (1, 7)),
            _ConvBN(cin, 192, 1)])

    def forward(self, x):
        c = self.convs
        b3 = x
        for i in range(4, 9):
            b3 = c[i](b3)
        return torch.cat([c[0](x), c[3](c[2](c[1](x))), b3,
                          c[9](_avg_pool_same(x))], dim=1)


class _InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            _ConvBN(cin, 192, 1), _ConvBN(192, 320, 3, 2, "VALID"),
            _ConvBN(cin, 192, 1), _ConvBN(192, 192, (1, 7)),
            _ConvBN(192, 192, (7, 1)), _ConvBN(192, 192, 3, 2, "VALID")])

    def forward(self, x):
        c = self.convs
        return torch.cat([c[1](c[0](x)), c[5](c[4](c[3](c[2](x)))),
                          _max_pool_valid(x)], dim=1)


class _InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.convs = nn.ModuleList([
            _ConvBN(cin, 320, 1),
            _ConvBN(cin, 384, 1), _ConvBN(384, 384, (1, 3)),
            _ConvBN(384, 384, (3, 1)),
            _ConvBN(cin, 448, 1), _ConvBN(448, 384, 3),
            _ConvBN(384, 384, (1, 3)), _ConvBN(384, 384, (3, 1)),
            _ConvBN(cin, 192, 1)])

    def forward(self, x):
        c = self.convs
        b2 = c[1](x)
        b3 = c[5](c[4](x))
        return torch.cat([c[0](x), c[2](b2), c[3](b2), c[6](b3), c[7](b3),
                          c[8](_avg_pool_same(x))], dim=1)


class InceptionV3Features(nn.Module):
    """The InceptionV3 trunk: (n, H, W, 3) → (n, 2048) (H, W ≥ 75)."""

    def __init__(self):
        super().__init__()
        self.stem = nn.ModuleList([
            _ConvBN(3, 32, 3, 2, "VALID"), _ConvBN(32, 32, 3, 1, "VALID"),
            _ConvBN(32, 64, 3), _ConvBN(64, 80, 1, 1, "VALID"),
            _ConvBN(80, 192, 3, 1, "VALID")])
        self.mixed = nn.ModuleList([
            _InceptionA(192, 32), _InceptionA(256, 64), _InceptionA(288, 64),
            _InceptionB(288),
            *[_InceptionC(768, c7) for c7 in (128, 160, 160, 192)],
            _InceptionD(768), _InceptionE(1280), _InceptionE(2048)])

    def forward(self, x):
        s = self.stem
        x = s[2](s[1](s[0](x.permute(0, 3, 1, 2))))
        x = s[4](s[3](_max_pool_valid(x)))
        x = _max_pool_valid(x)
        for block in self.mixed:
            x = block(x)
        return x.mean(dim=(2, 3))


def inception_preprocess(x_rgb01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB → [−1, 1] (keras' inception_v3.preprocess_input)."""
    return x_rgb01 * 2.0 - 1.0


def load_inception_npz(path: str) -> dict:
    """The Flax variables {"params": tree} from an npz of `/`-joined
    parameter paths (the JAX package's layout); `convert.inception_v3`
    turns them into the state dict."""
    return {"params": convert.load_npz(path)}


def init_inception_v3(generator: torch.Generator | None = None
                      ) -> InceptionV3Features:
    """The frozen InceptionV3 feature extractor (on the CPU; the caller moves
    it): converted ImageNet weights where `weights/inception_v3.npz` exists,
    else a fixed-seed random init (LeCun-normal kernels, Flax's default; unit
    scales, zero biases) from `generator` (seed 4321 by default), which is
    logged: FID against random features is relative only."""
    model = InceptionV3Features()
    path = weights_path("inception_v3.npz")
    if path is not None:
        model.load_state_dict(convert.inception_v3(load_inception_npz(path)))
        return model.requires_grad_(False)
    logging.getLogger(__name__).warning(
        "InceptionV3: no pretrained weights found (weights/inception_v3.npz) "
        "— using fixed-seed RANDOM init; FID values are relative only.")
    gen = generator or torch.Generator().manual_seed(4321)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, _ConvBN):
                nn.init.normal_(m.weight, 0.0, m.weight[0].numel() ** -0.5,
                                generator=gen)
    return model.requires_grad_(False)


def echoes_to_inception_input(x: torch.Tensor, size: int = 139
                              ) -> torch.Tensor:
    """Echoes (nb, ne, H, W, 2) or (n, H, W, 2) → the inception input: the
    echoes folded into the batch, resized (`metrics.resize_to`, Lanczos-3
    with antialiasing), the channels [re·½ + ½, |z|, im·½ + ½], then
    `inception_preprocess`."""
    if x.ndim == 5:
        x = x.reshape((-1,) + tuple(x.shape[2:]))
    x = resize_to(x, size)
    mag = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    rgb01 = torch.cat([x[..., :1] * 0.5 + 0.5, mag, x[..., 1:2] * 0.5 + 0.5],
                      dim=-1)
    return inception_preprocess(rgb01)

