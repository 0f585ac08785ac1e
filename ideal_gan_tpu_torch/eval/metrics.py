"""The generative metrics (port of `ideal_gan_tpu/eval/metrics.py`): the
VGG19 feature extractor, its weights loader, `resize_to`,
`echoes_to_vgg_input`, `perceptual_cosine_loss`, `covariance_map`, and the
generative-quality metrics of `cli.test_genmetrics`: FID
(`frechet_distance` on the host, scipy's `sqrtm`, with the JAX package's
fixed ε branch; `FIDAccumulator`), the linear-kernel MMD, and SSIM and
MS-SSIM with `tf.image.ssim`'s semantics (an 11×11 Gaussian window, σ 1.5,
VALID; 2×2 average pooling between the five scales). Images cross these
functions as (n, H, W, C).

- `VGG19Features`: the VGG19 conv trunk (16 3×3 convolutions with ReLU, 2×2
  max-pools) returning the feature maps at `taps` (NCHW). `init_vgg19`
  loads converted ImageNet weights from `weights/vgg19.npz` (the JAX
  package's layout: conv_{i}_kernel HWIO, conv_{i}_bias) when one exists
  (`weights_path`), else initializes from a fixed-seed generator and logs
  that the perceptual loss is then relative only, as the JAX package does.
  The JAX package's random init comes from `PRNGKey(1234)`, which a
  `torch.Generator` cannot reproduce: `convert.vgg19` carries those
  variables across where the two must agree.
- `resize_to`: `jax.image.resize(..., "lanczos3", antialias=True)` as two
  products with separable weight matrices built on the host once per
  (input, output) size exactly as `jax.image.scale_and_translate` builds
  them: the Lanczos-3 kernel stretched by max(in/out, 1) when shrinking,
  each output's weights normalized to sum to 1 (0 where the sum is ≤ 1000
  float32 ε), and outputs whose sample falls outside the input zeroed.
"""

from __future__ import annotations

import functools
import logging
import os
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
# Keras layer indices [2, 5, 8, 13, 18] → block1_conv2, block2_conv2,
# block3_conv2, block4_conv2, block5_conv2 in the flat conv order
_DEFAULT_TAPS = (1, 3, 5, 9, 13)

_IMAGENET_MEAN_BGR = (103.939, 116.779, 123.68)


class VGG19Features(nn.Module):
    """Input (n, H, W, 3) caffe-style (`vgg_preprocess`); returns the NCHW
    feature maps at `taps`, indices into the flat list of 16 convs."""

    def __init__(self, taps: Sequence[int] = _DEFAULT_TAPS):
        super().__init__()
        self.taps = tuple(taps)
        widths = [v for v in _VGG19_CFG if v != "M"]
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 3, padding=1)
            for cin, cout in zip([3] + widths[:-1], widths))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        feats, i = [], 0
        for v in _VGG19_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2)
                continue
            x = F.relu(self.convs[i](x))
            if i in self.taps:
                feats.append(x)
            i += 1
        return feats


def vgg_preprocess(x_rgb01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (…, 3) → caffe BGR with the ImageNet means subtracted."""
    x_bgr = (255.0 * x_rgb01).flip(-1)
    return x_bgr - x_bgr.new_tensor(_IMAGENET_MEAN_BGR)


def weights_path(name: str):
    """A converted-weights npz: $IDEAL_GAN_TPU_WEIGHTS_DIR/<name> or
    <repo>/weights/<name>; None where neither exists."""
    cands = []
    env = os.environ.get("IDEAL_GAN_TPU_WEIGHTS_DIR")
    if env:
        cands.append(Path(env) / name)
    cands.append(Path(__file__).resolve().parents[2] / "weights" / name)
    for c in cands:
        if c.exists():
            return str(c)
    return None


def load_vgg19_npz(path: str) -> dict:
    """The state dict of `VGG19Features` from an npz of conv_{i}_kernel
    (HWIO) and conv_{i}_bias arrays."""
    with np.load(path) as data:
        sd = {}
        for i in range(16):
            k = np.asarray(data[f"conv_{i}_kernel"], np.float32)
            sd[f"convs.{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))
            sd[f"convs.{i}.bias"] = torch.from_numpy(
                np.asarray(data[f"conv_{i}_bias"], np.float32))
    return sd


def feature_source(name: str = "vgg19") -> str:
    """"imagenet" where a converted artifact exists, else "random-init":
    a metric from random features is relative only."""
    return "imagenet" if weights_path(f"{name}.npz") is not None \
        else "random-init"


def init_vgg19(generator: torch.Generator | None = None,
               taps: Sequence[int] = _DEFAULT_TAPS) -> VGG19Features:
    """The frozen VGG19 feature extractor (on the CPU; the caller moves it):
    converted ImageNet weights where `weights/vgg19.npz` exists, else a
    fixed-seed random init (LeCun-normal kernels, zero biases, Flax's
    default initializers) from `generator` (seed 1234 by default), which is
    logged."""
    model = VGG19Features(taps)
    path = weights_path("vgg19.npz")
    if path is not None:
        model.load_state_dict(load_vgg19_npz(path))
    else:
        logging.getLogger(__name__).warning(
            "VGG19: no pretrained weights found (weights/vgg19.npz) — using "
            "fixed-seed RANDOM init; perceptual losses/metrics are relative "
            "only.")
        gen = generator or torch.Generator().manual_seed(1234)
        with torch.no_grad():
            for conv in model.convs:
                nn.init.normal_(conv.weight, 0.0,
                                conv.weight[0].numel() ** -0.5,
                                generator=gen)
                nn.init.zeros_(conv.bias)
    return model.requires_grad_(False)


@functools.lru_cache(maxsize=None)
def lanczos3_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (in_size, out_size) weights of a Lanczos-3 antialiased resize
    along one axis, as `jax.image.scale_and_translate` builds them (module
    docstring), in float64."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    radius = 3.0
    with np.errstate(divide="ignore", invalid="ignore"):
        y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
        w = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1.0),
                     1.0)
    w = np.where(x > radius, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_to(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(n, H, W, c) → (n, size, size, c), Lanczos-3 with antialiasing
    (`jax.image.resize`'s "lanczos3"): out = Whᵀ · x · Ww per image and
    channel."""
    n, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)
    if h != size:
        wh = torch.from_numpy(lanczos3_weights(h, size)).to(x)
        xc = torch.matmul(wh.T, xc)
    if w != size:
        ww = torch.from_numpy(lanczos3_weights(w, size)).to(x)
        xc = torch.matmul(xc, ww)
    return xc.permute(0, 2, 3, 1)


def echoes_to_vgg_input(x: torch.Tensor, only_mag: bool = False,
                        size: int = 224) -> torch.Tensor:
    """Echoes (nb, ne, H, W, 2) → VGG input: echoes folded into the batch,
    resized, three channels (re, re, im) shifted to [0, 1] (or the
    magnitude three times), then `vgg_preprocess`."""
    if x.ndim == 5:
        x = x.reshape((-1,) + tuple(x.shape[2:]))
    x = resize_to(x, size)
    if only_mag:
        mag = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
        rgb01 = torch.cat([mag, mag, mag], dim=-1)
    else:
        r = x[..., :1] * 0.5 + 0.5
        i = x[..., 1:2] * 0.5 + 0.5
        rgb01 = torch.cat([r, r, i], dim=-1)
    return vgg_preprocess(rgb01)


def perceptual_cosine_loss(feats_a, feats_b) -> torch.Tensor:
    """Mean over the feature layers of the batch mean of 1 − cosine
    similarity of the flattened features (norms + 1e-8)."""
    total = 0.0
    for fa, fb in zip(feats_a, feats_b):
        fa = fa.reshape(fa.shape[0], -1)
        fb = fb.reshape(fb.shape[0], -1)
        na = torch.linalg.vector_norm(fa, dim=1) + 1e-8
        nb_ = torch.linalg.vector_norm(fb, dim=1) + 1e-8
        cos = torch.sum(fa * fb, dim=1) / (na * nb_)
        total = total + torch.mean(1.0 - cos)
    return total / len(feats_a)


def covariance_map(x: torch.Tensor) -> torch.Tensor:
    """The latent covariance of the whitening regularizer: each sample
    flattened, the batch mean of the outer products of the centered
    vectors, (1, D, D) — (nb, D, D) in between, as the JAX package computes
    it."""
    x = x.reshape(x.shape[0], -1)
    d = x - torch.mean(x, dim=0, keepdim=True)
    cov = d[:, :, None] @ d[:, None, :]
    return torch.mean(cov, dim=0, keepdim=True)


def frechet_distance(mu_x, sigma_x, mu_y, sigma_y,
                     epsilon: float = 1e-6) -> float:
    """The Fréchet distance between two Gaussians, on the host (numpy,
    scipy's `sqrtm`); where the product's square root is not finite, the
    covariances are offset by ε·I (the JAX package's fix of the reference's
    inverted check)."""
    from scipy import linalg as sla
    mu_x, sigma_x = np.asarray(mu_x), np.asarray(sigma_x)
    mu_y, sigma_y = np.asarray(mu_y), np.asarray(sigma_y)
    diff = mu_x - mu_y
    covmean = sla.sqrtm(sigma_x @ sigma_y)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma_x.shape[0]) * epsilon
        covmean = sla.sqrtm((sigma_x + offset) @ (sigma_y + offset))
    covmean = np.real(covmean)
    return float(diff @ diff + np.trace(sigma_x) + np.trace(sigma_y)
                 - 2.0 * np.trace(covmean))


class FIDAccumulator:
    """Streaming FID: feature batches (tensors or arrays) collected on the
    host, the distance computed at the end."""

    def __init__(self):
        self._real = []
        self._fake = []

    @staticmethod
    def _host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def update(self, real_feats, fake_feats) -> None:
        self._real.append(self._host(real_feats))
        self._fake.append(self._host(fake_feats))

    def result(self) -> float:
        real = np.concatenate(self._real)
        fake = np.concatenate(self._fake)
        return frechet_distance(real.mean(0), np.cov(real, rowvar=False),
                                fake.mean(0), np.cov(fake, rowvar=False))


def mmd_linear(y_true: torch.Tensor, y_pred: torch.Tensor, beta: float = 1.0,
               gamma: float = 2.0) -> torch.Tensor:
    """Linear-kernel MMD: β·(mean K_tt + mean K_pp) − γ·mean K_pt, K = X·Yᵀ
    / d over the flattened samples."""
    yt = y_true.reshape(y_true.shape[0], -1).float()
    yp = y_pred.reshape(y_pred.shape[0], -1).float()
    d = yt.shape[1]
    k_tt = (yt @ yt.T) / d
    k_pp = (yp @ yp.T) / d
    k_pt = (yp @ yt.T) / d
    return beta * (torch.mean(k_tt) + torch.mean(k_pp)) \
        - gamma * torch.mean(k_pt)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-0.5 * torch.square(x / sigma))
    g = g / torch.sum(g)
    return g[:, None] * g[None, :]


def _filter2d(x: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID convolution of NCHW `x` with one 2-D kernel."""
    c = x.shape[1]
    return F.conv2d(x, kern.expand(c, 1, *kern.shape), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03, return_cs: bool = False):
    """Per-image SSIM of (n, H, W, C) images (`tf.image.ssim`'s
    semantics); with `return_cs` also the mean contrast-structure term."""
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    kern = _gaussian_kernel(kernel_size, sigma, a.device)
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_a = _filter2d(a, kern)
    mu_b = _filter2d(b, kern)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    var_a = _filter2d(a * a, kern) - mu_aa
    var_b = _filter2d(b * b, kern) - mu_bb
    cov = _filter2d(a * b, kern) - mu_ab
    cs = (2.0 * cov + c2) / (var_a + var_b + c2)
    lum = (2.0 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    ssim_map = lum * cs
    dims = (1, 2, 3)
    if return_cs:
        return torch.mean(ssim_map, dims), torch.mean(cs, dims)
    return torch.mean(ssim_map, dims)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
            weights=(0.0448, 0.2856, 0.3001, 0.2363, 0.1333)) -> torch.Tensor:
    """Multi-scale SSIM of (n, H, W, C) images (`tf.image.ssim_multiscale`'s
    semantics): the contrast-structure terms of the first scales and the
    SSIM of the last, each clipped at 0, to the powers `weights`; 2×2
    average pooling between scales (the 11×11 window needs H, W ≥ 176 at
    five scales)."""
    w = torch.tensor(weights, dtype=torch.float32, device=a.device)
    levels = len(weights)
    vals = []
    for i in range(levels):
        s, cs = ssim(a, b, max_val, return_cs=True)
        vals.append(torch.clamp(s if i == levels - 1 else cs, min=0.0))
        if i < levels - 1:
            a, b = (F.avg_pool2d(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
                    for t in (a, b))
    vals = torch.stack(vals)  # (levels, n)
    return torch.prod(vals ** w[:, None], dim=0)
