"""The latent-diffusion denoising U-Net (port of
`ideal_gan_tpu/models/ldm.py`).

Per resolution: a class-conditioning plane concatenated → 2 × ResnetBlock
with the time FiLM (γ, β) → residual pre-norm LinearAttention → a 4×4
stride-2 convolution down; the mid block with full softmax attention; the
way up with the skips and 4×4 stride-2 transpose convolutions; a sinusoidal
time embedding → MLP. Tensors are NCHW inside; `DenoiseUNet` takes and
returns latents (nb, h, w, C), as the JAX module does.

What carries over from Flax, exactly:
- Every convolution pads as Flax's "SAME" (`SameConv2d`); the 4×4 stride-2
  one pads (1, 1) at even sizes.
- Flax's `ConvTranspose(4, 4, stride 2, "SAME")` does not flip its kernel:
  it equals `conv_transpose2d(stride=2, padding=1)` on the spatially
  flipped kernel, which `convert.conv_transpose_kernel` does.
- The class planes are there with and without `num_classes`: without it
  the class embedding is zeros, so each level's plane is silu of its
  Dense's bias, and the parameters exist in both modes.
- The attentions' head split of the hidden channels is (heads, dim_head)
  and the spatial flattening row-major (h, w) in both layouts; the mid
  attention subtracts the max *value* of the logits (the JAX package's
  fix of the reference's arg-max index), with JAX's order of operations.
- GroupNorm(8, ε 1e-5) and the channel LayerNorm (ε 1e-5, biased
  variance).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import SameConv2d


def sinusoidal_pos_emb(t: torch.Tensor, dim: int,
                       max_positions: int = 10000) -> torch.Tensor:
    half = dim // 2
    emb = math.log(max_positions) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) * -emb)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class LayerNorm(nn.Module):
    """Channel layer norm with a (1, C, 1, 1) affine."""

    def __init__(self, channels: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, channels, 1, 1))

    def forward(self, x):
        mean = torch.mean(x, dim=1, keepdim=True)
        var = torch.var(x, dim=1, keepdim=True, unbiased=False)
        return (x - mean) / torch.sqrt(var + 1e-5) * self.g + self.b


class Block(nn.Module):
    """3×3 conv → GroupNorm → FiLM x·(γ + 1) + β → SiLU."""

    def __init__(self, in_channels: int, dim: int, groups: int = 8):
        super().__init__()
        self.conv = SameConv2d(in_channels, dim, 3)
        self.norm = nn.GroupNorm(groups, dim, eps=1e-5)

    def forward(self, x, gamma_beta=None):
        x = self.norm(self.conv(x))
        if gamma_beta is not None:
            gamma, beta = gamma_beta
            x = x * (gamma + 1.0) + beta
        return F.silu(x)


class ResnetBlock(nn.Module):
    """Two `Block`s, the first FiLM-modulated by Dense(silu(t)) where
    `time_dim` is given, plus the input (1×1-projected where the widths
    differ)."""

    def __init__(self, in_channels: int, dim_out: int,
                 time_dim: Optional[int] = None, groups: int = 8):
        super().__init__()
        self.mlp = nn.Linear(time_dim, dim_out * 2) if time_dim else None
        self.block1 = Block(in_channels, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = SameConv2d(in_channels, dim_out, 1) \
            if in_channels != dim_out else None

    def forward(self, x, t=None):
        gamma_beta = None
        if self.mlp is not None and t is not None:
            te = self.mlp(F.silu(t))[:, :, None, None]
            gamma_beta = torch.chunk(te, 2, dim=1)
        h = self.block2(self.block1(x, gamma_beta))
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class LinearAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = SameConv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = SameConv2d(hidden, dim, 1)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, self.dim_head, h * w)
                   for t in torch.chunk(self.to_qkv(x), 3, dim=1))
        q = torch.softmax(q, dim=-2) * (self.dim_head ** -0.5)
        k = torch.softmax(k, dim=-1)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        out = out.reshape(b, self.heads * self.dim_head, h, w)
        return self.norm(self.to_out(out))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = SameConv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = SameConv2d(hidden, dim, 1)

    def forward(self, x):
        b, _, h, w = x.shape
        q, k, v = (t.reshape(b, self.heads, self.dim_head, h * w)
                   .transpose(-1, -2)  # (b, heads, n, d)
                   for t in torch.chunk(self.to_qkv(x), 3, dim=1))
        sim = torch.einsum("bhid,bhjd->bhij", q * (self.dim_head ** -0.5), k)
        sim = sim - torch.amax(sim, dim=-1, keepdim=True).detach()
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        out = out.transpose(-1, -2).reshape(b, self.heads * self.dim_head,
                                            h, w)
        return self.to_out(out)


class ClassConditioning(nn.Module):
    """Class embedding → Dense(res²) → SiLU → one (1, res, res) plane."""

    def __init__(self, emb_dim: int, res: int):
        super().__init__()
        self.res = res
        self.dense = nn.Linear(emb_dim, res * res)

    def forward(self, emb):
        return F.silu(self.dense(emb)).reshape(-1, 1, self.res, self.res)


class _Level(nn.Module):
    """One resolution: the class plane, two ResnetBlocks, the residual
    pre-norm LinearAttention, and the resampling convolution (None at the
    innermost level down and at the outermost up)."""

    def __init__(self, in_channels: int, dim_out: int, time_dim: int,
                 groups: int, emb_dim: int, res: int, resample=None):
        super().__init__()
        self.cond = ClassConditioning(emb_dim, res)
        self.block1 = ResnetBlock(in_channels, dim_out, time_dim, groups)
        self.block2 = ResnetBlock(dim_out, dim_out, time_dim, groups)
        self.norm = LayerNorm(dim_out)
        self.attn = LinearAttention(dim_out)
        self.resample = resample

    def forward(self, x, t, emb, skip=None):
        x = torch.cat([x, self.cond(emb)], dim=1)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        x = self.block2(self.block1(x, t), t)
        return x + self.attn(self.norm(x))


class DenoiseUNet(nn.Module):
    """ε-prediction U-Net over the PI-VAE latent grid (the JAX module's
    fields; `channels` is the latent width, `in_res` its side)."""

    def __init__(self, dim: int = 64, init_dim: Optional[int] = None,
                 out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 3,
                 resnet_block_groups: int = 8,
                 num_classes: Optional[int] = None, class_emb_dim: int = 64,
                 in_res: int = 64):
        super().__init__()
        init_dim = init_dim or (dim // 3 * 2)
        dims = [init_dim] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        g, tdim = resnet_block_groups, dim * 4
        self.dim, self.class_emb_dim = dim, class_emb_dim
        self.embed = nn.Embedding(num_classes, class_emb_dim) \
            if num_classes is not None else None
        self.init_conv = SameConv2d(channels, init_dim, 7)
        self.time_in = nn.Linear(dim, tdim)
        self.time_out = nn.Linear(tdim, tdim)
        self.downs = nn.ModuleList()
        res, width = in_res, init_dim
        for ind, (_, dim_out) in enumerate(in_out):
            last = ind >= len(in_out) - 1
            self.downs.append(_Level(
                width + 1, dim_out, tdim, g, class_emb_dim, res,
                None if last else SameConv2d(dim_out, dim_out, 4, stride=2)))
            width = dim_out
            if not last:
                res //= 2
        mid = dims[-1]
        self.mid_cond = ClassConditioning(class_emb_dim, res)
        self.mid_block1 = ResnetBlock(mid + 1, mid, tdim, g)
        self.mid_norm = LayerNorm(mid)
        self.mid_attn = Attention(mid)
        self.mid_block2 = ResnetBlock(mid, mid, tdim, g)
        self.ups = nn.ModuleList()
        width = mid
        for dim_in, dim_out in reversed(in_out[1:]):
            # the JAX loop's is_last (ind >= num_res − 1) never holds here:
            # every level up ends in a transpose convolution
            self.ups.append(_Level(
                width + 1 + dim_out, dim_in, tdim, g, class_emb_dim, res,
                nn.ConvTranspose2d(dim_in, dim_in, 4, stride=2, padding=1)))
            width = dim_in
            res *= 2
        self.final_block = ResnetBlock(width + in_out[0][1], dim, None, g)
        self.final_conv = SameConv2d(dim, out_dim or channels, 1)

    def forward(self, x, time, class_vector=None):
        """x (nb, h, w, C), time (nb,) integer, class_vector (nb,) or (nb, 1)
        integer labels (read only with `num_classes`) → ε̂ (nb, h, w, C)."""
        if self.embed is not None:
            emb = self.embed(class_vector)
            if emb.ndim == 3:  # (b, 1, d) from labels with an axis
                emb = emb[:, 0]
        else:
            emb = x.new_zeros((x.shape[0], self.class_emb_dim))
        x = self.init_conv(x.permute(0, 3, 1, 2))
        t = self.time_in(sinusoidal_pos_emb(time, self.dim).to(x.dtype))
        t = self.time_out(F.gelu(t))
        hs = []
        for level in self.downs:
            x = level(x, t, emb)
            hs.append(x)
            if level.resample is not None:
                x = level.resample(x)
        x = torch.cat([x, self.mid_cond(emb)], dim=1)
        x = self.mid_block1(x, t)
        x = x + self.mid_attn(self.mid_norm(x))
        x = self.mid_block2(x, t)
        for level in self.ups:
            x = level.resample(level(x, t, emb, hs.pop()))
        x = self.final_block(torch.cat([x, hs.pop()], dim=1))
        return self.final_conv(x).permute(0, 2, 3, 1)

    def init_params(self, generator: torch.Generator) -> None:
        """Flax's default initializers in their variances: LeCun-normal
        kernels (convolutions, transpose convolutions, Dense; not
        truncated), zero biases, unit norm scales, and the class embedding
        N(0, 1/class_emb_dim)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                    fan_in = m.weight[0].numel() if not isinstance(
                        m, nn.ConvTranspose2d) else \
                        m.weight.shape[0] * m.weight[0, 0].numel()
                    nn.init.normal_(m.weight, 0.0, fan_in ** -0.5,
                                    generator=generator)
                    if m.bias is not None:
                        nn.init.zeros_(m.bias)
                elif isinstance(m, nn.GroupNorm):
                    nn.init.ones_(m.weight)
                    nn.init.zeros_(m.bias)
                elif isinstance(m, LayerNorm):
                    nn.init.ones_(m.g)
                    nn.init.zeros_(m.b)
                elif isinstance(m, nn.Embedding):
                    nn.init.normal_(m.weight, 0.0, self.class_emb_dim ** -0.5,
                                    generator=generator)
