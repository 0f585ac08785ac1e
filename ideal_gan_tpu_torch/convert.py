"""Flax parameters → the port's `state_dict`s.

A Flax parameter tree is a nested dict of arrays (or an `.npz` whose keys
are the `/`-joined paths). Conversion rules:

- Conv kernels (kh, kw, Cin, Cout) → torch (Cout, Cin, kh, kw).
- ConvTranspose kernels are flipped spatially first (Flax/lax applies the
  transpose convolution with the kernel as stored; torch with it rotated by
  180°), then (kh, kw, Cin, Cout) → torch (Cin, Cout, kh, kw).
- GroupNorm scale/bias → weight/bias.

Only arrays cross this boundary; nothing of JAX is imported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def unflatten(flat: dict, sep: str = "/") -> dict:
    """{"a/b/c": x} → {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def load_npz(path) -> dict:
    """A Flax tree saved as an `.npz` of `/`-joined paths, unflattened."""
    with np.load(Path(path)) as data:
        return unflatten({k: np.asarray(data[k]) for k in data.files})


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def conv_kernel(k) -> torch.Tensor:
    """(kh, kw, Cin, Cout) → (Cout, Cin, kh, kw)."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def conv_transpose_kernel(k) -> torch.Tensor:
    """Flax ConvTranspose (kh, kw, Cin, Cout) → torch (Cin, Cout, kh, kw),
    flipped spatially."""
    return _t(np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)))


def conv_block(p: dict, prefix: str) -> dict:
    sd = {}
    for i in (0, 1):
        sd[f"{prefix}conv{i + 1}.weight"] = conv_kernel(p[f"Conv_{i}"]["kernel"])
        gn = p[f"Norm_{i}"]["GroupNorm_0"]
        sd[f"{prefix}norm{i + 1}.weight"] = _t(gn["scale"])
        sd[f"{prefix}norm{i + 1}.bias"] = _t(gn["bias"])
    return sd


def upsample(p: dict, prefix: str) -> dict:
    ct = p["ConvTranspose_0"]
    return {f"{prefix}conv.weight": conv_transpose_kernel(ct["kernel"]),
            f"{prefix}conv.bias": _t(ct["bias"])}


def self_attention(p: dict, prefix: str) -> dict:
    sd = {f"{prefix}{n}.weight": conv_kernel(p[n]["kernel"])
          for n in ("f", "g", "h")}
    sd[f"{prefix}gamma"] = _t(p["gamma"])
    return sd


def convlstm(p: dict, prefix: str) -> dict:
    return {
        f"{prefix}input_conv.weight": conv_kernel(p["input_conv"]["kernel"]),
        f"{prefix}input_conv.bias": _t(p["input_conv"]["bias"]),
        f"{prefix}recurrent_conv.weight":
            conv_kernel(p["recurrent_conv"]["kernel"]),
    }


def unet(p: dict, num_layers: int = 4) -> dict:
    """State dict of `models.UNet(me_layer=True)` from the Flax `UNet`
    params (ConvBlock_0..L-1 encoder, ConvBlock_L bottom, ConvBlock_L+1..
    decoder, Upsample_0.., SelfAttention_0, Conv_0 head)."""
    sd = convlstm(p["ConvLSTM_0"], "lstm.")
    for i in range(num_layers):
        sd.update(conv_block(p[f"ConvBlock_{i}"], f"down.{i}."))
        sd.update(conv_block(p[f"ConvBlock_{num_layers + 1 + i}"],
                             f"dec.{i}."))
        sd.update(upsample(p[f"Upsample_{i}"], f"up.{i}."))
    sd.update(conv_block(p[f"ConvBlock_{num_layers}"], "bottom."))
    if "SelfAttention_0" in p:
        sd.update(self_attention(p["SelfAttention_0"], "attn."))
    sd["head.weight"] = conv_kernel(p["Conv_0"]["kernel"])
    sd["head.bias"] = _t(p["Conv_0"]["bias"])
    return sd
