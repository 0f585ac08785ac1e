"""Flax parameters → the port's `state_dict`s.

A Flax parameter tree is a nested dict of arrays (or an `.npz` whose keys
are the `/`-joined paths). Conversion rules:

- Conv kernels (kh, kw, Cin, Cout) → torch (Cout, Cin, kh, kw).
- ConvTranspose kernels are flipped spatially first (Flax/lax applies the
  transpose convolution with the kernel as stored; torch with it rotated by
  180°), then (kh, kw, Cin, Cout) → torch (Cin, Cout, kh, kw).
- GroupNorm scale/bias → weight/bias.
- Dense kernels (in, out) → torch Linear weights (out, in).
- Flax `OptimizedLSTMCell` (input kernels ii/if/ig/io without bias,
  recurrent hi/hf/hg/ho with bias) → `torch.nn.LSTM`'s stacked i, f, g, o
  rows; its input bias is 0.

Only arrays cross this boundary; nothing of JAX is imported. Every map is
linear, so the converters also map gradient trees. The whole-net
converters (`unet`, `vetnet`, `mdwfnet`, `single`) check that every Flax
leaf was mapped.
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


def _conv(p: dict, prefix: str) -> dict:
    return {f"{prefix}weight": conv_kernel(p["kernel"]),
            f"{prefix}bias": _t(p["bias"])}


def _n_leaves(tree) -> int:
    return sum(_n_leaves(v) for v in tree.values()) \
        if isinstance(tree, dict) else 1


def _checked(p: dict, sd: dict) -> dict:
    """`sd`, after checking that its entries account for every leaf of the
    Flax tree `p`: a leaf that no rule maps raises instead of being
    dropped. An entry stands for one leaf, but the stacked LSTM gates (four
    Flax kernels or biases each) and the LSTM input bias Flax does not
    have."""
    def leaves(key):
        if key.endswith("lstm.bias_ih_l0"):
            return 0
        return 4 if key.endswith(("lstm.weight_ih_l0", "lstm.weight_hh_l0",
                                  "lstm.bias_hh_l0")) else 1

    mapped = sum(leaves(k) for k in sd)
    if mapped != _n_leaves(p):
        raise ValueError(f"conversion maps {mapped} of the {_n_leaves(p)} "
                         f"Flax leaves")
    return sd


def unet(p: dict, num_layers: int = 4) -> dict:
    """State dict of `models.UNet` from the Flax `UNet` params (ConvLSTM_0
    with me_layer; ConvBlock_0..L-1 encoder, ConvBlock_L bottom,
    ConvBlock_L+1.. decoder, Upsample_0.., SelfAttention_0, Conv_0 head;
    with te_input TEEncoder_0..L-1, one per encoder level; with the σ head
    Conv_1 (to 16) and Conv_2 (to n_out))."""
    sd = convlstm(p["ConvLSTM_0"], "lstm.") if "ConvLSTM_0" in p else {}
    for i in range(num_layers):
        sd.update(conv_block(p[f"ConvBlock_{i}"], f"down.{i}."))
        sd.update(conv_block(p[f"ConvBlock_{num_layers + 1 + i}"],
                             f"dec.{i}."))
        sd.update(upsample(p[f"Upsample_{i}"], f"up.{i}."))
        if f"TEEncoder_{i}" in p:
            sd.update(te_encoder(p[f"TEEncoder_{i}"], f"te.{i}."))
    sd.update(conv_block(p[f"ConvBlock_{num_layers}"], "bottom."))
    if "SelfAttention_0" in p:
        sd.update(self_attention(p["SelfAttention_0"], "attn."))
    sd.update(_conv(p["Conv_0"], "head."))
    if "Conv_1" in p:
        sd.update(_conv(p["Conv_1"], "sigma.conv1."))
        sd.update(_conv(p["Conv_2"], "sigma.conv2."))
    return _checked(p, sd)


def te_encoder(p: dict, prefix: str) -> dict:
    """State dict of `models.TEEncoder` from the Flax `TEEncoder` params."""
    cell = p["OptimizedLSTMCell_0"]
    gates = ("i", "f", "g", "o")
    w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"]).T
                           for g in gates])
    w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"]).T
                           for g in gates])
    b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
    return {f"{prefix}lstm.weight_ih_l0": _t(w_ih),
            f"{prefix}lstm.weight_hh_l0": _t(w_hh),
            f"{prefix}lstm.bias_ih_l0": torch.zeros(b_hh.shape),
            f"{prefix}lstm.bias_hh_l0": _t(b_hh),
            f"{prefix}dense.weight": _t(np.asarray(p["Dense_0"]["kernel"]).T),
            f"{prefix}dense.bias": _t(p["Dense_0"]["bias"])}


def _decoder(p: dict, prefix: str, num_layers: int) -> dict:
    sd = {}
    for i in range(num_layers):
        sd.update(upsample(p[f"Upsample_{i}"], f"{prefix}up.{i}."))
        sd.update(conv_block(p[f"ConvBlock_{i}"], f"{prefix}blocks.{i}."))
    if "SelfAttention_0" in p:
        sd.update(self_attention(p["SelfAttention_0"], f"{prefix}attn."))
    sd.update(_conv(p["Conv_0"], f"{prefix}head."))
    return sd


def _shared_encoder(enc: dict, num_layers: int) -> dict:
    """The `encoder.` entries from the Flax `_SharedEncoder_0` params
    (ConvBlock_0..L-1, the bottom ConvBlock_L; TEEncoder_0..L-1 in the
    "adain" TE mode, Dense_0 in "dense_l1")."""
    sd = {}
    for i in range(num_layers):
        sd.update(conv_block(enc[f"ConvBlock_{i}"], f"encoder.blocks.{i}."))
        if f"TEEncoder_{i}" in enc:
            sd.update(te_encoder(enc[f"TEEncoder_{i}"], f"encoder.te.{i}."))
    sd.update(conv_block(enc[f"ConvBlock_{num_layers}"], "encoder.bottom."))
    if "Dense_0" in enc:
        sd["encoder.te_dense.weight"] = _t(
            np.asarray(enc["Dense_0"]["kernel"]).T)
        sd["encoder.te_dense.bias"] = _t(enc["Dense_0"]["bias"])
    return sd


def vetnet(p: dict, num_layers: int = 4) -> dict:
    """State dict of `models.VETNet` from the Flax `VETNet` params
    (ConvLSTM_0 with me_layer; _SharedEncoder_0; the dec_r2 and dec_fm
    decoders with Upsample_i, ConvBlock_i, SelfAttention_0 and the Conv_0
    head)."""
    sd = convlstm(p["ConvLSTM_0"], "lstm.") if "ConvLSTM_0" in p else {}
    sd.update(_shared_encoder(p["_SharedEncoder_0"], num_layers))
    for dec in ("dec_r2", "dec_fm"):
        sd.update(_decoder(p[dec], f"{dec}.", num_layers))
    return _checked(p, sd)


def mdwfnet(p: dict, num_layers: int = 4) -> dict:
    """State dict of `models.MDWFNet` from the Flax `MDWFNet` params
    (_SharedEncoder_0, with Dense_0 under te_input; the dec_wf, dec_r2 and
    dec_fm decoders)."""
    sd = _shared_encoder(p["_SharedEncoder_0"], num_layers)
    for dec in ("dec_wf", "dec_r2", "dec_fm"):
        sd.update(_decoder(p[dec], f"{dec}.", num_layers))
    return _checked(p, sd)


def single(p_mag: dict, p_pha: dict,
           num_layers: int = 4) -> tuple[dict, dict]:
    """State dicts of `train.single`'s G_mag and G_pha (two `models.UNet`s)
    from the Flax `SingleState`'s params_mag and params_pha, every leaf of
    each checked."""
    return unet(p_mag, num_layers), unet(p_pha, num_layers)
