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

- Flax `SpectralNorm` batch_stats (u (1, out), σ) → the PatchGAN's `u` and
  `sigma` buffers (the kernel itself stays un-normalized, as Flax keeps
  it).

Only arrays cross this boundary; nothing of JAX is imported. Every map is
linear, so the converters also map gradient trees. The whole-net
converters (`unet`, `vetnet`, `mdwfnet`, `single`, the GAN trainer's
`encoder`, `decoder`, `patchgan`, `vq`, `vgg19`, `gan`, and the LDM's
`denoise_unet`) check that every Flax leaf was mapped.

- The LDM's channel LayerNorm parameters (1, 1, 1, C) → (1, C, 1, 1); Flax
  `Embed` tables keep their (num_classes, dim) layout.
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


def encoder(p: dict, num_layers: int, num_res_blocks: int) -> dict:
    """State dict of `models.Encoder` from the Flax `Encoder` params
    (ConvLSTM_0; Conv_0 the stem, Conv_1..L the stride-2 convolutions,
    Conv_L+1 the 3×3 head, Conv_L+2/Conv_L+3 the mean and σ heads or
    Conv_L+2 the plain one; ResidualBlock_i in call order, the level blocks
    first, then the two around SelfAttention_0)."""
    L, R = num_layers, num_res_blocks
    sd = convlstm(p["ConvLSTM_0"], "lstm.")
    sd.update(_conv(p["Conv_0"], "stem."))
    for level in range(L):
        sd.update(_conv(p[f"Conv_{level + 1}"], f"down.{level}."))
        for r in range(R):
            sd.update(conv_block(p[f"ResidualBlock_{level * R + r}"],
                                 f"res.{level}.{r}."))
    if "SelfAttention_0" in p:
        sd.update(conv_block(p[f"ResidualBlock_{L * R}"], "sa.0."))
        sd.update(self_attention(p["SelfAttention_0"], "sa.1."))
        sd.update(conv_block(p[f"ResidualBlock_{L * R + 1}"], "sa.2."))
    sd.update(_conv(p[f"Conv_{L + 1}"], "head."))
    if f"Conv_{L + 3}" in p:
        sd.update(_conv(p[f"Conv_{L + 2}"], "mean."))
        sd.update(_conv(p[f"Conv_{L + 3}"], "std."))
    else:
        sd.update(_conv(p[f"Conv_{L + 2}"], "out."))
    return _checked(p, sd)


def decoder(p: dict, num_layers: int, num_res_blocks: int) -> dict:
    """State dict of `models.Decoder` from the Flax `Decoder` params
    (Conv_0, Conv_1 the input convolutions, Conv_2 the head, Norm_0;
    ResidualBlock_i in call order, the two around SelfAttention_0 first;
    Upsample_l's Conv_0)."""
    L, R = num_layers, num_res_blocks
    sd = {**_conv(p["Conv_0"], "conv_in."), **_conv(p["Conv_1"], "conv_wide."),
          **_conv(p["Conv_2"], "head.")}
    gn = p["Norm_0"]["GroupNorm_0"]
    sd["norm.weight"], sd["norm.bias"] = _t(gn["scale"]), _t(gn["bias"])
    first = 0
    if "SelfAttention_0" in p:
        sd.update(conv_block(p["ResidualBlock_0"], "sa.0."))
        sd.update(self_attention(p["SelfAttention_0"], "sa.1."))
        sd.update(conv_block(p["ResidualBlock_1"], "sa.2."))
        first = 2
    for level in range(L):
        sd.update(_conv(p[f"Upsample_{level}"]["Conv_0"], f"up.{level}.conv."))
        for r in range(R):
            sd.update(conv_block(p[f"ResidualBlock_{first + level * R + r}"],
                                 f"res.{level}.{r}."))
    return _checked(p, sd)


def patchgan(p: dict, stats: dict | None = None) -> dict:
    """State dict of `models.PatchGAN` from the Flax `PatchGAN` params
    (Conv_i → convs.i.conv, Norm_j → norms.j, SelfAttention_0 → attn) and,
    with `stats`, its batch_stats (each SpectralNorm_i's u and σ →
    convs.i.u, convs.i.sigma). Without `stats` the map also converts a
    gradient tree."""
    n_convs = sum(1 for k in p if k.startswith("Conv_"))
    sd = {}
    for i in range(n_convs):
        c = p[f"Conv_{i}"]
        sd[f"convs.{i}.conv.weight"] = conv_kernel(c["kernel"])
        if "bias" in c:
            sd[f"convs.{i}.conv.bias"] = _t(c["bias"])
    for j in range(n_convs - 2):
        gn = p[f"Norm_{j}"]["GroupNorm_0"]
        sd[f"norms.{j}.weight"] = _t(gn["scale"])
        sd[f"norms.{j}.bias"] = _t(gn["bias"])
    if "SelfAttention_0" in p:
        sd.update(self_attention(p["SelfAttention_0"], "attn."))
    _checked(p, sd)
    if stats is not None:  # {"SpectralNorm_i": {"Conv_i/kernel/u": ...}}
        for i in range(n_convs):
            node = stats[f"SpectralNorm_{i}"]
            sd[f"convs.{i}.u"] = _t(node[f"Conv_{i}/kernel/u"])
            sd[f"convs.{i}.sigma"] = _t(node[f"Conv_{i}/kernel/sigma"])
    return sd


def vq(p: dict) -> dict:
    """State dict of `models.VectorQuantizer` (the (D, K) codebook, the same
    layout)."""
    return _checked(p, {"codebook": _t(p["codebook"])})


def vgg19(variables: dict) -> dict:
    """State dict of `eval.metrics.VGG19Features` from the Flax
    `VGG19Features` variables ({"params": {"conv_i": ...}}) or params."""
    p = variables.get("params", variables)
    sd = {}
    for i in range(len(p)):
        sd.update(_conv(p[f"conv_{i}"], f"convs.{i}."))
    return _checked(p, sd)


def gan(params_g: dict, params_d: dict, d_stats: dict | None,
        num_layers: int, num_res_blocks: int) -> dict:
    """{model name: state dict} of `train.gan.GANModels` from the JAX
    `GANState`'s params_g ({'enc', 'dec_ff', 'dec_mag', 'dec_pha', 'vq'}),
    params_d and d_stats (None for a gradient tree)."""
    out = {"enc": encoder(params_g["enc"], num_layers, num_res_blocks),
           "vq": vq(params_g["vq"]),
           "disc": patchgan(params_d, d_stats)}
    for name in ("dec_ff", "dec_mag", "dec_pha"):
        out[name] = decoder(params_g[name], num_layers, num_res_blocks)
    return out


def _dense(p: dict, prefix: str) -> dict:
    return {f"{prefix}weight": _t(np.asarray(p["kernel"]).T),
            f"{prefix}bias": _t(p["bias"])}


def _ldm_layer_norm(p: dict, prefix: str) -> dict:
    return {f"{prefix}{k}": _t(np.moveaxis(np.asarray(p[k]), -1, 1))
            for k in ("g", "b")}


def _resnet_block(p: dict, prefix: str) -> dict:
    """`models.ldm.ResnetBlock` from the Flax one (Dense_0 the time FiLM,
    _Block_0/_Block_1 each a Conv_0 and a GroupNorm_0, Conv_0 the 1×1
    projection)."""
    sd = _dense(p["Dense_0"], f"{prefix}mlp.") if "Dense_0" in p else {}
    for i in (0, 1):
        blk = p[f"_Block_{i}"]
        sd.update(_conv(blk["Conv_0"], f"{prefix}block{i + 1}.conv."))
        gn = blk["GroupNorm_0"]
        sd[f"{prefix}block{i + 1}.norm.weight"] = _t(gn["scale"])
        sd[f"{prefix}block{i + 1}.norm.bias"] = _t(gn["bias"])
    if "Conv_0" in p:
        sd.update(_conv(p["Conv_0"], f"{prefix}res_conv."))
    return sd


def _attention(p: dict, prefix: str) -> dict:
    sd = {f"{prefix}to_qkv.weight": conv_kernel(p["Conv_0"]["kernel"]),
          **_conv(p["Conv_1"], f"{prefix}to_out.")}
    if "_LayerNorm_0" in p:
        sd.update(_ldm_layer_norm(p["_LayerNorm_0"], f"{prefix}norm."))
    return sd


def denoise_unet(p: dict, n_levels: int) -> dict:
    """State dict of `models.ldm.DenoiseUNet` (len(dim_mults) = `n_levels`)
    from the Flax `DenoiseUNet` params, whose submodules are numbered per
    type in the order `__call__` creates them: Embed_0 (with classes),
    Conv_0 the 7×7 stem, Dense_0/Dense_1 the time MLP; then per level down
    ClassConditioning, two ResnetBlocks, _LayerNorm, LinearAttention and
    (all but the last) Conv_1… the downsampling; the mid ClassConditioning,
    ResnetBlock, _LayerNorm, Attention_0, ResnetBlock; per level up the
    same as down with ConvTranspose_j (flipped); the final ResnetBlock and
    Conv_n."""
    n = n_levels
    sd = {"embed.weight": _t(p["Embed_0"]["embedding"])} \
        if "Embed_0" in p else {}
    sd.update(_conv(p["Conv_0"], "init_conv."))
    sd.update(_dense(p["Dense_0"], "time_in."))
    sd.update(_dense(p["Dense_1"], "time_out."))

    def level(prefix, cond, block, norm, attn):
        sd.update(_dense(p[f"ClassConditioning_{cond}"]["Dense_0"],
                         f"{prefix}cond.dense."))
        for j in (0, 1):
            sd.update(_resnet_block(p[f"ResnetBlock_{block + j}"],
                                    f"{prefix}block{j + 1}."))
        sd.update(_ldm_layer_norm(p[f"_LayerNorm_{norm}"], f"{prefix}norm."))
        sd.update(_attention(p[f"LinearAttention_{attn}"], f"{prefix}attn."))

    for i in range(n):
        level(f"downs.{i}.", i, 2 * i, i, i)
        if i < n - 1:
            sd.update(_conv(p[f"Conv_{i + 1}"], f"downs.{i}.resample."))
    sd.update(_dense(p[f"ClassConditioning_{n}"]["Dense_0"],
                     "mid_cond.dense."))
    sd.update(_resnet_block(p[f"ResnetBlock_{2 * n}"], "mid_block1."))
    sd.update(_ldm_layer_norm(p[f"_LayerNorm_{n}"], "mid_norm."))
    sd.update(_attention(p["Attention_0"], "mid_attn."))
    sd.update(_resnet_block(p[f"ResnetBlock_{2 * n + 1}"], "mid_block2."))
    for j in range(n - 1):
        level(f"ups.{j}.", n + 1 + j, 2 * n + 2 + 2 * j, n + 1 + j, n + j)
        ct = p[f"ConvTranspose_{j}"]
        sd[f"ups.{j}.resample.weight"] = conv_transpose_kernel(ct["kernel"])
        sd[f"ups.{j}.resample.bias"] = _t(ct["bias"])
    sd.update(_resnet_block(p[f"ResnetBlock_{4 * n}"], "final_block."))
    sd.update(_conv(p[f"Conv_{n}"], "final_conv."))
    return _checked(p, sd)
