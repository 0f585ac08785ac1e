"""Seeded weights, made on the device in one draw and handed alike to the
program and to the reference.

The leaves follow the reference nets' modules (the program's carry the
same names): convolutions He-normal (1x1 ones Glorot-normal, the
ConvLSTM's recurrent kernel at 1/sqrt(fan-in), the attention's query and
key scaled to logits of unit variance), transposed convolutions
He-normal over their input fan, biases and the LSTMs' input biases 0,
norm scales 1 and shifts 0, the LSTM kernels N(0, 1) and N(0, 1/n), the
TE encoders' Dense He-normal, and the attention's gamma N(0.5, 0.1^2)
(not 0, so that the attention's output and gradients take part in the
comparison). The query and key scale keeps the random nets out of a
regime where rounding decides their outputs (a softmax that picks one
token in 2304).
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _scale(module: nn.Module, leaf: str, p: torch.Tensor, name: str):
    """(std, mean) of a leaf's normal draw, or None for a constant leaf
    (the returned constant)."""
    if leaf == "bias" or leaf.startswith("bias_"):
        return None, 0.0
    if isinstance(module, nn.GroupNorm):
        return None, 1.0
    if isinstance(module, nn.ConvTranspose2d):
        return math.sqrt(2.0 / (p.shape[0] * p[0, 0].numel())), 0.0
    if isinstance(module, nn.Conv2d):
        fan_in, fan_out = p[0].numel(), p.shape[0] * p[0, 0].numel()
        if name.endswith(("attn.f.weight", "attn.g.weight")):
            # the attention's query and key: logits of unit variance over
            # their C/8 channels (Glorot's would give a standard deviation
            # of ~20, a softmax that picks one token in 2304)
            return fan_in ** -0.5 * p.shape[0] ** -0.25, 0.0
        if name.endswith("recurrent_conv.weight"):
            return 1.0 / math.sqrt(fan_in), 0.0
        if p.shape[-2:] == (1, 1):
            return math.sqrt(2.0 / (fan_in + fan_out)), 0.0
        return math.sqrt(2.0 / fan_in), 0.0
    if isinstance(module, nn.LSTM):
        return (1.0, 0.0) if leaf == "weight_ih_l0" \
            else (1.0 / math.sqrt(module.hidden_size), 0.0)
    if isinstance(module, nn.Linear):
        return math.sqrt(2.0 / p.shape[1]), 0.0
    if leaf == "gamma":
        return 0.1, 0.5
    raise ValueError(f"no rule for leaf {name}")


def make(nets: dict, seed: int, device) -> dict:
    """{net: {leaf name: tensor}} on `device` for the reference nets
    `nets` ({net: module}), from one normal draw of a generator on the
    device seeded with `seed`."""
    plan = []
    for net, model in nets.items():
        for mname, module in model.named_modules():
            for leaf, p in module.named_parameters(recurse=False):
                name = f"{mname}.{leaf}" if mname else leaf
                std, mean = _scale(module, leaf, p, name)
                plan.append((net, name, tuple(p.shape), std, mean))
    n = sum(math.prod(s) for _, _, s, std, _ in plan if std is not None)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(n, generator=gen, device=device)
    out = {net: {} for net in nets}
    at = 0
    for net, name, shape, std, mean in plan:
        if std is None:
            out[net][name] = torch.full(shape, mean, device=device)
            continue
        k = math.prod(shape)
        out[net][name] = flat[at:at + k].view(shape) * std + mean
        at += k
    return out
