"""Convolutional LSTM over the echo axis (port of
`ideal_gan_tpu/models/convlstm.py`).

Consumes (nb, ne, H, W, Cin) echoes and returns the final hidden state as
a contiguous NCHW (nb, F, H, W) tensor (the bf16 kernel's channels-last
result copied into it, the float32 kernel's taken as it is). The parameters keep the reference's split, an input
convolution with bias and a recurrent convolution without, and are merged
along the input-channel axis at call time into one (3, 3, Cin+F, 4F) kernel,
so that each echo is a single convolution over concat(x_e, h). Gate order is
keras i, f, g, o; the cell activation is leaky_relu and the recurrent
activation sigmoid. The recurrence runs in `ops.convlstm.convlstm_fused`:
the hand-written forward and backward kernels for CUDA tensors, the plain
versions for CPU tensors. Gradients reach `input_conv.weight`,
`input_conv.bias` and `recurrent_conv.weight` through `merged_kernel()`.
With a compute `dtype` (bfloat16: the kernels' bf16 storage mode) x, the
merged kernel and the bias are cast to it at call time, as the JAX module
casts them; the parameters stay float32 and their gradients come back
through the casts.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import convlstm as lstm_ops
from .blocks import he_normal_


class ConvLSTM(nn.Module):
    def __init__(self, in_channels: int, filters: int,
                 activation: str = "leaky_relu",
                 recurrent_activation: str = "sigmoid", dtype=None):
        super().__init__()
        self.filters = filters
        self.dtype = dtype
        self.activation = activation
        self.recurrent_activation = recurrent_activation
        # parameter holders in torch's (out, in, kh, kw) layout
        self.input_conv = nn.Conv2d(in_channels, 4 * filters, 3, padding=1)
        self.recurrent_conv = nn.Conv2d(filters, 4 * filters, 3, padding=1,
                                        bias=False)

    def merged_kernel(self) -> torch.Tensor:
        """(3, 3, Cin+F, 4F) HWIO kernel over concat(x_e, h)."""
        k = torch.cat([self.input_conv.weight, self.recurrent_conv.weight],
                      dim=1)
        return k.permute(2, 3, 1, 0).contiguous()

    def forward(self, x):
        dtype = self.dtype or self.input_conv.weight.dtype
        hidden = lstm_ops.convlstm_fused(
            x.to(dtype).contiguous(), self.merged_kernel().to(dtype),
            self.input_conv.bias.to(dtype).contiguous(), self.activation,
            self.recurrent_activation)
        # NCHW for the net: in float32 a view of the kernel's NCHW buffer;
        # the bf16 kernel's (nb, H, W, F) result is copied here, so the
        # net's cuDNN convolutions and norms keep the layout they had
        return hidden.permute(0, 3, 1, 2).contiguous()

    def init_params(self, generator: torch.Generator) -> None:
        w = self.input_conv.weight
        he_normal_(w, w[0].numel(), generator)
        nn.init.zeros_(self.input_conv.bias)
        # orthogonal over the flattened (kh·kw·F, 4F) recurrent kernel
        r = self.recurrent_conv.weight
        flat = torch.empty(r.shape[0], r[0].numel())
        nn.init.orthogonal_(flat, generator=generator)
        with torch.no_grad():
            r.copy_(flat.reshape(r.shape))
