"""Convolutional LSTM over the echo axis (port of
`ideal_gan_tpu/models/convlstm.py`).

Consumes (nb, ne, H, W, Cin) echoes and returns the final hidden state as
NCHW (nb, F, H, W). The parameters keep the reference's split, an input
convolution with bias and a recurrent convolution without, and are merged
along the input-channel axis at call time into one (3, 3, Cin+F, 4F) kernel,
so that each echo is a single convolution over concat(x_e, h). Gate order is
keras i, f, g, o; the cell activation is leaky_relu and the recurrent
activation sigmoid. The recurrence runs in `ops.convlstm.convlstm_forward`:
the hand-written kernel for CUDA tensors, the plain version for CPU tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import convlstm as lstm_ops
from .blocks import he_normal_


class ConvLSTM(nn.Module):
    def __init__(self, in_channels: int, filters: int,
                 activation: str = "leaky_relu",
                 recurrent_activation: str = "sigmoid"):
        super().__init__()
        self.filters = filters
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
        hidden = lstm_ops.convlstm_forward(
            x.float().contiguous(), self.merged_kernel(),
            self.input_conv.bias.contiguous(), self.activation,
            self.recurrent_activation)
        return hidden.permute(0, 3, 1, 2)

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
