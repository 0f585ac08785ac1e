"""The multi-echo ConvLSTM forward on the card (counterpart of
`ideal_gan_tpu/ops/pallas_convlstm.py`'s forward).

`convlstm_forward` launches the hand-written kernel `csrc/convlstm_fwd.cu`
once per echo for CUDA tensors, and calls the plain version
`convlstm_reference` for CPU tensors. A CUDA tensor the kernel cannot take
raises. Layouts follow the JAX package at this boundary: x (nb, ne, H, W,
Cin), merged kernel (3, 3, Cin+F, 4F) HWIO, bias (4F,), result (nb, H, W, F).
The result is a channels-last view of an NCHW buffer, so `.permute(0, 3, 1,
2)` gives the contiguous (nb, F, H, W) tensor the rest of the UNet uses.

The TPU kernel's block search (9 MiB VMEM budget, halo efficiency floor),
its routing switch and its viability gate have no counterpart: the per-echo
kernel takes any H, W.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models.blocks import get_activation
from ._build import Kernel, check_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

CONVLSTM_KERNEL = Kernel("convlstm_fwd", {
    "convlstm_echo_fwd": (_I, [_P, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _P]),
    "convlstm_smem_bytes": (_L, [_I, _I]),
})
_MAX_SMEM = 227 * 1024


def convlstm_reference(x, k_merged, bias, activation="leaky_relu",
                       recurrent_activation="sigmoid"):
    """The plain recurrence (mirrors `_jnp_reference`): per echo one SAME
    3×3 convolution over concat(x_e, h) with the merged kernel, keras gate
    order i, f, g, o. Returns the final hidden state (nb, H, W, F)."""
    act = get_activation(activation)
    rec_act = get_activation(recurrent_activation)
    nb, ne, h, w, _ = x.shape
    f = k_merged.shape[-1] // 4
    weight = k_merged.permute(3, 2, 0, 1).to(x.dtype)  # (4F, Cin+F, 3, 3)
    hidden = x.new_zeros((nb, f, h, w))
    cell = x.new_zeros((nb, f, h, w))
    for e in range(ne):
        inp = torch.cat([x[:, e].permute(0, 3, 1, 2), hidden], dim=1)
        gates = F.conv2d(inp, weight, padding=1) + bias.to(x.dtype)[:, None,
                                                                    None]
        i, fg, gg, o = torch.split(gates, f, dim=1)
        cell = rec_act(fg) * cell + rec_act(i) * act(gg)
        hidden = rec_act(o) * act(cell)
    return hidden.permute(0, 2, 3, 1)


def _check(x, k_merged, bias, activation, recurrent_activation):
    if x.ndim != 5:
        raise ValueError(f"convlstm kernel: x must be (nb, ne, H, W, Cin), "
                         f"got {tuple(x.shape)}")
    nb, ne, h, w, cin = x.shape
    if k_merged.ndim != 4 or k_merged.shape[:2] != (3, 3) \
            or k_merged.shape[3] % 4:
        raise ValueError(f"convlstm kernel: takes a (3, 3, Cin+F, 4F) "
                         f"kernel, got {tuple(k_merged.shape)}")
    f = k_merged.shape[3] // 4
    if k_merged.shape[2] != cin + f:
        raise ValueError(f"convlstm kernel: kernel {tuple(k_merged.shape)} "
                         f"does not match Cin={cin}")
    if tuple(bias.shape) != (4 * f,):
        raise ValueError(f"convlstm kernel: bias must be ({4 * f},), got "
                         f"{tuple(bias.shape)}")
    for name, t in (("x", x), ("kernel", k_merged), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"convlstm kernel: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"convlstm kernel: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"convlstm kernel: {name} must be contiguous")
    if (activation, recurrent_activation) != ("leaky_relu", "sigmoid"):
        raise ValueError(f"convlstm kernel: computes leaky_relu / sigmoid "
                         f"gates, not {activation!r} / "
                         f"{recurrent_activation!r}")
    smem = CONVLSTM_KERNEL.fn("convlstm_smem_bytes")(cin, f)
    if smem > _MAX_SMEM:
        raise ValueError(f"convlstm kernel: Cin+F={cin + f} needs {smem} B "
                         f"of shared memory, more than a block has")
    return nb, ne, h, w, cin, f


def convlstm_forward(x, k_merged, bias, activation="leaky_relu",
                     recurrent_activation="sigmoid"):
    """ConvLSTM forward over the echo axis.

    x (nb, ne, H, W, Cin); k_merged (3, 3, Cin+F, 4F); bias (4F,) →
    final hidden state (nb, H, W, F) float32.
    """
    if x.device.type == "cpu":
        return convlstm_reference(x, k_merged, bias, activation,
                                  recurrent_activation)
    nb, ne, h, w, cin, f = _check(x, k_merged, bias, activation,
                                  recurrent_activation)
    # ping-pong state, separate buffers so the returned hidden state keeps
    # only its own alive
    h_buf, c_buf = [[torch.empty((nb, f, h, w), dtype=torch.float32,
                                 device=x.device) for _ in range(2)]
                    for _ in range(2)]
    echo_stride = h * w * cin
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = CONVLSTM_KERNEL.fn("convlstm_echo_fwd")
    for e in range(ne):
        src, dst = e % 2, (e + 1) % 2
        last = e == ne - 1
        rc = launch(
            x.data_ptr() + 4 * e * echo_stride, ne * echo_stride,
            k_merged.data_ptr(), bias.data_ptr(),
            h_buf[src].data_ptr(), c_buf[src].data_ptr(),
            h_buf[dst].data_ptr(), None if last else c_buf[dst].data_ptr(),
            nb, cin, f, h, w, int(e > 0), x.device.index, stream)
        CONVLSTM_KERNEL.launches += 1
        check_launch(CONVLSTM_KERNEL, rc)
    return h_buf[ne % 2].permute(0, 2, 3, 1)
