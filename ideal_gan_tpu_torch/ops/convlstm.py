"""The multi-echo ConvLSTM on the card (counterpart of
`ideal_gan_tpu/ops/pallas_convlstm.py`).

`convlstm_fused` is the differentiable entry point, a
`torch.autograd.Function` that saves only (x, k_merged, bias), as the JAX
package's custom VJP does. Its forward is `convlstm_forward`, which launches
the hand-written kernel `csrc/convlstm_fwd.cu` (a 3xTF32 implicit GEMM on
the tensor cores with the cell in its epilogue) once per echo for CUDA
tensors; its backward is `convlstm_backward`, which recomputes the per-echo
states with that kernel and runs the reverse sweep of `csrc/convlstm_bwd.cu`
(whose gate stage shares the forward's mainloop, `csrc/convlstm_tile.cuh`).
CPU tensors take the plain versions, `convlstm_reference` and
`convlstm_backward_reference`; a CUDA tensor the kernels cannot take
raises. Layouts follow the JAX package at this boundary: x (nb, ne, H, W,
Cin), merged kernel (3, 3, Cin+F, 4F) HWIO, bias (4F,), result (nb, H, W,
F). The result is a channels-last view of an NCHW buffer, so `.permute(0,
3, 1, 2)` gives the contiguous (nb, F, H, W) tensor the rest of the UNet
uses.

The TPU kernels' block search (9 MiB VMEM budget, halo efficiency floor),
taint fronts, dx overlap-add, routing switch and viability gate have no
counterpart: the per-echo kernels take any Cin and F, and any nb, H, W up
to the launch grid's limits (at most 65535 images, and 65535 16×16 pixel
tiles an image).
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
    "convlstm_smem_bytes": (_L, [_I]),
})
CONVLSTM_BWD_KERNEL = Kernel("convlstm_bwd", {
    "convlstm_echo_bwd": (_I, [_P, _L] + [_P] * 10 + [_L, _P, _P]
                          + [_I] * 8 + [_P]),
    "convlstm_bwd_reduce": (_I, [_P, _P, _P, _P, _I, _L, _I, _I, _P]),
    "convlstm_bwd_smem_bytes": (_L, [_I, _I]),
})
_MAX_SMEM = 227 * 1024
# the kernels' grids: 16×16 pixel tiles in y, images in z (_TILE must equal
# T in csrc/convlstm_tile.cuh)
_TILE = 16
_MAX_GRID_YZ = 65535
# the profiler range around the backward's state recompute (forward kernel)
RECOMPUTE_RANGE = "convlstm backward state recompute"
# `kink_masked_gradient`'s margin around leaky_relu's kink: the float32
# versions put the values near it within ~4e-7 of float64's
KINK_TOL = 1e-6


def _echo_step(x_e, h_prev, c_prev, weight, bias, act, rec_act):
    """One echo of the recurrence, NCHW: (h_e, c_e) from x_e (nb, Cin, H,
    W), the previous state (zeros at echo 0), weight (4F, Cin+F, 3, 3) and
    bias; the arithmetic of `_jnp_reference`."""
    inp = torch.cat([x_e, h_prev], dim=1)
    gates = F.conv2d(inp, weight, padding=1) + bias[:, None, None]
    i, fg, gg, o = torch.split(gates, weight.shape[0] // 4, dim=1)
    cell = rec_act(fg) * c_prev + rec_act(i) * act(gg)
    return rec_act(o) * act(cell), cell


def _reference_states(x, k_merged, bias, activation, recurrent_activation):
    """The per-echo states [(h_e, c_e)] of the plain recurrence, NCHW."""
    act = get_activation(activation)
    rec_act = get_activation(recurrent_activation)
    weight = k_merged.permute(3, 2, 0, 1).to(x.dtype)  # (4F, Cin+F, 3, 3)
    b = bias.to(x.dtype)
    nb, _, h, w, _ = x.shape
    f = k_merged.shape[-1] // 4
    hidden = x.new_zeros((nb, f, h, w))
    cell = x.new_zeros((nb, f, h, w))
    states = []
    for e in range(x.shape[1]):
        hidden, cell = _echo_step(x[:, e].permute(0, 3, 1, 2), hidden, cell,
                                  weight, b, act, rec_act)
        states.append((hidden, cell))
    return states


def convlstm_reference(x, k_merged, bias, activation="leaky_relu",
                       recurrent_activation="sigmoid"):
    """The plain recurrence (mirrors `_jnp_reference`): per echo one SAME
    3×3 convolution over concat(x_e, h) with the merged kernel, keras gate
    order i, f, g, o. Returns the final hidden state (nb, H, W, F)."""
    states = _reference_states(x, k_merged, bias, activation,
                               recurrent_activation)
    return states[-1][0].permute(0, 2, 3, 1)


def convlstm_backward_reference(x, k_merged, bias, g,
                                activation="leaky_relu",
                                recurrent_activation="sigmoid",
                                need_dx=True):
    """The plain backward (mirrors the non-TPU branch of `_fused_bwd`):
    rematerialise the per-echo states, then sweep the echoes in reverse,
    applying autograd to one echo step at a time around the recomputed
    state. g = dL/dh_final (nb, H, W, F). Returns (dx (nb, ne, H, W, Cin)
    or None when not `need_dx`, dk (3, 3, Cin+F, 4F), db (4F,))."""
    act = get_activation(activation)
    rec_act = get_activation(recurrent_activation)
    with torch.no_grad():
        states = _reference_states(x, k_merged, bias, activation,
                                   recurrent_activation)
    ne = x.shape[1]
    zeros = torch.zeros_like(states[0][0])  # the state before echo 0
    dh, dc = g.permute(0, 3, 1, 2), zeros
    dx = [None] * ne
    dk = torch.zeros_like(k_merged)
    db = torch.zeros_like(bias)
    for e in range(ne - 1, -1, -1):
        with torch.enable_grad():
            x_e = x[:, e].permute(0, 3, 1, 2).detach().requires_grad_(need_dx)
            k = k_merged.detach().requires_grad_()
            b = bias.detach().requires_grad_()
            prev = [zeros, zeros] if e == 0 else \
                [t.detach().requires_grad_() for t in states[e - 1]]
            h, c = _echo_step(x_e, *prev, k.permute(3, 2, 0, 1), b, act,
                              rec_act)
            wrt = [t for t in [x_e] + prev if t.requires_grad] + [k, b]
            got = list(torch.autograd.grad((h, c), wrt, (dh, dc)))
        dk += got[-2]
        db += got[-1]
        if need_dx:
            dx[e] = got.pop(0).permute(0, 2, 3, 1)
        if e > 0:
            dh, dc = got[0], got[1]
    return torch.stack(dx, dim=1) if need_dx else None, dk, db


def kink_masked_gradient(x, k_merged, bias, g, tol=KINK_TOL):
    """g = dL/dh_final (nb, H, W, F) with zeros wherever the backward's
    result could depend on which side of leaky_relu's kink a value within
    `tol` of it lies. The backward takes leaky_relu's derivative (1 or 0.2)
    at every cell c_e and g-gate pre-activation z_g,e; a float32 result
    can put a value within its rounding of 0 on the other side than
    float64 does, and so move dx, dk and db by up to a few % of their
    scale. Here the recurrence runs in float64; at echo e a pixel with such
    a value in any channel zeroes g within (ne-1-e) pixels (Chebyshev) of
    it, its receptive field in the reverse sweep: dh_e and dc_e there are
    then exact zeros, so the derivative taken there multiplies nothing.
    Leaky_relu / sigmoid gates, as the kernels compute."""
    act = get_activation("leaky_relu")
    rec_act = get_activation("sigmoid")
    x64 = x.double()
    weight = k_merged.double().permute(3, 2, 0, 1)
    b64 = bias.double()[:, None, None]
    nb, ne, h, w, _ = x.shape
    f = k_merged.shape[-1] // 4
    hidden = x64.new_zeros((nb, f, h, w))
    cell = x64.new_zeros((nb, f, h, w))
    near_any = torch.zeros((nb, 1, h, w), dtype=torch.bool, device=x.device)
    for e in range(ne):
        gates = F.conv2d(torch.cat([x64[:, e].permute(0, 3, 1, 2), hidden],
                                   dim=1), weight, padding=1) + b64
        i, fg, gg, o = torch.split(gates, f, dim=1)
        cell = rec_act(fg) * cell + rec_act(i) * act(gg)
        hidden = rec_act(o) * act(cell)
        near = ((gg.abs() < tol) | (cell.abs() < tol)).any(1, keepdim=True)
        r = ne - 1 - e
        if r:
            near = F.max_pool2d(near.double(), 2 * r + 1, 1, r) > 0
        near_any |= near
    return g * ~near_any.permute(0, 2, 3, 1)


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
    tiles = -(-h // _TILE) * -(-w // _TILE)
    if tiles > _MAX_GRID_YZ or nb > _MAX_GRID_YZ:
        raise ValueError(f"convlstm kernel: {nb} images of {tiles} pixel "
                         f"tiles exceed the launch grid's {_MAX_GRID_YZ}")
    smem = CONVLSTM_KERNEL.fn("convlstm_smem_bytes")(f)
    if smem > _MAX_SMEM:
        raise ValueError(f"convlstm kernel: F={f} needs {smem} B of shared "
                         f"memory, more than a block has")
    return nb, ne, h, w, cin, f


def _aligned(k_merged):
    """k_merged, copied if its address is not 16-byte aligned: the kernels
    stage its rows of 4 gates' channels 16 bytes at a time."""
    return k_merged.clone() if k_merged.data_ptr() % 16 else k_merged


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
    k_merged = _aligned(k_merged)
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


def convlstm_backward(x, k_merged, bias, g, activation="leaky_relu",
                      recurrent_activation="sigmoid", need_dx=True):
    """ConvLSTM backward over the echo axis.

    x (nb, ne, H, W, Cin); k_merged (3, 3, Cin+F, 4F); bias (4F,); g =
    dL/dh_final (nb, H, W, F) → (dx (nb, ne, H, W, Cin), or None when not
    `need_dx`; dk (3, 3, Cin+F, 4F); db (4F,)), float32.

    On the card: the forward kernel recomputes h_e, c_e for e < ne-1 into
    an (ne-1, nb, F, H, W) stack (about 1 GB each at nb=8, 384², F=36), then
    `convlstm_echo_bwd` runs echo e = ne-1 .. 0 of the reverse sweep (three
    3xTF32 tensor-core GEMMs per echo) and `convlstm_bwd_reduce` sums the
    deterministic dk/db slot partials. The sweep's buffers (dL/dh, dL/dc,
    dL/dgates) are channels-last, as g is.
    """
    if x.device.type == "cpu":
        return convlstm_backward_reference(x, k_merged, bias, g, activation,
                                           recurrent_activation, need_dx)
    nb, ne, h, w, cin, f = _check(x, k_merged, bias, activation,
                                  recurrent_activation)
    if tuple(g.shape) != (nb, h, w, f) or g.device != x.device \
            or g.dtype != torch.float32:
        raise ValueError(f"convlstm backward: g must be float32 "
                         f"{(nb, h, w, f)} on {x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    smem = CONVLSTM_BWD_KERNEL.fn("convlstm_bwd_smem_bytes")(cin, f)
    if smem > _MAX_SMEM:
        raise ValueError(f"convlstm backward: Cin+F={cin + f} needs {smem} B "
                         f"of shared memory, more than a block has")
    k_merged = _aligned(k_merged)
    # the per-echo states the reverse sweep linearises around
    with torch.profiler.record_function(RECOMPUTE_RANGE):
        hs, cs = _kernel_states(x, k_merged, bias, ne - 1)
    return _reverse_sweep(x, k_merged, bias, g, hs, cs, need_dx)


def _kernel_states(x, k_merged, bias, n_echoes):
    """The forward kernel's h_e, c_e for e < n_echoes, as two (max(n_echoes,
    1), nb, F, H, W) stacks. The caller has checked x, k_merged (16-byte
    aligned) and bias."""
    nb, ne, h, w, cin = x.shape
    f = k_merged.shape[3] // 4
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    echo_stride = h * w * cin
    hs = torch.empty((max(n_echoes, 1), nb, f, h, w), dtype=torch.float32,
                     device=dev)
    cs = torch.empty_like(hs)
    fwd = CONVLSTM_KERNEL.fn("convlstm_echo_fwd")
    for e in range(n_echoes):
        rc = fwd(x.data_ptr() + 4 * e * echo_stride, ne * echo_stride,
                 k_merged.data_ptr(), bias.data_ptr(),
                 hs[e - 1].data_ptr() if e else None,
                 cs[e - 1].data_ptr() if e else None,
                 hs[e].data_ptr(), cs[e].data_ptr(), nb, cin, f, h, w,
                 int(e > 0), dev.index, stream)
        CONVLSTM_KERNEL.launches += 1
        check_launch(CONVLSTM_KERNEL, rc)
    return hs, cs


def _reverse_sweep(x, k_merged, bias, g, hs, cs, need_dx):
    """The reverse sweep of `csrc/convlstm_bwd.cu` around the state stacks
    hs, cs (echoes 0 .. ne-2, (≥1, nb, F, H, W) float32): (dx or None, dk,
    db). The caller has checked every argument."""
    nb, ne, h, w, cin = x.shape
    f = k_merged.shape[3] // 4
    dev = x.device
    c = cin + f
    stream = torch.cuda.current_stream(dev).cuda_stream
    echo_stride = h * w * cin
    x_b = ne * echo_stride
    dgates = torch.empty((nb, h, w, 4 * f), dtype=torch.float32, device=dev)
    dh_in = g.contiguous()
    dh_bufs = [torch.empty_like(dh_in) for _ in range(2)]
    dc_bufs = [torch.empty_like(dh_in) for _ in range(2)]
    dc_in = None
    n_slots = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    part = torch.zeros((n_slots, 9 * c * 4 * f), dtype=torch.float32,
                       device=dev)
    part_b = torch.zeros((n_slots, 4 * f), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    step = CONVLSTM_BWD_KERNEL.fn("convlstm_echo_bwd")
    for e in range(ne - 1, -1, -1):
        has_state = e > 0
        dh_out, dc_out = dh_bufs[e % 2], dc_bufs[e % 2]
        rc = step(
            x.data_ptr() + 4 * e * echo_stride, x_b, k_merged.data_ptr(),
            bias.data_ptr(),
            hs[e - 1].data_ptr() if has_state else None,
            cs[e - 1].data_ptr() if has_state else None,
            dh_in.data_ptr(), None if dc_in is None else dc_in.data_ptr(),
            dgates.data_ptr(), dc_out.data_ptr() if has_state else None,
            dh_out.data_ptr() if has_state else None,
            dx.data_ptr() + 4 * e * echo_stride if need_dx else None, x_b,
            part.data_ptr(), part_b.data_ptr(), n_slots, nb, cin, f, h, w,
            int(has_state), dev.index, stream)
        CONVLSTM_BWD_KERNEL.launches += 1
        check_launch(CONVLSTM_BWD_KERNEL, rc)
        dh_in, dc_in = dh_out, dc_out
    dk = torch.empty_like(k_merged)
    db = torch.empty_like(bias)
    rc = CONVLSTM_BWD_KERNEL.fn("convlstm_bwd_reduce")(
        part.data_ptr(), part_b.data_ptr(), dk.data_ptr(), db.data_ptr(),
        n_slots, part.shape[1], 4 * f, dev.index, stream)
    CONVLSTM_BWD_KERNEL.launches += 1
    check_launch(CONVLSTM_BWD_KERNEL, rc)
    return dx, dk, db


class _ConvLSTMFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k_merged, bias, activation, recurrent_activation):
        ctx.acts = (activation, recurrent_activation)
        ctx.save_for_backward(x, k_merged, bias)
        return convlstm_forward(x, k_merged, bias, activation,
                                recurrent_activation)

    @staticmethod
    def backward(ctx, g):
        x, k_merged, bias = ctx.saved_tensors
        dx, dk, db = convlstm_backward(x, k_merged, bias, g, *ctx.acts,
                                       need_dx=ctx.needs_input_grad[0])
        return dx, dk, db, None, None


def convlstm_fused(x, k_merged, bias, activation="leaky_relu",
                   recurrent_activation="sigmoid"):
    """The differentiable ConvLSTM: `convlstm_forward`, whose backward is
    `convlstm_backward` from the saved (x, k_merged, bias) only. dx is
    computed only when x needs a gradient (on the training path x is the
    data). Layouts as `convlstm_forward`."""
    return _ConvLSTMFused.apply(x, k_merged, bias, activation,
                                recurrent_activation)
