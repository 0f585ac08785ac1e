"""The multi-echo ConvLSTM on the card (counterpart of
`ideal_gan_tpu/ops/pallas_convlstm.py`).

`convlstm_fused` is the differentiable entry point, a
`torch.autograd.Function` that saves only (x, k_merged, bias), as the JAX
package's custom VJP does. Its forward is `convlstm_forward`, which launches
the hand-written kernel `csrc/convlstm_fwd.cu` (a 3xTF32 implicit GEMM on
the tensor cores with the cell in its epilogue; in the bf16 storage mode a
wgmma mainloop over TMA-staged patches) once per echo for CUDA
tensors; its backward is `convlstm_backward`, which recomputes the per-echo
states with that kernel and runs the reverse sweep of `csrc/convlstm_bwd.cu`
(whose gate stage shares the forward's mainloop, `csrc/convlstm_tile.cuh`).
CPU tensors take the plain versions, `convlstm_reference` and
`convlstm_backward_reference`; a CUDA tensor the kernels cannot take
raises. Layouts follow the JAX package at this boundary: x (nb, ne, H, W,
Cin), merged kernel (3, 3, Cin+F, 4F) HWIO, bias (4F,), result (nb, H, W,
F). In float32 the result is a channels-last view of an NCHW buffer, so
`.permute(0, 3, 1, 2)` gives the contiguous (nb, F, H, W) tensor the rest of
the UNet uses; in bfloat16 it is a contiguous (nb, H, W, F) tensor, whose
permute is an NCHW tensor in channels-last memory (`models/convlstm.py`
says who copies it).

Both kernels take float32 or bfloat16 (x, k_merged and bias in one dtype).
The bfloat16 storage mode is the TPU kernels' bf16 form, and the plain
versions are written to its rounding points: the forward stores x, k, the
bias, h and c in bf16, multiplies bf16 operands with f32 accumulation, adds
the bias and runs the gates and the cell in f32, and rounds h and c to bf16
at the end of every echo; the backward recomputes the states with the cell
chain in f32 (h rounded every echo, a bf16 copy of c for the sweep), carries
dL/dh and dL/dc in f32, sums db from the f32 dL/dgates, rounds dL/dgates to
bf16 before both of its products (dk's f32 sum and the transposed
convolution into dx and dh), rounds dx to bf16 per echo, and returns dk and
db in bf16.

The bf16 kernels keep their state channels-last (`_bf16_plan`): each echo
reads one bf16 input buffer (nb, H, W, Cp) whose channels [0, Cin) hold
x_e, [Cin, Cin+F) h_{e-1} and the rest zeros, Cp = Cin+F rounded up to 8.
The forward's epilogue writes h_e straight into the next echo's buffer (x is
copied in beside it), c and the backward's stacks are (nb, H, W, F), and the
backward's recompute fills one such buffer per echo, which the reverse
sweep then reads. The weights are packed once per call, by reshapes and
permutes only, into the shared-memory images the kernels copy whole:
`_pack_gate_weights` (the forward and the sweep's gate stage, wgmma's B
operand) and `_pack_dinp_weights` (the sweep's transposed convolution).

The TPU kernels' block search (9 MiB VMEM budget, halo efficiency floor),
taint fronts, dx overlap-add, routing switch and viability gate have no
counterpart: the per-echo kernels take any Cin and F, and any nb, H, W up
to the launch grid's limits (at most 65535 images, and 65535 16×16 pixel
tiles an image; 16×8 tiles for the bf16 gate kernels).
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
    "convlstm_echo_fwd": (_I, [_P, _L] + [_P] * 6 + [_I] * 7 + [_P]),
    "convlstm_smem_bytes": (_L, [_I]),
})
CONVLSTM_BWD_KERNEL = Kernel("convlstm_bwd", {
    "convlstm_echo_bwd": (_I, [_P, _L] + [_P] * 10 + [_L, _P, _P]
                          + [_I] * 8 + [_P]),
    "convlstm_bwd_reduce": (_I, [_P, _P, _P, _P, _I, _L, _I, _I, _P]),
    "convlstm_bwd_smem_bytes": (_L, [_I, _I]),
})
# the bf16 storage mode: the same sources, launches counted apart
CONVLSTM_BF16_KERNEL = Kernel("convlstm_fwd", {
    "convlstm_echo_fwd_bf16": (_I, [_P] * 6 + [_L] + [_P] * 2 + [_I] * 9
                               + [_P]),
}, name="convlstm_fwd_bf16")
CONVLSTM_BWD_BF16_KERNEL = Kernel("convlstm_bwd", {
    "convlstm_echo_bwd_bf16": (_I, [_P] * 11 + [_L, _P, _P] + [_I] * 11
                               + [_P]),
    "convlstm_bwd_reduce_bf16": (_I, [_P, _I, _L, _P, _I, _I, _P, _P, _I,
                                      _P]),
}, name="convlstm_bwd_bf16")
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SMEM = 227 * 1024
# the kernels' grids: 16×16 pixel tiles in y, images in z (_TILE must equal
# T in csrc/convlstm_tile.cuh)
_TILE = 16
# the bf16 kernels' blocks: 16x8 pixel tiles and at most 3 groups of 8
# hidden channels in a gate block (TH, kMaxGroups in csrc/convlstm_tile.cuh),
# at most 40 output channels in a transposed-convolution block (kCols in
# csrc/convlstm_bwd.cu)
_TILE_ROWS = 8
_GROUPS_BF16 = 3
_COLS_DINP = 40
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


def _bf16(t):
    """t rounded to bfloat16 and widened back to float32."""
    return t.to(torch.bfloat16).float()


def _bf16_states(x, k_merged, bias, activation, recurrent_activation,
                 n_echoes, f32_cell):
    """The bf16 storage mode's per-echo states [(h_e, c_e)], e < n_echoes,
    NCHW float32 holding bf16 values: float32 convolutions of the bf16
    operands (a product of two bf16 values is exact in f32) plus the bias,
    gates and cell in f32, h rounded to bf16 every echo; c rounded to bf16
    every echo (the forward), or carried in f32 with a rounded copy in the
    list (`f32_cell`, the backward's recompute)."""
    act = get_activation(activation)
    rec_act = get_activation(recurrent_activation)
    weight = k_merged.float().permute(3, 2, 0, 1)
    b = bias.float()[:, None, None]
    nb, _, h, w, _ = x.shape
    f = k_merged.shape[-1] // 4
    hidden = x.new_zeros((nb, f, h, w), dtype=torch.float32)
    cell = torch.zeros_like(hidden)
    states = []
    for e in range(n_echoes):
        gates = F.conv2d(torch.cat([x[:, e].float().permute(0, 3, 1, 2),
                                    hidden], dim=1), weight, padding=1) + b
        i, fg, gg, o = torch.split(gates, f, dim=1)
        c32 = rec_act(fg) * cell + rec_act(i) * act(gg)
        hidden = _bf16(rec_act(o) * act(c32))
        cell = c32 if f32_cell else _bf16(c32)
        states.append((hidden, _bf16(c32)))
    return states


def convlstm_reference(x, k_merged, bias, activation="leaky_relu",
                       recurrent_activation="sigmoid"):
    """The plain recurrence (mirrors `_jnp_reference`): per echo one SAME
    3×3 convolution over concat(x_e, h) with the merged kernel, keras gate
    order i, f, g, o. Returns the final hidden state (nb, H, W, F). A
    bfloat16 x takes the kernel's bf16 storage mode (`_bf16_states`) and
    returns bf16."""
    if x.dtype == torch.bfloat16:
        h = _bf16_states(x, k_merged, bias, activation, recurrent_activation,
                         x.shape[1], f32_cell=False)[-1][0]
        return h.to(torch.bfloat16).permute(0, 2, 3, 1)
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
    or None when not `need_dx`, dk (3, 3, Cin+F, 4F), db (4F,)). A
    bfloat16 x takes the kernel's bf16 storage mode
    (`_backward_reference_bf16`)."""
    if x.dtype == torch.bfloat16:
        return _backward_reference_bf16(x, k_merged, bias, g, activation,
                                        recurrent_activation, need_dx)
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


def _backward_reference_bf16(x, k_merged, bias, g, activation,
                             recurrent_activation, need_dx):
    """The bf16 storage mode's backward (the TPU `_bwd_kernel`'s bf16 form),
    in float32 arithmetic on bf16 values: the states of `_bf16_states` with
    the f32 cell chain; per echo e = ne-1 .. 0 the gates recomputed from
    (x_e, h_{e-1}), dL/dgates and dL/dc_{e-1} by autograd of the f32 cell
    around the bf16 copy of c_{e-1}, db summed from the f32 dL/dgates,
    dL/dgates rounded to bf16 before dk's sum and the transposed
    convolution into (dx_e, dL/dh_{e-1}), dx_e rounded to bf16 per echo.
    dL/dh and dL/dc stay f32; dx, dk and db return in bf16."""
    act = get_activation(activation)
    rec_act = get_activation(recurrent_activation)
    ne, cin = x.shape[1], x.shape[-1]
    f = k_merged.shape[-1] // 4
    with torch.no_grad():
        states = _bf16_states(x, k_merged, bias, activation,
                              recurrent_activation, ne - 1, f32_cell=True)
    weight = k_merged.float().permute(3, 2, 0, 1)
    b = bias.float()[:, None, None]
    dh = g.float().permute(0, 3, 1, 2)
    dc = torch.zeros_like(dh)
    zeros = torch.zeros_like(dh)
    dx = [None] * ne
    dk = torch.zeros_like(weight)
    db = torch.zeros_like(bias, dtype=torch.float32)
    for e in range(ne - 1, -1, -1):
        h_prev, c_prev = states[e - 1] if e else (zeros, zeros)
        inp = torch.cat([x[:, e].float().permute(0, 3, 1, 2), h_prev], dim=1)
        with torch.enable_grad():
            gates = (F.conv2d(inp, weight, padding=1) + b).requires_grad_()
            c_in = c_prev.detach().requires_grad_()
            i, fg, gg, o = torch.split(gates, f, dim=1)
            cell = rec_act(fg) * c_in + rec_act(i) * act(gg)
            hidden = rec_act(o) * act(cell)
            dgates, dc = torch.autograd.grad((hidden, cell), (gates, c_in),
                                             (dh, dc))
            db += dgates.sum(dim=(0, 2, 3))
            inp_l = inp.detach().requires_grad_()
            w_l = weight.detach().requires_grad_()
            dinp, dw = torch.autograd.grad(
                F.conv2d(inp_l, w_l, padding=1), (inp_l, w_l), _bf16(dgates))
        dk += dw
        if need_dx:
            dx[e] = dinp[:, :cin].permute(0, 2, 3, 1).to(torch.bfloat16)
        dh = dinp[:, cin:]
    bf = torch.bfloat16
    return (torch.stack(dx, dim=1) if need_dx else None,
            dk.permute(2, 3, 1, 0).to(bf), db.to(bf))


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
    Leaky_relu / sigmoid gates, as the kernels compute; a bfloat16 x runs
    the forward's bf16 roundings of h and c every echo. g keeps its
    dtype."""
    act = get_activation("leaky_relu")
    rec_act = get_activation("sigmoid")
    bf16 = x.dtype == torch.bfloat16
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
        if bf16:  # the bf16 storage mode's roundings, in float64 otherwise
            hidden = hidden.to(torch.bfloat16).double()
            cell = cell.to(torch.bfloat16).double()
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
        if t.dtype not in _DTYPES or t.dtype != x.dtype:
            raise TypeError(f"convlstm kernel: {name} must be float32 or "
                            f"bfloat16 as x ({x.dtype}), got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"convlstm kernel: {name} must be contiguous")
    if (activation, recurrent_activation) != ("leaky_relu", "sigmoid"):
        raise ValueError(f"convlstm kernel: computes leaky_relu / sigmoid "
                         f"gates, not {activation!r} / "
                         f"{recurrent_activation!r}")
    # the bf16 gate kernels' tiles are 16x8 (the others' 16x16)
    tile_h = _TILE_ROWS if x.dtype == torch.bfloat16 else _TILE
    tiles = -(-h // tile_h) * -(-w // _TILE)
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
    final hidden state (nb, H, W, F) in x's dtype (float32 or bfloat16).
    """
    if x.device.type == "cpu":
        return convlstm_reference(x, k_merged, bias, activation,
                                  recurrent_activation)
    nb, ne, h, w, cin, f = _check(x, k_merged, bias, activation,
                                  recurrent_activation)
    if x.dtype == torch.bfloat16:
        return _forward_bf16(x, k_merged, bias)
    k_merged = _aligned(k_merged)
    kern = CONVLSTM_KERNEL
    launch = kern.fn("convlstm_echo_fwd")
    # ping-pong state, separate buffers so the returned hidden state keeps
    # only its own alive
    h_buf, c_buf = [[torch.empty((nb, f, h, w), dtype=x.dtype,
                                 device=x.device) for _ in range(2)]
                    for _ in range(2)]
    echo_stride = h * w * cin
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for e in range(ne):
        src, dst = e % 2, (e + 1) % 2
        last = e == ne - 1
        rc = launch(
            x.data_ptr() + x.element_size() * e * echo_stride,
            ne * echo_stride, k_merged.data_ptr(), bias.data_ptr(),
            h_buf[src].data_ptr(), c_buf[src].data_ptr(),
            h_buf[dst].data_ptr(), None if last else c_buf[dst].data_ptr(),
            nb, cin, f, h, w, int(e > 0), x.device.index, stream)
        kern.launches += 1
        check_launch(kern, rc, h_buf[dst], None if last else c_buf[dst])
    return h_buf[ne % 2].permute(0, 2, 3, 1)


def _dinp_cpb(nco):
    """Output channels per transposed-convolution block for nco channels:
    octets, at most _COLS_DINP, spread evenly (`dinp_cpb` in
    csrc/convlstm_bwd.cu)."""
    octets = -(-nco // 8)
    chunks = -(-octets // (_COLS_DINP // 8))
    return 8 * -(-octets // chunks)


def _bf16_plan(cin, f):
    """(Cp, gpb, cpb) of the bf16 kernels at Cin, F: the input buffer's
    channels (Cin+F rounded up to 8: whole 16-byte pixel rows; its K chunks
    are 16 channels, the last one 8 when Cp % 16 = 8), the groups of 8
    hidden channels a gate block (at most _GROUPS_BF16, spread evenly over
    the blocks: N = 32·gpb ≤ 96 keeps two blocks on an SM), and the output
    channels a transposed-convolution block."""
    c = cin + f
    groups = -(-f // 8)
    blocks = -(-groups // _GROUPS_BF16)
    return -(-c // 8) * 8, -(-groups // blocks), _dinp_cpb(c)


def _pack_gate_weights(k_merged, gpb, cp):
    """k_merged (3, 3, Cin+F, 4F) as the bf16 gate kernels' shared-memory
    image, a flat tensor: column block after column block (gpb groups of 8
    hidden channels, the last one fewer; a block's columns n = 32·jj + 8·q +
    r are gate q of hidden channel 8·(gpb·block + jj) + r), in each the
    channel chunks of 16 (the last one 8 when Cp % 16 = 8), in each its k16
    steps, each step the K-major core matrices of wgmma's B operand:
    [n8 tile][k half][8 columns][8 k]. A 16-channel chunk's step s is tap s
    (k = channel − c0); the 8-channel chunk's step s is taps 2s (first k
    half) and 2s + 1 (second; the tenth tap zero). Channels past Cin+F and
    hidden channels past F are zero. Layout only: no value changes."""
    c, n4 = k_merged.shape[2], k_merged.shape[3]
    f = n4 // 4
    groups = -(-f // 8)
    w = k_merged.reshape(9, c, 4, f)
    w = F.pad(w, (0, 8 * groups - f, 0, 0, 0, cp - c))
    w = w.reshape(9, cp, 4, groups, 8)
    n16 = cp // 16
    parts = []
    for j0 in range(0, groups, gpb):
        ng = min(gpb, groups - j0)
        wb = w[:, :, :, j0:j0 + ng].permute(0, 1, 3, 2, 4) \
            .reshape(9, cp, 32 * ng)
        if n16:  # (tap, chunk, k, n) -> (chunk, tap, n8 tile, k half, r, k)
            t = wb[:, :16 * n16].reshape(9, n16, 2, 8, 4 * ng, 8)
            parts.append(t.permute(1, 0, 4, 2, 5, 3).reshape(-1))
        if cp % 16:  # (tap, k, n) -> (step, n8 tile, tap of the step, r, k)
            t = F.pad(wb[:, 16 * n16:], (0, 0, 0, 0, 0, 1))
            t = t.reshape(5, 2, 8, 4 * ng, 8)
            parts.append(t.permute(0, 3, 1, 4, 2).reshape(-1))
    return torch.cat(parts)


def _pack_dinp_weights(k_merged, cpb):
    """k_merged (3, 3, C, 4F) as the bf16 transposed convolution's
    shared-memory image, a flat tensor: per block of cpb output channels,
    per chunk of 16 gates (4F rounded up to 16), per tap t the flipped
    k[8 − t], as [n8 tile of channels][gate half][8 channels][8 gates] (the
    m16n8k16 B operand that ldmatrix reads). Channels past C and gates past
    4F are zero. Layout only: no value changes."""
    c, n4 = k_merged.shape[2], k_merged.shape[3]
    np_ = -(-n4 // 16) * 16
    blocks = -(-c // cpb)
    w = k_merged.reshape(9, c, n4).flip(0)
    w = F.pad(w, (0, np_ - n4, 0, blocks * cpb - c))
    # (tap, block, tile, r, chunk, half, gate) -> (block, chunk, tap, tile,
    # half, r, gate)
    w = w.reshape(9, blocks, cpb // 8, 8, np_ // 16, 2, 8)
    return w.permute(1, 4, 0, 2, 5, 3, 6).reshape(-1)


def _forward_bf16(x, k_merged, bias):
    """The bf16 forward on the card: ping-pong input buffers (nb, H, W, Cp),
    x_e copied into each echo's before its launch, h_e written by the kernel
    into the next one's (the last into the result), c in (nb, H, W, F)."""
    nb, ne, h, w, cin = x.shape
    f = k_merged.shape[3] // 4
    dev = x.device
    cp, gpb, _ = _bf16_plan(cin, f)
    wpack = _pack_gate_weights(k_merged, gpb, cp)
    bufs = [torch.zeros((nb, h, w, cp), dtype=x.dtype, device=dev)
            for _ in range(min(ne, 2))]
    cs = [torch.empty((nb, h, w, f), dtype=x.dtype, device=dev)
          for _ in range(min(ne - 1, 2))]
    out = torch.empty((nb, h, w, f), dtype=x.dtype, device=dev)
    kern = CONVLSTM_BF16_KERNEL
    launch = kern.fn("convlstm_echo_fwd_bf16")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for e in range(ne):
        buf = bufs[e % 2]
        buf[..., :cin].copy_(x[:, e])
        last = e == ne - 1
        rc = launch(
            buf.data_ptr(), wpack.data_ptr(), bias.data_ptr(),
            cs[(e - 1) % 2].data_ptr() if e else None, None,
            out.data_ptr() if last else bufs[(e + 1) % 2].data_ptr() + 2 * cin,
            f if last else cp, None if last else cs[e % 2].data_ptr(), None,
            nb, cin, f, h, w, cp, gpb, int(e > 0), dev.index, stream)
        kern.launches += 1
        check_launch(kern, rc, out if last else bufs[(e + 1) % 2],
                     None if last else cs[e % 2])
    return out


def convlstm_backward(x, k_merged, bias, g, activation="leaky_relu",
                      recurrent_activation="sigmoid", need_dx=True):
    """ConvLSTM backward over the echo axis.

    x (nb, ne, H, W, Cin); k_merged (3, 3, Cin+F, 4F); bias (4F,); g =
    dL/dh_final (nb, H, W, F) → (dx (nb, ne, H, W, Cin), or None when not
    `need_dx`; dk (3, 3, Cin+F, 4F); db (4F,)), in x's dtype (float32, or
    bfloat16 for the bf16 storage mode, whose g is bf16 too).

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
            or g.dtype != x.dtype:
        raise ValueError(f"convlstm backward: g must be {x.dtype} "
                         f"{(nb, h, w, f)} on {x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    smem = CONVLSTM_BWD_KERNEL.fn("convlstm_bwd_smem_bytes")(cin, f)
    if smem > _MAX_SMEM:
        raise ValueError(f"convlstm backward: Cin+F={cin + f} needs {smem} B "
                         f"of shared memory, more than a block has")
    if x.dtype == torch.bfloat16:
        cp, gpb, _ = _bf16_plan(cin, f)
        wpack = _pack_gate_weights(k_merged, gpb, cp)
        with torch.profiler.record_function(RECOMPUTE_RANGE):
            stack, cs = _kernel_states_bf16(x, wpack, bias, cp, gpb)
        return _reverse_sweep_bf16(x, k_merged, bias, g, stack, cs, wpack,
                                   need_dx)
    k_merged = _aligned(k_merged)
    # the per-echo states the reverse sweep linearises around
    with torch.profiler.record_function(RECOMPUTE_RANGE):
        hs, cs = _kernel_states(x, k_merged, bias, ne - 1)
    return _reverse_sweep(x, k_merged, bias, g, hs, cs, need_dx)


def _kernel_states(x, k_merged, bias, n_echoes):
    """The float32 forward kernel's h_e, c_e for e < n_echoes, as two
    (max(n_echoes, 1), nb, F, H, W) stacks. The caller has checked x,
    k_merged (16-byte aligned) and bias."""
    nb, ne, h, w, cin = x.shape
    f = k_merged.shape[3] // 4
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    echo_stride = h * w * cin
    hs = torch.empty((max(n_echoes, 1), nb, f, h, w), dtype=x.dtype,
                     device=dev)
    cs = torch.empty_like(hs)
    kern = CONVLSTM_KERNEL
    fwd = kern.fn("convlstm_echo_fwd")
    for e in range(n_echoes):
        rc = fwd(x.data_ptr() + x.element_size() * e * echo_stride,
                 ne * echo_stride, k_merged.data_ptr(), bias.data_ptr(),
                 hs[e - 1].data_ptr() if e else None,
                 cs[e - 1].data_ptr() if e else None,
                 hs[e].data_ptr(), cs[e].data_ptr(),
                 nb, cin, f, h, w, int(e > 0), dev.index, stream)
        kern.launches += 1
        check_launch(kern, rc, hs[e], cs[e])
    return hs, cs


def _kernel_states_bf16(x, wpack, bias, cp, gpb):
    """The bf16 recompute: (the (ne, nb, H, W, Cp) stack of every echo's
    input buffer, x_e and h_{e-1}; the (max(ne-1, 1), nb, H, W, F) bf16
    copies of c_e), from ne-1 launches of the forward kernel's recompute
    form (the cell chain carried in two float32 buffers)."""
    nb, ne, h, w, cin = x.shape
    f = bias.shape[0] // 4
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    stack = torch.zeros((ne, nb, h, w, cp), dtype=x.dtype, device=dev)
    stack[..., :cin] = x.permute(1, 0, 2, 3, 4)
    cs = torch.empty((max(ne - 1, 1), nb, h, w, f), dtype=x.dtype,
                     device=dev)
    c32 = [torch.empty((nb, h, w, f), dtype=torch.float32, device=dev)
           for _ in range(min(ne - 2, 2))]
    kern = CONVLSTM_BF16_KERNEL
    fwd = kern.fn("convlstm_echo_fwd_bf16")
    for e in range(ne - 1):
        rc = fwd(stack[e].data_ptr(), wpack.data_ptr(), bias.data_ptr(),
                 None, c32[(e - 1) % 2].data_ptr() if e else None,
                 stack[e + 1].data_ptr() + 2 * cin, cp, cs[e].data_ptr(),
                 c32[e % 2].data_ptr() if e + 2 < ne else None,
                 nb, cin, f, h, w, cp, gpb, int(e > 0), dev.index, stream)
        kern.launches += 1
        check_launch(kern, rc, stack[e + 1], cs[e],
                     c32[e % 2] if e + 2 < ne else None)
    return stack, cs


def _reverse_sweep_bf16(x, k_merged, bias, g, stack, cs, wpack, need_dx):
    """The bf16 reverse sweep of `csrc/convlstm_bwd.cu` around the
    recompute's stack and c copies: (dx or None, dk, db) in bf16. dL/dh and
    dL/dc are float32 (g widened), dL/dz bf16 (nb, H, W, 4F rounded up to
    16), the dk partials per slot and the db partials per pixel tile
    float32."""
    nb, ne, h, w, cin = x.shape
    f = k_merged.shape[3] // 4
    dev = x.device
    cp, gpb, cpb = _bf16_plan(cin, f)
    wb = _pack_dinp_weights(k_merged, cpb)
    kern = CONVLSTM_BWD_BF16_KERNEL
    step = kern.fn("convlstm_echo_bwd_bf16")
    stream = torch.cuda.current_stream(dev).cuda_stream
    echo_stride = h * w * cin
    np_ = -(-4 * f // 16) * 16
    # columns past 4F are read as (b)'s K: zeros
    dz = (torch.zeros if np_ > 4 * f else torch.empty)(
        (nb, h, w, np_), dtype=x.dtype, device=dev)
    dh_in = g.float().contiguous()
    dh_bufs = [torch.empty_like(dh_in) for _ in range(2)]
    dc_bufs = [torch.empty_like(dh_in) for _ in range(2)]
    dc_in = None
    n_slots = 2 * torch.cuda.get_device_properties(dev).multi_processor_count
    part = torch.zeros((n_slots, 9 * (cin + f) * 4 * f), dtype=torch.float32,
                       device=dev)
    tiles = -(-h // _TILE_ROWS) * -(-w // _TILE)
    part_db = torch.zeros((nb * tiles, 4 * f), dtype=torch.float32,
                          device=dev)
    dx = torch.empty_like(x) if need_dx else None
    for e in range(ne - 1, -1, -1):
        has_state = e > 0
        dh_out, dc_out = dh_bufs[e % 2], dc_bufs[e % 2]
        rc = step(
            stack[e].data_ptr(), wpack.data_ptr(), wb.data_ptr(),
            bias.data_ptr(), cs[e - 1].data_ptr() if has_state else None,
            dh_in.data_ptr(), None if dc_in is None else dc_in.data_ptr(),
            dz.data_ptr(), dc_out.data_ptr() if has_state else None,
            dh_out.data_ptr() if has_state else None,
            dx.data_ptr() + 2 * e * echo_stride if need_dx else None,
            ne * echo_stride, part.data_ptr(), part_db.data_ptr(), n_slots,
            nb, cin, f, h, w, cp, gpb, cpb, int(has_state), dev.index,
            stream)
        kern.launches += 1
        check_launch(kern, rc, dz, dc_out if has_state else None,
                     dh_out if has_state else None,
                     dx[:, e] if need_dx else None)
        dh_in, dc_in = dh_out, dc_out
    dk = torch.empty_like(k_merged)
    db = torch.empty_like(bias)
    rc = kern.fn("convlstm_bwd_reduce_bf16")(
        part.data_ptr(), n_slots, part.shape[1], part_db.data_ptr(),
        part_db.shape[0], 4 * f, dk.data_ptr(), db.data_ptr(), dev.index,
        stream)
    kern.launches += 1
    check_launch(kern, rc, dk, db)
    return dx, dk, db


def _reverse_sweep(x, k_merged, bias, g, hs, cs, need_dx):
    """The float32 reverse sweep of `csrc/convlstm_bwd.cu` around the state
    stacks hs, cs (echoes 0 .. ne-2, (≥1, nb, F, H, W)): (dx or None, dk,
    db). The caller has checked every argument."""
    nb, ne, h, w, cin = x.shape
    f = k_merged.shape[3] // 4
    dev = x.device
    c = cin + f
    kern = CONVLSTM_BWD_KERNEL
    step = kern.fn("convlstm_echo_bwd")
    item = x.element_size()
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
    for e in range(ne - 1, -1, -1):
        has_state = e > 0
        dh_out, dc_out = dh_bufs[e % 2], dc_bufs[e % 2]
        rc = step(
            x.data_ptr() + item * e * echo_stride, x_b, k_merged.data_ptr(),
            bias.data_ptr(),
            hs[e - 1].data_ptr() if has_state else None,
            cs[e - 1].data_ptr() if has_state else None,
            dh_in.data_ptr(), None if dc_in is None else dc_in.data_ptr(),
            dgates.data_ptr(), dc_out.data_ptr() if has_state else None,
            dh_out.data_ptr() if has_state else None,
            dx.data_ptr() + item * e * echo_stride if need_dx else None,
            x_b, part.data_ptr(), part_b.data_ptr(), n_slots, nb, cin, f, h,
            w, int(has_state), dev.index, stream)
        kern.launches += 1
        check_launch(kern, rc, dgates, dc_out if has_state else None,
                     dh_out if has_state else None,
                     dx[:, e] if need_dx else None)
        dh_in, dc_in = dh_out, dc_out
    dk = torch.empty_like(k_merged)
    db = torch.empty_like(bias)
    rc = kern.fn("convlstm_bwd_reduce")(
        part.data_ptr(), part_b.data_ptr(), dk.data_ptr(), db.data_ptr(),
        n_slots, part.shape[1], 4 * f, dev.index, stream)
    kern.launches += 1
    check_launch(kern, rc, dk, db)
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
