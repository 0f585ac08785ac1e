"""The bf16 ConvLSTM kernels' layouts on the CPU (`ops/convlstm.py`): the
weight packing and the channels-last input buffer, checked by emulating what
the kernels read.

`_pack_gate_weights` builds the shared-memory image that the gate mainloop
(`csrc/convlstm_tile.cuh::gate_mainloop_wg`) copies whole and hands to
wgmma as B through a descriptor (no swizzle: the two k halves of an n8 tile
64 elements apart, the n8 tiles 128 apart); `_pack_dinp_weights` the image
the transposed convolution (`csrc/convlstm_bwd.cu::dinp_mma_bf16`) reads
with ldmatrix. Here the images are unpacked by those address rules and
multiplied with A as the kernels' row addresses pick it from the (nb, H, W,
Cp) buffer (zero outside the image: the TMA fill), in float32 by einsum;
the sums must equal the bf16 plain version's float32 convolutions up to
summation order. No JAX here: `tests/test_torch_bf16.py` holds the plain
versions to the JAX package. A few seconds on one worker.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ideal_gan_tpu_torch.ops import convlstm as cl

# (Cin, F, H, W): H, W not multiples of 16; F = 36 and Cin 1-3 end in an
# 8-channel chunk (Cp = 40), F = 72 does not (Cp = 80), F = 4 and 6 are one
# 8-channel chunk
SHAPES = [(2, 72, 5, 7), (1, 72, 3, 9), (2, 36, 6, 5), (3, 36, 4, 4),
          (1, 36, 5, 3), (2, 6, 7, 6), (1, 4, 3, 11), (3, 4, 4, 5)]


def _bf16_values(rng, shape, scale=1.0):
    """Random values that bf16 holds exactly, as float32."""
    t = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return t.to(torch.bfloat16).float()


def _case(cin, f, h, w, seed):
    rng = np.random.default_rng(seed)
    c = cin + f
    k = _bf16_values(rng, (3, 3, c, 4 * f), (2.0 / (9 * c)) ** 0.5)
    x = _bf16_values(rng, (2, h, w, cin))
    hid = _bf16_values(rng, (2, h, w, f), 0.5)
    return k, x, hid


def _chunks(cp):
    """(c0, width) of the K chunks: 16 channels, the last one 8."""
    return [(c0, min(16, cp - c0)) for c0 in range(0, cp, 16)]


def _gate_image_steps(wpack, cin, f):
    """The packed gate weights read as the kernel reads them: [(column
    block, ng, chunk (c0, width), step, B (16, 32·ng))], B[k, n] at
    image[step base + 128·(n // 8) + 64·(k // 8) + 8·(n % 8) + k % 8]."""
    cp, gpb, _ = cl._bf16_plan(cin, f)
    groups = -(-f // 8)
    k16 = sum(9 if wd == 16 else 5 for _, wd in _chunks(cp))
    out = []
    for jb, j0 in enumerate(range(0, groups, gpb)):
        ng = min(gpb, groups - j0)
        n = 32 * ng
        base = jb * k16 * 512 * gpb  # the kernel's block offset
        kk = torch.arange(16)
        nn = torch.arange(n)
        idx = (128 * (nn // 8)[None, :] + 64 * (kk // 8)[:, None]
               + 8 * (nn % 8)[None, :] + (kk % 8)[:, None])
        for ci, (c0, wd) in enumerate(_chunks(cp)):
            for step in range(9 if wd == 16 else 5):
                at = base + (9 * ci + step) * 16 * n  # stage + step offset
                out.append((jb, ng, (c0, wd), step, wpack[at + idx]))
    return out


def _columns(jb, ng, gpb, f):
    """k_merged column (q·F + ch) of each of a block's 32·ng columns, -1
    for hidden channels past F."""
    n = torch.arange(32 * ng)
    ch = 8 * (jb * gpb + n // 32) + n % 8
    q = (n // 8) % 4
    return torch.where(ch < f, q * f + ch, -1)


def test_bf16_plan_matches_the_kernels_blocking():
    """Cp: Cin+F rounded up to 8; gpb: at most 3 groups of 8 hidden channels,
    spread evenly; cpb: at most 40 output channels (`dinp_cpb`)."""
    assert cl._bf16_plan(2, 72) == (80, 3, 40)
    assert cl._bf16_plan(2, 36) == (40, 3, 40)
    assert cl._bf16_plan(1, 4) == (8, 1, 8)
    assert cl._bf16_plan(3, 32) == (40, 2, 40)
    assert cl._bf16_plan(2, 24) == (32, 3, 32)
    assert cl._bf16_plan(2, 6) == (8, 1, 8)
    assert [cl._dinp_cpb(n) for n in (8, 40, 41, 74, 80)] \
        == [8, 40, 24, 40, 40]


@pytest.mark.parametrize("cin,f,h,w", SHAPES)
def test_gate_weight_packing_round_trips(cin, f, h, w):
    """Every k_merged value is in the gate image exactly once, where the
    kernel's descriptor reads it; every other element is zero."""
    k, _, _ = _case(cin, f, h, w, cin + f)
    cp, gpb, _ = cl._bf16_plan(cin, f)
    wpack = cl._pack_gate_weights(k.to(torch.bfloat16), gpb, cp)
    assert wpack.dtype == torch.bfloat16 and wpack.is_contiguous()
    kt = k.reshape(9, cin + f, 4 * f)
    seen = torch.zeros(kt.shape, dtype=torch.int64)
    covered = 0
    kk = torch.arange(16)
    for jb, ng, (c0, wd), step, b in _gate_image_steps(wpack.float(), cin, f):
        cols = _columns(jb, ng, gpb, f)[None, :].expand(16, -1)
        if wd == 16:
            taps, chans = torch.full((16,), step), c0 + kk
        else:
            taps, chans = 2 * step + kk // 8, c0 + kk % 8
        taps = taps[:, None].expand_as(cols)
        chans = chans[:, None].expand_as(cols)
        real = (taps <= 8) & (chans < cin + f) & (cols >= 0)
        covered += b.numel()
        assert not bool(b[~real].any())
        t, ch, col = taps[real], chans[real], cols[real]
        assert torch.equal(b[real], kt[t, ch, col])
        seen.index_put_((t, ch, col), torch.ones_like(t), accumulate=True)
    assert covered == wpack.numel()
    assert bool((seen == 1).all())


@pytest.mark.parametrize("cin,f,h,w", SHAPES)
@pytest.mark.parametrize("echo0", [False, True])
def test_gate_product_over_the_buffer_matches_the_plain_convolution(
        cin, f, h, w, echo0):
    """The gate mainloop emulated: A from the zero-padded channels-last
    buffer by the kernel's row addresses (a 16-channel chunk's step s is tap
    s, lanes 16-31 on the second box; the 8-channel chunk's step s taps 2s
    and 2s + 1, the tenth zero), B from the packed image, summed in float32
    over the chunks a launch takes (echo 0: those holding x, over a buffer
    whose h channels are zero) equals `_bf16_states`' gate convolution
    without the bias (F.conv2d of the bf16 operands in float32) up to
    summation order."""
    k, x, hid = _case(cin, f, h, w, 7 * cin + f)
    if echo0:
        hid = torch.zeros_like(hid)
    cp, gpb, _ = cl._bf16_plan(cin, f)
    c = cin + f
    wpack = cl._pack_gate_weights(k.to(torch.bfloat16), gpb, cp).float()
    buf = torch.zeros((2, h, w, cp))
    buf[..., :cin] = x
    buf[..., cin:c] = hid
    pad = F.pad(buf, (0, 0, 1, 1, 1, 1))  # (nb, H+2, W+2, Cp): the TMA fill
    n_chunks = -(-cin // 16) if echo0 else -(-cp // 16)
    z = torch.zeros((2, h, w, 4 * f))
    for jb, ng, (c0, wd), step, b in _gate_image_steps(wpack, cin, f):
        if c0 // 16 >= n_chunks:
            continue
        a = torch.zeros((2, h, w, 16))
        for ki in range(16):
            if wd == 16:
                tap, ch = step, c0 + ki
            else:
                tap, ch = 2 * step + ki // 8, c0 + ki % 8
            if tap > 8:
                continue
            dy, dx = divmod(tap, 3)
            a[..., ki] = pad[:, dy:dy + h, dx:dx + w, ch]
        part = torch.einsum("bhwk,kn->bhwn", a, b)
        cols = _columns(jb, ng, gpb, f)
        keep = cols >= 0
        z[..., cols[keep]] += part[..., keep]
    inp = torch.cat([x, hid], -1).permute(0, 3, 1, 2)
    ref = F.conv2d(inp, k.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    assert torch.allclose(z, ref, rtol=1e-5, atol=1e-5 * float(
        ref.abs().max())), float((z - ref).abs().max())


@pytest.mark.parametrize("cin,f,h,w", SHAPES)
def test_dinp_packing_gives_the_transposed_convolution(cin, f, h, w):
    """The transposed convolution emulated from `_pack_dinp_weights`' image
    (per block of cpb channels and chunk of 16 gates, tap t the flipped
    k[8 - t] as [n8 tile][gate half][8 channels][8 gates]) over a dL/dz
    padded to 4F rounded up to 16 equals conv2d's input gradient; the image
    holds every k value once and zeros elsewhere."""
    rng = np.random.default_rng(cin * f)
    k, _, _ = _case(cin, f, h, w, cin + 3 * f)
    c = cin + f
    _, _, cpb = cl._bf16_plan(cin, f)
    wb = cl._pack_dinp_weights(k.to(torch.bfloat16), cpb).float()
    np_ = -(-4 * f // 16) * 16
    blocks = -(-c // cpb)
    img = wb.reshape(blocks, np_ // 16, 9, cpb // 8, 2, 8, 8)
    assert wb.numel() == blocks * np_ * 9 * cpb
    assert torch.equal(torch.sort(wb[wb != 0].abs())[0],
                       torch.sort(k[k != 0].abs().flatten())[0])
    # B[t][n][c]: gate n, channel c of tap t, read back by the address rule
    bmat = img.permute(2, 1, 4, 6, 0, 3, 5).reshape(9, np_, blocks * cpb)
    dz = _bf16_values(rng, (2, h, w, 4 * f))
    dzp = F.pad(dz, (0, np_ - 4 * f, 1, 1, 1, 1, 0, 0))
    dinp = torch.zeros((2, h, w, blocks * cpb))
    for t in range(9):
        dy, dx = divmod(t, 3)
        dinp += torch.einsum("bhwn,nc->bhwc",
                             dzp[:, dy:dy + h, dx:dx + w], bmat[t])
    ref = torch.nn.grad.conv2d_input(
        (2, c, h, w), k.permute(3, 2, 0, 1), dz.permute(0, 3, 1, 2),
        padding=1).permute(0, 2, 3, 1)
    assert torch.allclose(dinp[..., :c], ref, rtol=1e-5,
                          atol=1e-5 * float(ref.abs().max()))
    assert not bool(dinp[..., c:].any())
