"""The port's kernel wrappers: routing by device, and each CUDA kernel held
against its plain PyTorch version on the card.

This file imports no JAX, so it also runs where there is a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked `cuda` skip without a card (decided inside the fixture). On the
card TF32 is switched off for the plain versions. Tolerances: the fit and
the cycle to |d| ≤ 1e-5 + 1e-4·|plain| (the JAX package's kernel
tolerance), 2e-5 + 2e-4·|plain| for the cycle's uniform-TE recurrence,
5e-4 / 5e-5 over 12 echoes; the magnitude fit to the JAX package's rtol
1e-3 / atol 5e-4 for its kernel (voxels on the fit's thresholds, and
ill-conditioned eigenvectors, move under another summation order), with
at most 0.1 % of the elements beyond 1e-5 + 1e-4·|plain|; bf16 ρ stores to 2^-8 relative; the ConvLSTM
kernels' bf16 storage mode to ne·2u·max|plain| of its bf16 plain version
(u = 2^-8: the two round at the same points); the ConvLSTM
forward to 1e-4 of the output scale of the plain version in float32 and in
float64 (3xTF32 sums over K = 9·(Cin+F) in another order than cuDNN's,
carried through the recurrence) and its backward's dx,
dk and db each to 1e-4 of the plain version's max |·| (sums over all pixels
of the batch, in another order); the gradients of the physics Functions to
rtol 1e-3 / atol 1e-5 (the JAX package's gradient tolerance, since the
forward that autograd linearises around is the same plain version).
"""

import numpy as np
import pytest
import torch

from ideal_gan_tpu_torch import ops, physics


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _fit_case(nb=2, h=24, w=40, ne=6, uniform=True, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    maps = np.zeros((nb, 3, h, w, 2), np.float32)
    maps[:, :2] = rng.uniform(-0.5, 0.7, (nb, 2, h, w, 2))
    maps[:, 2, ..., 0] = rng.uniform(-0.3, 0.3, (nb, h, w))
    maps[:, 2, ..., 1] = rng.uniform(0.0, 0.5, (nb, h, w))
    if uniform:
        te = physics.te_train(ne, bs=nb)
    else:
        steps = 1.9e-3 + 2e-4 * rng.normal(size=ne - 1)
        t = 1.2e-3 + np.concatenate([[0.0], np.cumsum(steps)])
        te = torch.from_numpy(np.tile(t.astype(np.float32), (nb, 1))[..., None])
    maps_t = torch.from_numpy(maps).to(device)
    te = te.to(device)
    return physics.synthesize(maps_t, te), maps_t[:, 2:3].contiguous(), te


def _synth_maps(nb=2, h=24, w=40, seed=0, device="cpu"):
    """(nb, 3, H, W, 2) maps with R2* in [-0.2, 0.5]: the clamp at 0 is
    hit."""
    rng = np.random.default_rng(seed)
    maps = np.zeros((nb, 3, h, w, 2), np.float32)
    maps[:, :2] = rng.uniform(-0.5, 0.7, (nb, 2, h, w, 2))
    maps[:, 2, ..., 0] = rng.uniform(-0.3, 0.3, (nb, h, w))
    maps[:, 2, ..., 1] = rng.uniform(-0.2, 0.5, (nb, h, w))
    return torch.from_numpy(maps).to(device)


def _lstm_case(nb=2, ne=6, h=20, w=36, cin=2, f=36, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, ne, h, w, cin)).astype(np.float32) * 0.5
    k = (rng.normal(size=(3, 3, cin + f, 4 * f))
         * (2.0 / (9 * (cin + f))) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(4 * f,)) * 0.1).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, k, b)]


def test_cpu_tensors_take_the_plain_versions():
    before = {k.name: k.launches for k in ops.KERNELS}
    acqs, pm, te = _fit_case()
    np.testing.assert_array_equal(
        ops.fit_rho_fused(acqs, pm, te).numpy(),
        physics.fit_rho(acqs, pm, te).numpy())
    x, k, b = _lstm_case(f=6)
    np.testing.assert_array_equal(ops.convlstm_forward(x, k, b).numpy(),
                                  ops.convlstm_reference(x, k, b).numpy())
    maps = _synth_maps()
    np.testing.assert_array_equal(ops.synthesize_fused(maps, te).numpy(),
                                  physics.synthesize(maps, te).numpy())
    assert {k.name: k.launches for k in ops.KERNELS} == before


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_planar_fit_on_cpu_keeps_dtypes(out_dtype):
    acqs, pm, te = _fit_case()
    rre, rim = ops.fit_rho_planar(
        acqs[..., 0].bfloat16(), acqs[..., 1].bfloat16(), pm[:, 0, ..., 0],
        pm[:, 0, ..., 1], te, out_dtype=out_dtype)
    assert rre.dtype == rim.dtype == out_dtype
    assert tuple(rre.shape) == (2, 2, 24, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "nonuniform", "12echo_forced"])
def test_fit_kernel_matches_plain(cuda, case):
    ne = 12 if case == "12echo_forced" else 6
    acqs, pm, te = _fit_case(ne=ne, uniform=case != "nonuniform",
                             device=cuda)
    flag = True if case == "12echo_forced" else None
    n0 = ops.FIT_KERNEL.launches
    got = ops.fit_rho_fused(acqs, pm, te, uniform_te=flag)
    assert ops.FIT_KERNEL.launches == n0 + 1
    ref = physics.fit_rho(acqs, pm, te)
    torch.cuda.synchronize()
    rtol, atol = (5e-4, 5e-5) if ne == 12 else (1e-4, 1e-5)
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("echo_t", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rho_t", [torch.float32, torch.bfloat16])
def test_planar_fit_kernel_dtypes(cuda, echo_t, rho_t):
    acqs, pm, te = _fit_case(device=cuda, seed=1)
    s_re = acqs[..., 0].contiguous().to(echo_t)
    s_im = acqs[..., 1].contiguous().to(echo_t)
    rre, rim = ops.fit_rho_planar(s_re, s_im, pm[:, 0, ..., 0].contiguous(),
                                  pm[:, 0, ..., 1].contiguous(), te,
                                  out_dtype=rho_t)
    assert rre.dtype == rho_t and rre.is_cuda
    ref = physics.fit_rho(torch.stack([s_re.float(), s_im.float()], -1),
                          pm, te)
    got = torch.stack([rre.float(), rim.float()], -1)
    if rho_t == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(got, ref, rtol=2 ** -8, atol=1e-5)


@pytest.mark.cuda
def test_fit_kernel_rejects_what_it_cannot_take(cuda):
    acqs, pm, te = _fit_case(device=cuda)
    with pytest.raises(TypeError):
        ops.fit_rho_planar(acqs[..., 0].double(), acqs[..., 1].double(),
                           pm[:, 0, ..., 0], pm[:, 0, ..., 1], te)
    with pytest.raises(ValueError):
        ops.fit_rho_fused(acqs, pm.cpu(), te)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,f,ne,nb,h,w", [
    (1, 6, 3, 2, 20, 36), (2, 8, 6, 2, 20, 36), (2, 36, 6, 2, 20, 36),
    (1, 36, 6, 2, 20, 36), (2, 72, 2, 2, 20, 36), (2, 72, 6, 2, 20, 36),
    # ne 1; H and W not multiples of the 16-pixel tile; nb 1; C = Cin+F
    # not a multiple of 8 and F not of 8 (padded octets) or of 4
    (2, 36, 1, 2, 20, 36), (2, 36, 6, 2, 37, 53), (2, 36, 3, 1, 33, 17),
    (1, 4, 4, 2, 11, 19), (3, 6, 3, 1, 15, 23), (2, 72, 6, 1, 37, 53),
    # Cin+F = 408: the shared memory no longer grows with C
    (400, 8, 2, 1, 8, 8)])
def test_convlstm_kernel_matches_plain(cuda, cin, f, ne, nb, h, w):
    """The 3xTF32 kernel against the plain version in float32 and in
    float64, each to 1e-4 of its output scale."""
    x, k, b = _lstm_case(nb=nb, ne=ne, h=h, w=w, cin=cin, f=f, seed=cin + f,
                         device=cuda)
    n0 = ops.CONVLSTM_KERNEL.launches
    got = ops.convlstm_forward(x, k, b)
    assert ops.CONVLSTM_KERNEL.launches == n0 + ne
    assert tuple(got.shape) == (nb, h, w, f)
    ref = ops.convlstm_reference(x, k, b)
    ref64 = ops.convlstm_reference(x.double(), k.double(), b.double())
    torch.cuda.synchronize()
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= 1e-4 * scale
    err64 = float((got.double() - ref64).abs().max())
    assert err64 <= 1e-4 * float(ref64.abs().max()), err64


@pytest.mark.cuda
@pytest.mark.parametrize("cin,f", [(2, 36), (1, 36), (2, 72)])
def test_convlstm_kernel_is_deterministic(cuda, cin, f):
    """Two launches on the same inputs give a bit-identical hidden state:
    each output is one thread's fixed sequence of k8 steps, no atomics."""
    x, k, b = _lstm_case(nb=2, ne=4, h=40, w=52, cin=cin, f=f, device=cuda)
    first = ops.convlstm_forward(x, k, b)
    assert torch.equal(first, ops.convlstm_forward(x, k, b))


@pytest.mark.cuda
def test_convlstm_kernel_rejects_what_it_cannot_take(cuda):
    """A CUDA tensor the kernel cannot take raises, with no launch counted:
    a wrong dtype, kernel shape or activation, and 65536 images, more than
    the launch grid's 65535 (the kernel's limit now that a block needs
    72,576 B of shared memory at any Cin+F)."""
    x, k, b = _lstm_case(f=8, device=cuda)
    before = {kn.name: kn.launches for kn in ops.KERNELS}
    with pytest.raises(TypeError):
        ops.convlstm_forward(x.double(), k, b)
    with pytest.raises(ValueError):
        ops.convlstm_forward(x, k[:, :, :-1], b)
    with pytest.raises(ValueError):
        ops.convlstm_forward(x, k, b, activation="gelu")
    x, k, b = _lstm_case(nb=65536, ne=2, h=1, w=1, f=8, device=cuda)
    with pytest.raises(ValueError, match="grid"):
        ops.convlstm_forward(x, k, b)
    assert {kn.name: kn.launches for kn in ops.KERNELS} == before


def _bf16_gate(scale, ne):
    """ne·2u·max|plain|, u = 2^-8: kernel and plain version round at the
    same points, and each echo can move a value across one bf16 rounding
    boundary (`chip_smoke.bf16_gate`)."""
    return ne * 2 * 2.0 ** -8 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("cin,f,ne,nb,h,w", [
    (2, 36, 6, 2, 20, 36), (1, 36, 6, 2, 20, 36), (2, 72, 6, 1, 37, 53),
    (3, 6, 3, 1, 15, 23), (1, 4, 1, 2, 11, 19),
    # Cp = Cin+F exactly 16 (one 16-channel chunk) and 32; 17 (a 16- and an
    # 8-channel chunk, Cp 24); a 1x1 image (every tile a corner tile, the
    # TMA box almost all fill); 9 groups in 3 column blocks at 384²
    (2, 14, 3, 1, 17, 33), (2, 30, 2, 2, 16, 16), (3, 14, 3, 1, 18, 17),
    (1, 8, 2, 3, 1, 1), (2, 72, 2, 1, 384, 384)])
def test_convlstm_bf16_kernels_match_plain(cuda, cin, f, ne, nb, h, w):
    """The bf16 storage mode: forward and backward (kink-free inputs: every
    g-gate pre-activation and cell positive) against their bf16 plain
    versions at `_bf16_gate`, in bf16, launched on the bf16 kernels, two
    launches bit-identical. The cases hit the edges of the channels-last
    buffer's K chunks (Cp = Cin+F rounded up to 8, chunks of 16 and a last
    one of 8), of the TMA box at the image's corners and of the column
    blocks."""
    x, k, b = _lstm_case(nb=nb, ne=ne, h=h, w=w, cin=cin, f=f, seed=cin + f,
                         device=cuda)
    k = k * 0.1
    b[2 * f:3 * f] = 1.5
    g = torch.randn((nb, h, w, f), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    xb, kb, bb, gb = (t.to(torch.bfloat16) for t in (x, k, b, g))
    n0 = (ops.CONVLSTM_BF16_KERNEL.launches,
          ops.CONVLSTM_BWD_BF16_KERNEL.launches, ops.CONVLSTM_KERNEL.launches)
    got = [ops.convlstm_forward(xb, kb, bb),
           *ops.convlstm_backward(xb, kb, bb, gb)]
    assert (ops.CONVLSTM_BF16_KERNEL.launches,
            ops.CONVLSTM_BWD_BF16_KERNEL.launches,
            ops.CONVLSTM_KERNEL.launches) == (
                n0[0] + ne + ne - 1, n0[1] + ne + 1, n0[2])
    again = [ops.convlstm_forward(xb, kb, bb),
             *ops.convlstm_backward(xb, kb, bb, gb)]
    ref = [ops.convlstm_reference(xb, kb, bb),
           *ops.convlstm_backward_reference(xb, kb, bb, gb)]
    torch.cuda.synchronize()
    for name, a, a2, r in zip(("h", "dx", "dk", "db"), got, again, ref):
        assert a.dtype == torch.bfloat16 and torch.equal(a, a2), name
        d = float((a.float() - r.float()).abs().max())
        assert d <= _bf16_gate(float(r.float().abs().max()), ne), (name, d)


@pytest.mark.cuda
def test_convlstm_kernels_take_float32_or_bfloat16_only(cuda):
    """float16, and x, kernel and bias in different dtypes, raise with no
    launch counted."""
    x, k, b = _lstm_case(f=8, device=cuda)
    before = {kn.name: kn.launches for kn in ops.KERNELS}
    half = [t.half() for t in (x, k, b)]
    with pytest.raises(TypeError):
        ops.convlstm_forward(*half)
    with pytest.raises(TypeError):
        ops.convlstm_forward(x.to(torch.bfloat16), k, b)
    g = torch.zeros((2, 20, 36, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        ops.convlstm_backward(*half, g)
    assert {kn.name: kn.launches for kn in ops.KERNELS} == before


@pytest.mark.cuda
@pytest.mark.parametrize("drift", ["gpb", "cpb", "cp"])
def test_convlstm_bf16_entries_reject_a_plan_their_tiles_do_not_fit(
        cuda, monkeypatch, drift):
    """The bf16 entries check the plan that `_bf16_plan` mirrors from the
    compiled constants (more than kMaxGroups groups a gate block, more than
    kCols output channels a dinp block, an input buffer narrower than
    Cin+F) and raise through check_launch instead of computing wrong
    values."""
    from ideal_gan_tpu_torch.ops import convlstm as cl
    plan = cl._bf16_plan

    def drifted(cin, f):
        cp, gpb, cpb = plan(cin, f)
        return {"gpb": (cp, 4, cpb), "cpb": (cp, gpb, 48),
                "cp": (cp // 16 * 16, gpb, cpb)}[drift]

    monkeypatch.setattr(cl, "_bf16_plan", drifted)
    x, k, b = (t.to(torch.bfloat16) for t in _lstm_case(f=36, device=cuda))
    with pytest.raises(RuntimeError, match="error code"):
        if drift == "cpb":
            g = torch.ones((2, 20, 36, 36), dtype=torch.bfloat16, device=cuda)
            ops.convlstm_backward(x, k, b, g)
        else:
            ops.convlstm_forward(x, k, b)
    torch.cuda.synchronize()


def test_kink_masked_gradient_leaves_no_gradient_at_the_kink():
    """`ops.kink_masked_gradient` zeroes g so that the gradient reaching
    every cell c_e and g-gate pre-activation z_g,e within `tol` of
    leaky_relu's kink is exactly 0 (so the derivative taken there cannot
    matter), and leaves g as it is elsewhere."""
    import torch.nn.functional as F
    x, k, b = _lstm_case(nb=2, ne=4, h=20, w=24, cin=2, f=6, seed=3)
    x, k, b = x.double(), k.double(), b.double()
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 20, 24, 6)))
    tol = 1e-4
    gm = ops.kink_masked_gradient(x, k, b, g, tol)
    zeroed = (gm == 0).all(-1)
    assert 0.05 < float(zeroed.double().mean()) < 0.95
    assert torch.equal(gm[~zeroed], g[~zeroed])
    # the recurrence with the cells and g-gates kept for their gradients
    f = 6
    w = k.permute(3, 2, 0, 1).requires_grad_()
    hid = x.new_zeros((2, f, 20, 24))
    cell = x.new_zeros((2, f, 20, 24))
    kept = []
    for e in range(4):
        z = F.conv2d(torch.cat([x[:, e].permute(0, 3, 1, 2), hid], 1), w,
                     padding=1) + b[:, None, None]
        i, fg, gg, o = torch.split(z, f, 1)
        gg.retain_grad()
        cell = torch.sigmoid(fg) * cell \
            + torch.sigmoid(i) * F.leaky_relu(gg, 0.2)
        cell.retain_grad()
        hid = torch.sigmoid(o) * F.leaky_relu(cell, 0.2)
        kept += [gg, cell]
    hid.backward(gm.permute(0, 3, 1, 2))
    near = [(v.abs() < tol) for v in kept]
    assert sum(int(n.sum()) for n in near) > 0
    for v, n in zip(kept, near):
        assert not bool(v.grad[n].any())
    assert float(kept[-1].grad.abs().max()) > 0.0


def test_convlstm_ablation_reports_edits_that_no_longer_apply():
    """`cli.ablate_convlstm` makes a variant's edits, or reports the variant
    as stale when the text it edits is not in the source (checked here,
    where nothing is built)."""
    from ideal_gan_tpu_torch.cli import ablate_convlstm
    text = "a = 1;\nb = 2;\n"
    assert ablate_convlstm._edit(text, ()) == text
    assert ablate_convlstm._edit(text, (("a = 1", "a = 3"),
                                        ("b = 2", "b = 4"))) \
        == "a = 3;\nb = 4;\n"
    assert ablate_convlstm._edit(text, (("a = 1", "a = 3"),
                                        ("c = 5", ""))) is None


def _cycle_case(ne=6, uniform=True, h=24, w=40, seed=0, device="cpu"):
    acqs, pm, te = _fit_case(ne=ne, uniform=uniform, h=h, w=w, seed=seed,
                             device=device)
    return acqs, (pm + 0.03).contiguous(), te


def test_cpu_cycle_and_backward_take_the_plain_versions():
    before = {k.name: k.launches for k in ops.KERNELS}
    acqs, pm, te = _cycle_case()
    rho, recon = ops.cycle_full_fused(acqs, pm, te)
    ref_rho, ref_recon = physics.cycle_full(acqs, pm, te)
    assert torch.equal(rho, ref_rho) and torch.equal(recon, ref_recon)
    x, k, b = _lstm_case(f=6)
    g = torch.ones((2, 20, 36, 6))
    got = ops.convlstm_backward(x, k, b, g)
    ref = ops.convlstm_backward_reference(x, k, b, g)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    assert {k.name: k.launches for k in ops.KERNELS} == before


@pytest.mark.cuda
@pytest.mark.parametrize("ne,uniform,flag,h,w", [
    (6, True, None, 24, 40), (6, False, None, 24, 40), (6, True, True, 13, 21),
    (3, True, True, 24, 40), (12, True, True, 9, 33), (6, True, False, 7, 5)])
def test_cycle_kernel_matches_plain(cuda, ne, uniform, flag, h, w):
    acqs, pm, te = _cycle_case(ne=ne, uniform=uniform, h=h, w=w,
                               device=cuda)
    n0 = ops.CYCLE_KERNEL.launches
    rho, recon = ops.cycle_full_fused(acqs, pm, te, uniform_te=flag)
    assert ops.CYCLE_KERNEL.launches == n0 + 1
    ref_rho, ref_recon = physics.cycle_full(acqs, pm, te)
    torch.cuda.synchronize()
    rtol, atol = (5e-4, 5e-5) if ne == 12 else \
        (2e-4, 2e-5) if flag or uniform else (1e-4, 1e-5)
    torch.testing.assert_close(rho, ref_rho, rtol=rtol, atol=atol)
    torch.testing.assert_close(recon, ref_recon, rtol=rtol, atol=atol)
    torch.testing.assert_close(ops.cycle_fused(acqs, pm, te, uniform_te=flag),
                               ref_recon, rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_physics_functions_backward_on_card(cuda):
    """The cycle's and the fit's gradients on the card are there (fault: a
    ctypes launch into torch.empty has no grad_fn) and equal autograd
    through the plain versions."""
    acqs, pm, te = _cycle_case(device=cuda)
    for fused, plain in ((ops.cycle_full_fused, physics.cycle_full),
                         (ops.fit_rho_fused, physics.fit_rho)):
        grads = []
        for fn in (fused, plain):
            p = pm.detach().clone().requires_grad_()
            out = fn(acqs, p, te)
            out = out if isinstance(out, tuple) else (out,)
            sum(o.square().mean() for o in out).backward()
            grads.append(p.grad)
        assert grads[0] is not None
        torch.testing.assert_close(grads[0], grads[1], rtol=1e-3, atol=1e-5)


@pytest.mark.cuda
def test_cycle_kernel_rejects_what_it_cannot_take(cuda):
    acqs, pm, te = _cycle_case(device=cuda)
    with pytest.raises(ValueError):
        ops.cycle_full_fused(acqs, pm[..., 1:], te)  # R2*-only row
    with pytest.raises(TypeError):
        ops.cycle_full_fused(acqs.double(), pm, te)
    with pytest.raises(ValueError):
        ops.cycle_full_fused(acqs, pm.cpu(), te)


def _bwd_grad(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                            ).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,f,ne,h,w,zero_region", [
    (1, 6, 3, 13, 21, False), (2, 8, 6, 20, 36, False),
    (2, 36, 6, 24, 40, True), (1, 36, 2, 9, 17, False),
    (2, 12, 1, 16, 16, False), (2, 72, 6, 20, 36, False),
    (2, 72, 6, 13, 21, True),
    # C = Cin+F not a multiple of 8, H and W not multiples of the 16-pixel
    # tile, ne 1 and 2
    (1, 4, 2, 11, 19, False), (3, 6, 1, 15, 23, False),
    (3, 6, 4, 17, 35, True), (2, 72, 1, 19, 17, False),
    (1, 36, 6, 33, 31, False),
    # large C = Cin+F: 408, and 156 (five channel octets short of 160)
    (400, 8, 2, 8, 8, False), (120, 36, 3, 13, 21, False)])
def test_convlstm_bwd_kernel_matches_plain(cuda, cin, f, ne, h, w,
                                           zero_region):
    """dx, dk, db of the 3xTF32 tensor-core sweep against the plain version
    (need_dx True), and dk, db of the need_dx=False launch bit for bit."""
    x, k, b = _lstm_case(nb=2, ne=ne, h=h, w=w, cin=cin, f=f, seed=cin + f,
                         device=cuda)
    if zero_region:  # a zero background and a zero bias (fault 2's case)
        x[:, :, : h // 2] = 0.0
        b.zero_()
    g = _bwd_grad((2, h, w, f), f, cuda)
    n0 = ops.CONVLSTM_BWD_KERNEL.launches
    got = ops.convlstm_backward(x, k, b, g)
    assert ops.CONVLSTM_BWD_KERNEL.launches == n0 + ne + 1
    ref = ops.convlstm_backward_reference(x, k, b, g)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "dk", "db"), got, ref):
        scale = float(r.abs().max())
        err = float((a - r).abs().max())
        assert err <= 1e-4 * max(scale, 1e-6), (name, err, scale)
    dx, dk, db = ops.convlstm_backward(x, k, b, g, need_dx=False)
    assert dx is None
    assert torch.equal(dk, got[1]) and torch.equal(db, got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("cin,f,need_dx", [(2, 36, True), (1, 36, False),
                                           (2, 72, False)])
def test_convlstm_bwd_kernel_is_deterministic(cuda, cin, f, need_dx):
    """Two launches on the same inputs give bit-identical dx, dk and db:
    dk/db come from per-slot sums in a fixed walk and a fixed-order
    reduction, with no float atomics."""
    x, k, b = _lstm_case(nb=2, ne=4, h=40, w=52, cin=cin, f=f, device=cuda)
    g = _bwd_grad((2, 40, 52, f), 5, cuda)
    first = ops.convlstm_backward(x, k, b, g, need_dx=need_dx)
    second = ops.convlstm_backward(x, k, b, g, need_dx=need_dx)
    assert (first[0] is None) == (not need_dx)
    for a, r in zip(first, second):
        assert a is None and r is None or torch.equal(a, r)


@pytest.mark.cuda
def test_convlstm_bwd_kernel_rejects_what_it_cannot_take(cuda):
    """A CUDA tensor the kernels cannot take raises; nothing falls back to
    the plain version (no launch is counted). 65536 images exceed the
    launch grid's 65535: the limit now that no block's shared memory grows
    with Cin+F (at most 190,208 B, stage (c); the state recompute's 72,576
    B), so Cin+F = 408, which used to raise, is taken."""
    x, k, b = _lstm_case(nb=65536, ne=2, h=1, w=1, cin=2, f=8, device=cuda)
    g = _bwd_grad((65536, 1, 1, 8), 0, cuda)
    before = {kn.name: kn.launches for kn in ops.KERNELS}
    with pytest.raises(ValueError, match="grid"):
        ops.convlstm_backward(x, k, b, g)
    g = _bwd_grad((1, 8, 8, 8), 0, cuda)
    x, k, b = _lstm_case(nb=1, ne=2, h=8, w=8, cin=2, f=8, device=cuda)
    with pytest.raises(TypeError):
        ops.convlstm_backward(x.double(), k, b, g)
    with pytest.raises(ValueError):
        ops.convlstm_backward(x, k, b, g[..., :4])
    with pytest.raises(ValueError):
        ops.convlstm_backward(x, k, b, g.cpu())
    assert {kn.name: kn.launches for kn in ops.KERNELS} == before


@pytest.mark.cuda
def test_convlstm_module_gets_gradients_on_card(cuda):
    """Fault: on the card the ConvLSTM weights got no gradient. Through
    `convlstm_fused` they get the plain version's."""
    from ideal_gan_tpu_torch.models import ConvLSTM
    x, _, _ = _lstm_case(nb=2, ne=4, h=16, w=24, cin=2, f=8)
    net = ConvLSTM(2, 8)
    net.init_params(torch.Generator().manual_seed(0))
    grads = {}
    for dev in ("cpu", cuda):
        net.zero_grad()
        net.to(dev)
        net(x.to(dev)).square().mean().backward()
        grads[str(dev)] = {n: p.grad.cpu() for n, p in net.named_parameters()
                           if p.grad is not None}
    cpu, card = grads["cpu"], grads[str(cuda)]
    assert set(card) == set(cpu) == {"input_conv.weight", "input_conv.bias",
                                     "recurrent_conv.weight"}
    for n in cpu:
        scale = float(cpu[n].abs().max())
        assert float((card[n] - cpu[n]).abs().max()) <= 1e-4 * scale, n


def _te_rows(ne, kinds):
    """(nb, ne, 1) TE trains, one row per kind: "uniform" the protocol's,
    "jittered" N(0, (2e-4)²) spacing jitter."""
    rows = []
    for i, kind in enumerate(kinds):
        t = physics.te_train(ne)[0, :, 0].numpy().astype(np.float64)
        if kind == "jittered":
            steps = np.diff(t) + 2e-4 * np.random.default_rng(i).normal(
                size=ne - 1)
            t = t[0] + np.concatenate([[0.0], np.cumsum(steps)])
        rows.append(t.astype(np.float32))
    return torch.from_numpy(np.stack(rows)[..., None])


@pytest.mark.cuda
@pytest.mark.parametrize("ne,kinds,flag,h,w", [
    (6, ("jittered", "jittered"), False, 24, 40),
    (6, ("uniform", "jittered"), None, 13, 21),
    (6, ("uniform", "uniform"), True, 7, 5),
    (3, ("jittered", "uniform"), None, 24, 40),
    (12, ("uniform", "uniform"), True, 9, 33),
    (12, ("jittered", "jittered"), False, 9, 33)])
def test_forward_kernel_matches_plain(cuda, ne, kinds, flag, h, w):
    """The synthesis kernel against `physics.synthesize`: odd H×W, 3 to 12
    echoes, a TE train per row (the per-row test), R2* < 0 clamped."""
    maps = _synth_maps(h=h, w=w, device=cuda)
    te = _te_rows(ne, kinds).to(cuda)
    n0 = ops.FORWARD_KERNEL.launches
    got = ops.synthesize_fused(maps, te, uniform_te=flag)
    assert ops.FORWARD_KERNEL.launches == n0 + 1
    ref = physics.synthesize(maps, te)
    torch.cuda.synchronize()
    # the per-echo form (and the per-row test) computes each echo on its
    # own: the JAX package's 1e-4 / 1e-5 at any echo count. The forced
    # recurrence multiplies the phasor echo by echo, so its rounding grows
    # with the echo count: the cycle's 2e-4 / 2e-5, and 5e-4 / 5e-5 at 12
    rtol, atol = ((5e-4, 5e-5) if ne == 12 else (2e-4, 2e-5)) if flag \
        else (1e-4, 1e-5)
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
    # a B with a fourth (bipolar) row: the kernel reads rows 0-2 in place
    extra = torch.cat([maps, maps[:, :1]], dim=1)
    torch.testing.assert_close(
        ops.synthesize_fused(extra[:, :3], te, uniform_te=flag), got,
        rtol=0, atol=0)


@pytest.mark.cuda
def test_forward_kernel_backward_and_rejects(cuda):
    maps = _synth_maps(device=cuda)
    te = _te_rows(6, ("jittered", "uniform")).to(cuda)
    grads = []
    for fn in (ops.synthesize_fused, physics.synthesize):
        m = maps.detach().clone().requires_grad_()
        fn(m, te).square().mean().backward()
        grads.append(m.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-3, atol=1e-5)
    with pytest.raises(TypeError):
        ops.synthesize_fused(maps.double(), te)
    with pytest.raises(ValueError):
        ops.synthesize_fused(maps, te.cpu())
    with pytest.raises(ValueError):
        ops.synthesize_fused(maps, _te_rows(13, ("uniform",) * 2).to(cuda))


def _mag_case(nb=2, h=24, w=40, ne=6, kinds=("uniform", "uniform"),
              channels=1, device="cpu"):
    """Magnitudes synthesized from `_synth_maps` (R2* ≥ 0 there) at a TE
    train per row, and an R2* row 0.02 off the truth in channel 0 of a
    (nb, 1, H, W, `channels`) row (other channels hold noise)."""
    maps = _synth_maps(nb=nb, h=h, w=w).clamp(min=-0.5)
    maps[:, 2, ..., 1] = maps[:, 2, ..., 1].abs()
    te = _te_rows(ne, kinds) if kinds else physics.te_train(ne, bs=nb)
    a_mag = physics.synthesize(maps, te).square().sum(-1, keepdim=True).sqrt()
    r2 = torch.rand((nb, 1, h, w, channels),
                    generator=torch.Generator().manual_seed(3))
    r2[..., 0] = maps[:, 2:3, ..., 1] + 0.02
    return a_mag.to(device), r2.to(device), te.to(device)


_MAG_FIELDS = ("rho", "recon", "ls_coeffs", "uncertainty")


def test_cpu_mag_fit_takes_the_plain_version():
    before = {k.name: k.launches for k in ops.KERNELS}
    a_mag, r2, te = _mag_case(channels=2)
    got = ops.cse_mag_fused(a_mag, r2, te)
    ref = physics.cse_mag_fit(a_mag, r2, te)
    for name in _MAG_FIELDS + ("demod",):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert {k.name: k.launches for k in ops.KERNELS} == before


@pytest.mark.cuda
@pytest.mark.parametrize("ne,kinds,flag,h,w,channels", [
    (6, ("uniform", "uniform"), None, 24, 40, 1),
    (6, ("uniform", "jittered"), None, 13, 21, 1),
    (6, ("uniform", "uniform"), True, 7, 5, 2),
    (6, ("jittered", "jittered"), False, 24, 40, 3),
    (3, ("jittered", "uniform"), None, 24, 40, 1),
    (12, ("uniform", "uniform"), True, 9, 33, 1),
    (12, ("jittered", "jittered"), False, 9, 33, 2)])
def test_mag_fit_kernel_matches_plain(cuda, ne, kinds, flag, h, w, channels):
    """The magnitude fit kernel against `physics.cse_mag_fit`: odd H×W, 3 to
    12 echoes, each phasor mode, R2* read from channel 0 of a row with
    more channels (the stride read)."""
    a_mag, r2, te = _mag_case(h=h, w=w, ne=ne, kinds=kinds,
                              channels=channels, device=cuda)
    n0 = ops.MAG_FIT_KERNEL.launches
    got = ops.cse_mag_fused(a_mag, r2, te, uniform_te=flag)
    assert ops.MAG_FIT_KERNEL.launches == n0 + 1
    ref = physics.cse_mag_fit(a_mag, r2, te)
    torch.cuda.synchronize()
    beyond = 0
    for name in _MAG_FIELDS:
        g, r = getattr(got, name), getattr(ref, name)
        torch.testing.assert_close(g, r, rtol=1e-3, atol=5e-4, msg=name)
        beyond += int(((g - r).abs() > 1e-5 + 1e-4 * r.abs()).sum())
    assert beyond <= 1e-3 * a_mag.numel()
    assert torch.equal(got.demod, ref.demod)


@pytest.mark.cuda
def test_mag_fit_kernel_backward_and_rejects(cuda):
    a_mag, r2, te = _mag_case(kinds=("jittered", "uniform"), device=cuda)
    a_mag[:, :, :6] = 0.0  # a zero background: the double wheres' case
    nu = (r2 + 0.1).contiguous()
    grads = []
    for fn in (ops.cse_mag_fused, physics.cse_mag_fit):
        p = r2.detach().clone().requires_grad_()
        n = nu.detach().clone().requires_grad_()
        res = fn(a_mag, p, te, r2s_nu=n)
        (res.recon.square().mean() + res.ls_coeffs.mean()
         + 1e-3 * res.demod.mean()).backward()
        grads.append((p.grad, n.grad))
    assert torch.isfinite(grads[0][0]).all()
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-5)
    with pytest.raises(TypeError):
        ops.cse_mag_fused(a_mag.double(), r2, te)
    with pytest.raises(TypeError):
        ops.cse_mag_fused(a_mag, r2.double(), te)
    with pytest.raises(ValueError):
        ops.cse_mag_fused(a_mag, r2.cpu(), te)
    with pytest.raises(ValueError):  # A⁺ needs 3 echoes
        ops.cse_mag_fused(a_mag[:, :2].contiguous(), r2, te[:, :2])
    with pytest.raises(ValueError):
        ops.cse_mag_fused(a_mag, r2[:, :, :-1], te)
