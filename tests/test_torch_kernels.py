"""The port's kernel wrappers: routing by device, and each CUDA kernel held
against its plain PyTorch version on the card.

This file imports no JAX, so it also runs where there is a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests marked `cuda` skip without a card (decided inside the fixture). On the
card TF32 is switched off for the plain versions. Tolerances: the fit to
|d| ≤ 1e-5 + 1e-4·|plain| (the JAX package's kernel tolerance), 5e-4 / 5e-5
over 12 echoes; bf16 ρ stores to 2^-8 relative; the ConvLSTM to 1e-4 of the
output scale (f32 sums over K = 9·(Cin+F) in another order than cuDNN's,
carried through the recurrence).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ideal_gan_tpu_torch import ops, physics

ROOT = Path(__file__).resolve().parent.parent
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


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
@pytest.mark.parametrize("cin,f,ne", [(1, 6, 3), (2, 8, 6), (2, 36, 6),
                                      (1, 36, 6), (2, 72, 2)])
def test_convlstm_kernel_matches_plain(cuda, cin, f, ne):
    x, k, b = _lstm_case(ne=ne, cin=cin, f=f, seed=cin + f, device=cuda)
    n0 = ops.CONVLSTM_KERNEL.launches
    got = ops.convlstm_forward(x, k, b)
    assert ops.CONVLSTM_KERNEL.launches == n0 + ne
    ref = ops.convlstm_reference(x, k, b)
    torch.cuda.synchronize()
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_convlstm_kernel_rejects_what_it_cannot_take(cuda):
    x, k, b = _lstm_case(f=8, device=cuda)
    with pytest.raises(TypeError):
        ops.convlstm_forward(x.double(), k, b)
    with pytest.raises(ValueError):
        ops.convlstm_forward(x, k[:, :, :-1], b)
    with pytest.raises(ValueError):
        ops.convlstm_forward(x, k, b, activation="gelu")


def test_chip_smoke_phases_rehearse_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phases at a tiny size on the CPU, where the wrappers
    take the plain versions: its control flow and its fields, before any
    chip time is spent."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    cpu = torch.device("cpu")
    fit = chip_smoke.fit_entry(cpu, size=32, nbs=(2, 3))
    lstm = chip_smoke.convlstm_entry(cpu, size=16, nb=1, f=6)
    for entry, n_cases in ((fit, 7), (lstm, 2)):
        assert KERNEL_KEYS <= set(entry)
        assert len(entry["cases"]) == n_cases
        assert entry["max_abs_err"] == 0.0  # plain vs plain here
        assert Path(ROOT, entry["source"]).is_file()
    e2e = chip_smoke.e2e_phase(cpu, tmp_path, size=32, n=3, batch=2)
    assert e2e["launches"] == {"ideal_fit": 0, "convlstm_fwd": 0}
    assert e2e["maps_max_abs_err_vs_cpu"] == 0.0
