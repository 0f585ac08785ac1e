"""`chip_smoke.py`'s io phase (scanner files in and out: DICOM and NIfTI
series folders, the native and Python DICOM walks, `cli.train_unsup` from
the folders, `cli.infer --export dicom` read back, item 9's physics card
against CPU) and the kernels phase's per-voxel batch-elementwise gate,
rehearsed at a tiny size on the CPU, where every wrapper takes its plain
version. Each gate also meets a control that must fail it: a perturbed
pixel, a transposed volume, a batch-dependent kernel, a perturbed output.
Imports no JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ideal_gan_tpu_torch import ops
from ideal_gan_tpu_torch.data import dicom, nifti

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_io_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    cpu = torch.device("cpu")
    r = chip_smoke.io_phase(cpu, tmp_path, size=32, subjects=2, slices=2,
                            batch=2, f=4)
    no_launches = {k.name: 0 for k in ops.KERNELS}
    ld = r["loaders"]
    assert ld["files"] == 2 * 2 * 6 * 2 and ld["shape"] == [2, 6, 32, 32, 2]
    assert ld["native_built"] and ld["auto_backend"] == "native"
    assert ld["native_equal_python"] and ld["nifti_max_err"] <= 1e-6
    assert 0 < ld["quantisation_max_err"] <= ld["quantisation_bound"]
    for name in ("train_dicom", "train_nifti"):
        run = r[name]
        assert run["launches"] == no_launches and run["steps"] == 2
        assert run["cohort_equal"] and run["te_equal"] and run["finite"]
        assert run["cohort_shape"] == [4, 6, 32, 32, 2]
    assert r["infer"]["readback"] == dict(
        mismatched_pixels={"PDFF": 0, "R2s": 0}, files=8)
    assert r["physics"]["ok"] and r["physics"]["round_trip_max_err"] < 1e-5
    chip_smoke.check_io(r, on_card=False)
    with pytest.raises(AssertionError, match="io train_dicom"):
        chip_smoke.check_io(r)  # no kernel launched off the card
    # a pixel of an exported PDFF file changed on disk: the read-back fails
    served = tmp_path / "io-infer"
    path = served / "out_dicom" / "Volunteer-001" / "PDFF" / "PDFF_s00.dcm"
    ds = dicom.read_dicom(str(path))
    px = dicom.pixel_array(ds).copy()
    px[3, 5] += 1
    raw = path.read_bytes()
    path.write_bytes(raw[:-px.nbytes] + px.tobytes())
    with np.load(served / "maps_pred.npz") as npz:
        back = chip_smoke.readback_mismatches(
            served / "out_dicom", {("PDFF", "PDFF_s00.dcm"): npz["pdff"]})
    assert back["mismatched_pixels"] == {"PDFF": 1}
    r["infer"]["readback"] = back
    with pytest.raises(AssertionError, match="io infer"):
        chip_smoke.check_io(r, on_card=False)


def test_io_loader_gates_fail_their_controls(chip_smoke, tmp_path):
    """A stored magnitude 10 units off (4× the bound's half-unit) breaks
    the quantisation bound; a NIfTI set written with x and y swapped
    breaks the orientation check."""
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    acqs, _, te = synthetic_dataset(2, 32, 32, ne=12, seed=0)
    echoes = (acqs[..., 0] + 1j * acqs[..., 1]).astype(np.complex64)
    peak = float(np.abs(echoes[:, :6]).max())
    slope = float(f"{chip_smoke.IO_MAG_TOP / peak:.4g}")
    chip_smoke.write_mecse_folder(tmp_path / "d", 0, echoes[:, :6],
                                  te[0, :6, 0], slope)
    bound = chip_smoke.dicom_quantisation_bound(peak, slope)

    def err():
        got = dicom.load_dicom_series(str(tmp_path / "d"), "native")
        ref = echoes[:, :6] / np.abs(echoes[:, :6]).max()
        return float(np.abs(got[..., 0] + 1j * got[..., 1] - ref).max())

    assert err() <= bound
    path = tmp_path / "d" / "IM_s001_e02_M.dcm"
    px = dicom.pixel_array(dicom.read_dicom(str(path))).copy()
    k = np.unravel_index(np.argmax(px), px.shape)
    px[k] -= 10
    raw = path.read_bytes()
    path.write_bytes(raw[:-px.nbytes] + px.tobytes())
    assert err() > bound
    chip_smoke.write_bids_folder(tmp_path / "n", "sub-00", echoes, te[0, :, 0])
    want = chip_smoke.nifti_expected(echoes)
    got = nifti.load_nifti_series(str(tmp_path / "n"), half_echoes=False)
    assert float(np.abs(got - want).max()) <= 1e-6
    assert float(np.abs(got.swapaxes(2, 3) - want).max()) > 1e-2
    np.testing.assert_array_equal(
        nifti.load_nifti_series(str(tmp_path / "n")), got[:, ::2])


def test_physics_gate_fails_a_perturbed_output(chip_smoke):
    ref = torch.linspace(-1, 1, 101)
    ok = chip_smoke.beyond_allowance({"x": ref * (1 + 5e-5)}, {"x": ref})
    assert ok["ok"]
    bad = chip_smoke.beyond_allowance({"x": ref * (1 + 2e-4) + 2e-5},
                                      {"x": ref})
    assert not bad["ok"] and bad["x"]["beyond"] > 0


def test_per_voxel_batch_elementwise_rehearses_on_cpu(chip_smoke,
                                                      monkeypatch):
    cpu = torch.device("cpu")
    be = chip_smoke.per_voxel_batch_elementwise(cpu, size=16)
    assert be["ok"] and set(be) == {
        "shape", "ok", "fit_rho_fused", "cycle_full_fused",
        "synthesize_fused", "cse_mag_fused", "fit_rho_planar_f32",
        "fit_rho_planar_bf16"}
    for entry, forms in be.items():
        if entry not in ("shape", "ok"):
            assert forms == {"uniform": True, "per_echo": True,
                             "per_row": True}, entry
    chip_smoke.check_per_voxel_batch_elementwise(be)
    # control: a synthesis whose rows see the batch's mean
    real = ops.synthesize_fused
    monkeypatch.setattr(ops, "synthesize_fused", lambda m, te, **kw: real(
        m, te, **kw) + 1e-3 * m.mean())
    bad = chip_smoke.per_voxel_batch_elementwise(cpu, size=16)
    assert not bad["ok"] and bad["synthesize_fused"]["per_row"] is False
    with pytest.raises(AssertionError, match="synthesize_fused"):
        chip_smoke.check_per_voxel_batch_elementwise(bad)
