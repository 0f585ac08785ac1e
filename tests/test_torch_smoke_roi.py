"""`chip_smoke.py`'s roi phase (`cli.roi_analysis.main --model_sel AI-DEAL`
served from a trainer's run, its workbook against `roi_stats` of the
served maps, the first chunk's ROI values against the CPU's) and its
phantom phase (the port's 11-vial phantom at 1.5 T and 3 T against
`PHANTOM_PARITY.json`, then `cli.roi_realphantom`'s GraphCuts path)
rehearsed at a tiny size on the CPU, where every wrapper takes its plain
version. Imports no JAX. Budget: 20 s together on a loaded Tier-1 worker.
"""

from pathlib import Path

import pytest
import torch

from ideal_gan_tpu_torch import ops
from ideal_gan_tpu_torch.cli import train_unsup

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture
def one_thread():
    """The nets here are tiny: under the Tier-1 command's parallel workers
    torch's thread pool costs more time than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_roi_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    cpu = torch.device("cpu")
    train_unsup.main(["--synthetic", "4", "--data_size", "32",
                      "--batch_size", "2", "--n_G_filters", "4", "--epochs",
                      "1", "--out_vars", "PM", "--device", "cpu",
                      "--output_base", str(tmp_path / "train")])
    (tmp_path / "roi").mkdir()
    r = chip_smoke.roi_phase(cpu, tmp_path / "roi",
                             tmp_path / "train" / "Unsup-v0", size=32, n=3,
                             batch=2)
    assert r["launches"] == {k.name: 0 for k in ops.KERNELS}
    assert r["workbook_equal"] and r["finite"] and r["rois"] == 6
    assert r["rois_compared"] > 0 and r["roi_max_abs_err_vs_cpu"] == 0.0
    assert r["roi_tf32_max_abs_diff_vs_cpu"] == 0.0
    assert r["rois_compared"] + r["rois_not_compared"] == 4
    with pytest.raises(AssertionError, match="roi path skipped kernels"):
        chip_smoke.check_roi(r, batch=2, n=3)
    r["launches"] = dict(r["launches"], ideal_fit=2, convlstm_fwd=24)
    chip_smoke.check_roi(r, batch=2, n=3)
    with pytest.raises(AssertionError, match="workbook"):
        chip_smoke.check_roi(dict(r, workbook_equal=False), batch=2, n=3)


def test_phantom_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    p = chip_smoke.phantom_phase(torch.device("cpu"), tmp_path)
    assert set(p["fields"]) == {"field_1p5T", "field_3T"}
    for f in p["fields"].values():
        assert max(f["max_gap"].values()) < 1e-5
        assert f["max_abs_bias_complex"] < 0.005
        assert all(len(m) == 11 for m in f["medians"].values())
    assert p["graphcuts_rows"] == 11
    assert p["tf32_off_max_median_diff"] == 0.0
    with pytest.raises(AssertionError, match="skipped kernels"):
        chip_smoke.check_phantom(p)
    for f in p["fields"].values():
        f["launches"] = dict(f["launches"], ideal_forward=1, ideal_fit=1,
                             ideal_mag_fit=1)
    chip_smoke.check_phantom(p)
    p["fields"]["field_3T"]["max_gap"]["magnitude"] = 6e-4
    with pytest.raises(AssertionError, match="phantom field_3T"):
        chip_smoke.check_phantom(p)
    p["fields"]["field_3T"]["max_gap"]["magnitude"] = 4e-4
    chip_smoke.check_phantom(p)
    with pytest.raises(AssertionError, match="TF32 setting moves"):
        chip_smoke.check_phantom(dict(p, tf32_off_max_median_diff=1e-7))
