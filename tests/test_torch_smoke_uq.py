"""`chip_smoke.py`'s uq phase (the UQ training CLI with the calibration
stage, a counted step pair and calibration step, PDFF-var and PDFF serving
from that run, the card-vs-CPU steps and PDFF-var serving per stage)
rehearsed at a tiny size on the CPU, where every wrapper takes its plain
version. Imports no JAX. Budget: 30 s on a loaded Tier-1 worker.
"""

from pathlib import Path

import pytest
import torch

from ideal_gan_tpu_torch import ops

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


def test_uq_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    uq = chip_smoke.uq_phase(cpu, tmp_path, size=32, n=8, batch=2, f=4,
                             parity_size=32, parity_batch=1)
    # 8 slices: a calibration split of 2, 3 step pairs, 1 calibration step
    assert uq["launches"] == no_launches and uq["steps"] == 7
    cal = uq["calibration"]
    assert cal["steps"] == 1 and len(cal["calib"]) == 6
    assert not uq["no_gradient"]
    assert set(uq["paths"]) == {"uq_train", "uq_calib",
                                "aideal_uq_serving_pdff",
                                "aideal_uq_serving_pdff_var"}
    for path in uq["paths"].values():
        assert path["launches"] == no_launches
    assert uq["paths"]["aideal_uq_serving_pdff"]["chunks"] == 4
    srv = uq["serving"]
    # the calibrated checkpoint: the trainer's step after the calibration
    assert srv["checkpoint_step"] == srv["steps_trained"] == 7
    assert srv["pdff_var_finite"]
    # on the CPU the "card" is the CPU: every card-vs-CPU distance is 0
    assert set(srv["heads_vs_cpu"].values()) == {0.0}
    assert set(srv["gls_on_card_heads_vs_cpu"].values()) == {0.0}
    assert 0.0 < max(srv["gls_cpu_one_ulp_spread"].values()) < 1e-3
    assert set(uq["parity"]) == {"fm", "r2", "calib"}
    for par in uq["parity"].values():
        assert par["loss_rel_diff"] == par["grad_max_rel"] == 0.0
        vs64 = par["vs_cpu_float64"]
        assert vs64["card"] == vs64["cpu"] and vs64["cpu"] < 2e-2
    assert set(uq["parity"]["calib"]["metrics"]) == {"calib_loss"}
    # the gates pass but for the launches, which the CPU does not count
    with pytest.raises(AssertionError, match="skipped kernels"):
        chip_smoke.check_uq(uq)
    run = dict(no_launches, ideal_cycle=1, convlstm_fwd=1, convlstm_bwd=1)
    uq["launches"] = uq["paths"]["uq_train"]["launches"] = run
    uq["paths"]["uq_calib"]["launches"] = dict(run, convlstm_bwd=0)
    uq["paths"]["aideal_uq_serving_pdff_var"]["launches"] = dict(
        no_launches, convlstm_fwd=10)
    uq["paths"]["aideal_uq_serving_pdff"]["launches"] = dict(
        no_launches, convlstm_fwd=10, ideal_fit=5)
    chip_smoke.check_uq(uq)
    uq["paths"]["uq_calib"]["launches"]["convlstm_bwd"] = 1
    with pytest.raises(AssertionError, match="skipped kernels"):
        chip_smoke.check_uq(uq)
