"""`chip_smoke.py`'s mag phase (magnitude training, one unsupervised step, the
card-vs-CPU steps with their float64 witness at the spread and at the
zero-bias TEEncoder init, and Mag serving) rehearsed at a tiny size on the
CPU, where every wrapper takes its plain version. Imports no JAX. Budget:
240 s on a loaded Tier-1 worker (144.3–145.4 s under the Tier-1 command;
2.3 s alone).
"""

from pathlib import Path

import pytest
import torch

from ideal_gan_tpu_torch import ops
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def test_mag_phase_rehearses_on_cpu(chip_smoke, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    mag = chip_smoke.mag_phase(cpu, tmp_path / "m", size=32, n=4, batch=2,
                               f=4, parity_size=32, parity_batch=1)
    assert mag["launches"] == no_launches and mag["steps"] == 4
    assert mag["unsupervised_step"]["launches"] == no_launches
    assert [ep["epoch"] for ep in mag["epochs"]] == [1, 2]
    assert set(mag["parity"]) == {"defaults", "unsupervised"}
    for par in mag["parity"].values():
        assert par["loss_rel_diff"] == par["grad_max_rel"] == 0.0
        assert set(par["metrics_rel_diff"].values()) == {0.0}
        assert par["plain_convlstm_on_card_vs_cpu"] == 0.0
        # the float64 witness: the same step on both sides here
        vs64 = par["vs_cpu_float64"]
        assert vs64["card"] == vs64["cpu"] and 0.0 < vs64["cpu"] < 1e-3
        assert par["first_gradient_over_1e_2"] is None
    # the zero-bias TEEncoder init, reported beside the gated steps (the
    # unsupervised net has no TEEncoder: its init is Flax's already)
    zero = mag["parity"]["defaults"]["zero_bias_init"]
    assert zero["grad_max_rel"] == zero["loss_rel_diff"] == 0.0
    assert zero["vs_cpu_float64"]["card"] == zero["vs_cpu_float64"]["cpu"]
    assert zero["first_gradient_over_1e_2"] is None
    assert zero["vs_cpu_float64"]["cpu"] != mag["parity"]["defaults"][
        "vs_cpu_float64"]["cpu"]
    # what sets the distance from float64: the plain ConvLSTM, unperturbed
    # and perturbed by 1e-7 of its scale, and the ReLUs that flip
    vs64 = zero["vs_cpu_float64"]
    assert vs64["card_plain_convlstm"] == vs64["cpu"]
    assert len(vs64["card_plain_convlstm_perturbed_1e_7"]) == 4
    assert all(0.0 < v < 1e-2
               for v in vs64["card_plain_convlstm_perturbed_1e_7"])
    assert zero["relu_flips_vs_plain_convlstm"] == {}
    assert zero["relu_inputs"] > 0
    assert "relu_flips_vs_plain_convlstm" not in mag["parity"]["defaults"]
    assert mag["parity"]["unsupervised"]["zero_bias_init"] is None
    assert mag["serve"]["launches"] == no_launches
    assert mag["serve"]["chunks"] == 2
    assert mag["serve"]["rho_max_abs_err_vs_cpu"] == 0.0
    assert mag["serve"]["r2_max_abs_err_vs_cpu"] == 0.0
