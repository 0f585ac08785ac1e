"""`chip_smoke.py`'s teaug phase (VET-Net TE-augmentation training and the
card-vs-CPU generator step with its witnesses) rehearsed at a tiny size on
the CPU, where every wrapper takes its plain version. Imports no JAX.
Budget: 120 s on a loaded Tier-1 worker (32.9–76.4 s under the Tier-1
command; 0.9 s alone).
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


def test_teaug_phase_rehearses_on_cpu(chip_smoke, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    teaug = chip_smoke.teaug_phase(cpu, tmp_path / "a", size=32, n=4,
                                   batch=2, f=4, parity_size=32,
                                   parity_batch=1)
    assert teaug["launches"] == no_launches and teaug["steps"] == 4
    assert [ep["epoch"] for ep in teaug["epochs"]] == [1, 2]
    assert teaug["parity"]["loss_rel_diff"] == 0.0
    assert teaug["parity"]["grad_max_rel"] == 0.0
    assert teaug["parity"]["metrics"] == teaug["parity"]["metrics_ref"]
    assert set(teaug["parity"]["metrics_rel_diff"].values()) == {0.0}
    assert teaug["parity"]["plain_convlstm_on_card_vs_cpu"] == 0.0
    # the float64 witness: the same step on both sides here, f32 rounding
    vs64 = teaug["parity"]["vs_cpu_float64"]
    assert vs64["card"] == vs64["cpu"] and 0.0 < vs64["cpu"] < 1e-3
    assert vs64["card_plain_convlstm"] == vs64["cpu"]
    # the plain ConvLSTM's output perturbed by 1e-7 of its scale, 4 seeds
    assert len(vs64["card_plain_convlstm_perturbed_1e_7"]) == 4
    assert all(0.0 < v < 1e-3
               for v in vs64["card_plain_convlstm_perturbed_1e_7"])
    assert teaug["parity"]["first_gradient_over_1e_2"] is None
    assert teaug["parity"]["relu_flips"] == {}
    assert teaug["parity"]["relu_outputs"] > 0
    assert "lstm" in dict(teaug["parity"]["gradient_rel"])
