"""`chip_smoke.py`'s train phase (AI-DEAL unsupervised training and the card-
vs-CPU step parity with its witness) rehearsed at a tiny size on the CPU,
where every wrapper takes its plain version. Imports no JAX. Budget: 150 s
on a loaded Tier-1 worker (17.8–92.4 s under the Tier-1 command; 1.7 s
alone).
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


def test_train_phase_rehearses_on_cpu(chip_smoke, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    train = chip_smoke.train_phase(cpu, tmp_path / "t", size=32, n=4,
                                   batch=2, f=4, parity_size=32,
                                   parity_batch=1)
    assert train["launches"] == no_launches
    assert [ep["epoch"] for ep in train["epochs"]] == [1, 2]
    for step in ("fm", "r2"):
        assert train["parity"][step]["loss_rel_diff"] == 0.0
        assert train["parity"][step]["grad_max_rel"] == 0.0
        assert train["parity"][step]["plain_convlstm_on_card_vs_cpu"] == 0.0
    witness = train["parity"]["zero_background_fm"]
    for pair in ("card_vs_cpu", "plain_convlstm_on_card_vs_cpu",
                 "card_vs_plain_convlstm_on_card"):
        assert witness[pair]["grad_max_rel"] == 0.0
    assert witness["first_forward_over_1e_3"] is None
    assert witness["first_gradient_over_1e_2"] is None
    assert sorted(witness["maxpool"]) == [f"down.{i}" for i in range(4)]
    assert all(p["routed_elsewhere"] == 0.0 and p["ties"] > 0.0
               for p in witness["maxpool"].values())
    assert len(witness["relu"]) == 18  # 9 conv blocks of g_fm, 2 ReLUs each
    for r in [witness["lstm_out"], *witness["relu"].values()]:
        assert r["mask_differs"] == r["max_abs_where_ref_zero"] == 0.0
        assert r["zeros"] == r["zeros_ref"]
    # the ConvLSTM output and the gradient reaching it are both traced
    assert "lstm" in dict(witness["forward_rel"])
    assert "lstm" in dict(witness["gradient_rel"])
