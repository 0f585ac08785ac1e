"""`chip_smoke.py`'s e2e phase (AI-DEAL serving, and its first chunk against
the CPU) rehearsed at a tiny size on the CPU, where every wrapper takes its
plain version. Imports no JAX. Budget: 120 s on a loaded Tier-1 worker
(44.1–65.1 s under the Tier-1 command; 3.0 s alone).
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


def test_e2e_phase_rehearses_on_cpu(chip_smoke, tmp_path):
    cpu = torch.device("cpu")
    e2e = chip_smoke.e2e_phase(cpu, tmp_path / "e", size=32, n=3, batch=2)
    assert e2e["launches"] == {k.name: 0 for k in ops.KERNELS}
    assert e2e["maps_max_abs_err_vs_cpu"] == 0.0
