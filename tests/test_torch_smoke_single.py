"""`chip_smoke.py`'s single phase (the single-subject CLI at the JAX
defaults, a counted and timed step, every ConvLSTM parameter's gradient
and the card-vs-CPU step with its float64 witness) rehearsed at a tiny size
on the CPU, where every wrapper takes its plain version. Imports no JAX.
Budget: 20 s on a loaded Tier-1 worker.
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


def test_single_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    sgl = chip_smoke.single_phase(cpu, tmp_path, size=32, f=4, epochs=2,
                                  parity_size=32)
    assert sgl["launches"] == sgl["launches_per_step"] == no_launches
    assert [e["epoch"] for e in sgl["epochs"]] == [1, 2]
    assert chip_smoke._finite_losses(sgl["epochs"])
    assert not sgl["no_gradient"] and sgl["peak_memory_gb"] is None
    par = sgl["parity"]
    assert par["loss_rel_diff"] == par["grad_max_rel"] == 0.0
    assert set(par["metrics_rel_diff"].values()) == {0.0}
    # both nets' leaves, G_mag's as "0.", G_pha's as "1."
    assert {k.split(".")[0] for k in par["grad_worst_leaf"].split()} <= \
        {"0", "1"} and par["leaves"] > 100
    vs64 = par["vs_cpu_float64"]
    assert vs64["card"] == vs64["cpu"] and 0.0 < vs64["cpu"] < 1e-3
    assert "BP_GR" in par["metrics"]
    # the gates pass but for the launches, which the CPU does not count
    with pytest.raises(AssertionError, match="skipped the ConvLSTM"):
        chip_smoke.check_single(sgl)
    sgl["launches"] = dict(no_launches, convlstm_fwd=44, convlstm_bwd=28)
    sgl["launches_per_step"] = dict(no_launches, convlstm_fwd=22,
                                    convlstm_bwd=14)
    chip_smoke.check_single(sgl)
