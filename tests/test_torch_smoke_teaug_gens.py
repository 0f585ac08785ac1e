"""`chip_smoke.py`'s teaug_gens phase (the TE-augmentation CLI with the
U-Net, 2U-Net and MDWF-Net generators, and each one's card-vs-CPU steps
with a float64 witness) rehearsed at a tiny size on the CPU, where every
wrapper takes its plain version. Imports no JAX. Budget: 30 s on a loaded
Tier-1 worker (1.5 s alone).
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


def test_teaug_gens_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    gens = chip_smoke.teaug_gens_phase(cpu, tmp_path / "g", size=32, n=4,
                                       batch=2, f=4, parity_size=32,
                                       parity_batch=1)
    for g in chip_smoke.TEAUG_GENS:
        run = gens[g]
        assert run["launches"] == no_launches and run["steps"] == 2
        steps = {"generator", "r2", "r2_step_changes"} if g == "2U-Net" \
            else {"generator"}
        assert set(run["parity"]) == steps
        for step in steps - {"r2_step_changes"}:
            par = run["parity"][step]
            assert par["loss_rel_diff"] == par["grad_max_rel"] == 0.0
            assert set(par["metrics_rel_diff"].values()) == {0.0}
            vs64 = par["vs_cpu_float64"]
            assert vs64["card"] == vs64["cpu"] and 0.0 < vs64["cpu"] < 1e-3
    assert set(gens["2U-Net"]["parity"]["r2"]["metrics"]) == {
        "R2_loss", "TV_R2_aux", "WF_loss_aux"}
    changes = gens["2U-Net"]["parity"]["r2_step_changes"]
    assert changes["G_A2B"] == [] and changes["G_A2R2"]
    # the gates pass but for the launches, which the CPU does not count
    with pytest.raises(AssertionError, match="skipped kernels"):
        chip_smoke.check_teaug_gens(gens)
    for g, synth in (("U-Net", 2), ("2U-Net", 4), ("MDWF-Net", 2)):
        gens[g]["launches"] = dict(no_launches, ideal_forward=synth)
        if g != "MDWF-Net":
            gens[g]["launches"].update(convlstm_fwd=4, convlstm_bwd=2,
                                       ideal_fit=4)
    chip_smoke.check_teaug_gens(gens)
