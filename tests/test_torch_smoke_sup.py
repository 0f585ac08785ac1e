"""`chip_smoke.py`'s sup phase (the supervised trainer at the JAX defaults
and in PM mode with resynthesis, 2D-Net serving from the second run, the
card-vs-CPU steps and the 2D-Net maps against the CPU and a float64
witness) rehearsed at a tiny size on the CPU, where every wrapper takes its
plain version. Imports no JAX. Budget: 30 s on a loaded Tier-1 worker
(1.3 s alone).
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


def test_sup_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    sup = chip_smoke.sup_phase(cpu, tmp_path / "s", size=32, n=4, batch=2,
                               f=4, parity_size=32, parity_batch=1)
    for run in sup["runs"].values():
        assert run["launches"] == no_launches and run["steps"] == 2
        assert chip_smoke._finite_losses(run["epochs"])
    srv = sup["serving_2d_net"]
    assert srv["launches"] == no_launches and srv["chunks"] == 2
    assert srv["checkpoint_step"] == srv["steps_trained"] == 2
    assert srv["maps_max_abs_diff_vs_seeded_init"] > 0
    # on the CPU the "card" is the CPU: every card-vs-CPU distance is 0
    for dist in (srv["vs_cpu"], srv["fit_on_card_maps_vs_cpu"]):
        assert set(dist.values()) == {0.0}
    f64 = srv["vs_cpu_float64"]
    assert f64["card"] == f64["cpu"] and 0 < f64["cpu"]["pm"] < 1e-3
    assert set(sup["parity"]) == set(chip_smoke.SUP_PARITY_CONFIGS)
    for par in sup["parity"].values():
        assert par["loss_rel_diff"] == par["grad_max_rel"] == 0.0
        assert set(par["metrics_rel_diff"].values()) == {0.0}
        vs64 = par["vs_cpu_float64"]
        assert vs64["card"] == vs64["cpu"] and 0.0 < vs64["cpu"] < 1e-3
    assert "WF_loss" in sup["parity"]["U-Net-PM-resynthesis"]["metrics"]
    # the gates pass but for the launches, which the CPU does not count
    with pytest.raises(AssertionError, match="skipped kernels"):
        chip_smoke.check_sup(sup)
    pm = sup["runs"]["U-Net-PM-resynthesis"]
    pm["launches"] = dict(no_launches, ideal_forward=2, ideal_fit=2)
    with pytest.raises(AssertionError, match="skipped the fit"):
        chip_smoke.check_sup(sup)
    srv["launches"] = dict(no_launches, ideal_fit=3)
    chip_smoke.check_sup(sup)
