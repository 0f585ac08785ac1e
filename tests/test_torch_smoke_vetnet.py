"""`chip_smoke.py`'s vetnet_serve phase (VET-Net trained for one epoch, then
served from its experiment directory, and its first slices against the
CPU and a float64 witness) rehearsed at a tiny size on the CPU, where every
wrapper takes its plain version. Imports no JAX. Budget: 30 s on a loaded
Tier-1 worker.
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


def test_vetnet_serve_phase_rehearses_on_cpu(chip_smoke, one_thread,
                                             tmp_path):
    cpu = torch.device("cpu")
    vet = chip_smoke.vetnet_serve_phase(cpu, tmp_path / "v", size=32, n=2,
                                        batch=2, f=4)
    assert vet["launches"] == {k.name: 0 for k in ops.KERNELS}
    assert vet["chunks"] == 1
    assert vet["checkpoint_step"] == vet["steps_trained"] == 1
    assert vet["maps_max_abs_diff_vs_seeded_init"] > 0
    # on the CPU the "card" is the CPU: every card-vs-CPU distance is 0
    for dist in (vet["vs_cpu"], vet["fit_on_card_maps_vs_cpu"]):
        assert set(dist.values()) == {0.0}
    f64 = vet["vs_cpu_float64"]
    assert f64["card"] == f64["cpu"] == f64["card_plain_convlstm"]
    assert 0 < f64["cpu"]["pm"] < 1e-3
    assert 0 < vet["phase_well_posed_share"] < 1
    assert 0 < vet["pdff_compared_share"] < 1
    # the gates pass but for the launches, which the CPU does not count
    with pytest.raises(AssertionError, match="skipped the ConvLSTM"):
        chip_smoke.check_vetnet_serve(vet)
    chip_smoke.check_vetnet_serve(dict(vet, launches=dict(
        vet["launches"], convlstm_fwd=12)))
