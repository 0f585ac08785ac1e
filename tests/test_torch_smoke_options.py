"""`chip_smoke.py`'s options phase (the trainers' bf16, remat and microbatch
options: the bf16 + remat AI-DEAL and VET-Net CLIs, the microbatched VET-Net
CLI, the bf16 card-vs-CPU steps and the microbatched-vs-full-batch
gradients) rehearsed at a tiny size on the CPU, where every wrapper takes
its plain version. Imports no JAX.
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


def test_options_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    opts = chip_smoke.options_phase(cpu, tmp_path, size=32, n=4, batch=2,
                                    parity_size=32, f_main=4, f_teaug=4)
    u, t, m = (opts[k] for k in ("unsup_bf16_remat", "teaug_bf16_remat",
                                 "teaug_microbatch"))
    for run in (u, t, m):
        assert run["launches"] == no_launches and run["finite"]
    # 2 epochs of 2 step pairs; the launches the card must show for them
    # (remat leaves the ConvLSTM front out: no second forward)
    assert u["step_pairs"] == 4
    assert u["expected_launches"] == {"convlstm_fwd_bf16": 4 * 34,
                                      "convlstm_bwd_bf16": 4 * 14}
    assert u["peak_memory_gb"] is None and t["peak_memory_gb"] is None
    for step in ("fm", "r2"):
        par = u["parity"][step]
        # the CPU against itself: within the gate, the witness non-zero, and
        # the f32 step, a zeroed and a flipped gradient outside it
        assert par["loss_gap"] == par["grad_gap"] == 0.0
        assert par["within_gate"] and par["failures"] == []
        assert par["ref_vs_f32"] > 0.0 and par["loss_bf16_effect"] > 0.0
        assert par["controls_fail"]
        assert "bf16 applied" in par["controls"]["f32_step"]
        assert "gradient" in par["controls"]["zero_gradient"]
        assert "gradient" in par["controls"]["flipped_gradient"]
    assert t["steps"] == 2 and m["steps"] == 2 and m["chunks_per_step"] == 1
    par = m["parity"]
    assert par["within_gate"] and par["loss_rel_diff"] < 1e-6
    assert par["full_step"]["ms_per_step"] > 0.0
    # the gates pass but for the launches, which the CPU does not count
    with pytest.raises(AssertionError, match="skipped"):
        chip_smoke.check_options(opts)
    u["launches"] = dict(no_launches, **u["expected_launches"])
    t["launches"] = dict(no_launches, convlstm_fwd_bf16=2 * 23,
                         convlstm_bwd_bf16=2 * 7)
    m["launches"] = dict(no_launches, ideal_forward=2, convlstm_fwd=22,
                         convlstm_bwd=14)
    chip_smoke.check_options(opts)
    # a run of the f32 ConvLSTM kernels on the bf16 path fails it, and so
    # does an extra forward (a rematerialized ConvLSTM front)
    u["launches"]["convlstm_fwd"] = 1
    with pytest.raises(AssertionError, match="f32"):
        chip_smoke.check_options(opts)
    u["launches"]["convlstm_fwd"] = 0
    u["launches"]["convlstm_fwd_bf16"] += 2 * 6 * 4
    with pytest.raises(AssertionError, match="skipped"):
        chip_smoke.check_options(opts)
    # a bf16 step whose control passes its gate fails the phase
    u["launches"] = dict(no_launches, **u["expected_launches"])
    u["parity"]["fm"]["controls_fail"] = False
    with pytest.raises(AssertionError, match="bf16 unsup"):
        chip_smoke.check_options(opts)
