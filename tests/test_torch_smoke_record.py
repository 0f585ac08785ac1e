"""`chip_smoke.py`'s record phase (the run record of `cli.train_sup`:
settings.yml, G_losses summaries against the step metrics, checkpoints, a
resume under `--profile_dir`, and `TrainLoop` resumed) and its preempt
phase (SIGTERM to a training subprocess, then a resume) rehearsed at a
tiny size on the CPU, where every wrapper takes its plain version. Imports
no JAX. Budget: 25 s together on a loaded Tier-1 worker.
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


def test_record_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path):
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    r = chip_smoke.record_phase(cpu, tmp_path, size=16, f=4, loop_f=4,
                                cost_steps=20)
    assert r["launches"] == r["resumed_launches"] == no_launches
    assert r["steps_per_epoch"] == 20 and not r["settings_diff"]
    # every metric of both epochs' last steps, in train and validation
    assert r["summaries"]["compared"] == r["validation"]["compared"] > 0
    assert r["summaries"]["max_gap"] == 0.0 and not r["summaries"]["missing"]
    assert r["checkpoints"] == [2] and r["resumed_epochs"] == [3]
    assert r["checkpoints_after_resume"] == [2, 3]
    assert r["trace_events"] > 0 and r["trace_kernels"] == 0
    loop = r["trainloop"]
    assert [run["steps"] for run in loop["runs"]] == [20, 10]
    assert loop["summary_steps"] == [20] and loop["summary_tags"] > 3
    cost = r["record_cost"]
    assert cost["summaries_written"] == 2
    assert [len(v) for v in cost["ms_per_step"].values()] == [2, 2]
    # the gates pass but for the launches, which the CPU does not count
    with pytest.raises(AssertionError, match="record skipped kernels"):
        chip_smoke.check_record(r, on_card=False)
    loop["runs"][0]["launches"] = dict(no_launches, ideal_cycle=20,
                                       convlstm_fwd=240, convlstm_bwd=140)
    r["launches"] = dict(no_launches, ideal_fit=40)
    chip_smoke.check_record(r, on_card=False)
    # a summary that left the step metrics fails
    r["summaries"]["max_gap"] = 1e-3
    with pytest.raises(AssertionError, match="event scalars"):
        chip_smoke.check_record(r, on_card=False)


def test_preempt_phase_rehearses_on_cpu(chip_smoke, tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    p = chip_smoke.preempt_phase(torch.device("cpu"), tmp_path, size=16,
                                 f=4, timeout=120)
    assert p["signalled"] and p["rc"] == 0, p
    assert p["preempted_epoch"] >= 2
    assert p["preempted_epoch"] in p["checkpoints"]
    assert p["resume"]["rc"] == 0 and p["resume"]["resumed"], p
    chip_smoke.check_preempt(p)
    with pytest.raises(AssertionError, match="preemption"):
        chip_smoke.check_preempt(dict(p, rc=-15))
