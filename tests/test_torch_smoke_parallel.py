"""`chip_smoke.py`'s parallel phase rehearsed on the CPU at a tiny size:
the sharded fit over ["cpu", "cpu"], two gloo ranks spawned for the
data-parallel AI-DEAL step pairs (with the one-process step and its
float64 witness), `cli.train_unsup` through the launcher on two CPU
processes with a resume, and the serving split over ["cpu", "cpu"]. The
kernels' launch counts are checked on the card only."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield chip_smoke.parallel_phase(
            torch.device("cpu"), tmp_path_factory.mktemp("parallel"),
            size=32, batch=4, f=4, n=6)
    finally:
        torch.set_num_threads(n)


def test_sharded_fit(phase):
    r = phase["sharded_fit"]
    assert r["devices"] == ["cpu", "cpu"]
    assert r["slice"]["bit_equal"] and r["h"]["bit_equal"]
    assert r["indivisible_raises"]


def test_data_parallel_step_pairs(phase):
    r = phase["dp"]
    assert r["backend"] == "gloo" and r["devices"] == ["cpu", "cpu"]
    assert r["params_bit_equal"] == [True, True]
    assert r["loss_rank0"] == r["loss_rank1"]
    assert r["parity"]["loss_rel_diff"] <= 2e-5
    assert r["parity"]["grad_max_rel"] <= 2e-2
    assert len(r["ms_per_step_pair"][0]) == 2


def test_launcher_run(phase):
    r = phase["launcher"]
    assert r["nproc"] == 2 and r["exit_code"] == 0
    assert r["files"]["settings"] == ["settings.yml"]
    assert r["files"]["event_files"] == 1
    assert r["resumed_lines"] == 1 and r["resume_exit_code"] == 0


def test_serving_split(phase):
    r = phase["serving_split"]
    assert r["devices"] == ["cpu", "cpu"] and r["finite"]
    assert r["maps_max_abs_diff"] <= 5e-3 and r["fit_bit_equal"]


def test_checks_fail_on_broken_results(phase):
    import copy
    bad = copy.deepcopy(phase)
    bad["dp"]["params_bit_equal"][1] = False
    with pytest.raises(AssertionError):
        chip_smoke.check_dp(bad["dp"], on_card=False)
    bad["sharded_fit"]["h"]["bit_equal"] = False
    with pytest.raises(AssertionError):
        chip_smoke.check_sharded_fit(bad["sharded_fit"], on_card=False)
    bad["launcher"]["files"]["event_files"] = 2
    with pytest.raises(AssertionError):
        chip_smoke.check_launcher(bad["launcher"])
    bad["serving_split"]["maps_max_abs_diff"] = 1e-2
    with pytest.raises(AssertionError):
        chip_smoke.check_serving_split(bad["serving_split"], on_card=False)
    # the launch counts of a card run: one fit launch per shard, the
    # train phase's per pair
    card = copy.deepcopy(phase)
    with pytest.raises(AssertionError):
        chip_smoke.check_dp(card["dp"], on_card=True)
