"""The rest of a run, on the CPU at a small size, with the timed path
broken underneath: `correct` comes out false for each fault a cell can
have (an answer altered where it is produced; a step that leaves the
state unchanged, or VET-Net's TE encoders unchanged; half the batch left
out, the mean over the rest), and true without one."""

import pytest

from port_bench.harness import run_cell

from .conftest import ROOT, SMALL_CFG, SMALL_TRAFFIC


def _run(workload, faults=()):
    return run_cell(ROOT, workload, 2 ** 32 + 5, 0.5, False, "cpu",
                    faults=faults, cfg_overrides=SMALL_CFG,
                    traffic_overrides=SMALL_TRAFFIC)


@pytest.mark.parametrize("workload,fault", [
    ("aideal-serve", None), ("aideal-serve", "alter_answer"),
    ("vetnet-serve", None), ("vetnet-serve", "alter_answer"),
    ("vetnet-train", None), ("vetnet-train", "frozen_state"),
    ("vetnet-train", "half_batch"), ("vetnet-train", "frozen_te"),
    ("aideal-train", None), ("aideal-train", "frozen_state"),
    ("aideal-train", "half_batch")])
def test_fault_fails_the_check(small_program, workload, fault):
    r = _run(workload, () if fault is None else (fault,))
    assert r["correct"] is (fault is None), r["checks"]
    assert list(r)[-1] == "checks"
