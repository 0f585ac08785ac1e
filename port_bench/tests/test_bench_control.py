"""The control: the program's bfloat16 path in place of its float32 one,
compared as a run compares the program, fails the check; the program
passes. On the CPU at a small size; at the cell's own size on the card
(`cuda` marker)."""

import pytest

from port_bench.control import look, readings
from port_bench.harness import Bench

from .conftest import ROOT, SMALL_CFG, SMALL_TRAFFIC

CELLS = [w["name"] for w in Bench(ROOT).spec["workloads"]]


def _limits(workload):
    bench = Bench(ROOT)
    cell = bench.workload(workload)
    kind = bench.traffic(cell["traffic"])["kind"]
    return bench.config(cell["config"])["limits"][
        "serve" if kind == "serve_volumes" else "train"]


def _fails(r, limits):
    return any(r[k] > v for k, v in limits.items())


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_program_passes_small(small_program, workload):
    bench = Bench(ROOT)
    if not bench.config(bench.workload(workload)["config"])["cudnn_tf32"]:
        pytest.skip("the control is TF32 convolutions, which a CPU has not")
    limits = _limits(workload)
    prog = readings(workload, 9, "program", "cpu", SMALL_CFG, SMALL_TRAFFIC)
    ctl = readings(workload, 9, "control", "cpu", SMALL_CFG, SMALL_TRAFFIC)
    assert not _fails(prog, limits), prog
    assert _fails(ctl, limits), ctl


def test_look_small(small_program):
    """The look's plumbing: every leaf against float64 from every side; on
    the CPU the program and the float32 reference agree with it."""
    r = look("vetnet-train", 9, "cpu", SMALL_CFG, SMALL_TRAFFIC)
    te = [k for k in r["leaves"] if ".encoder.te." in k]
    assert te and len(r["leaves"]) > len(te)
    for k, v in r["leaves"].items():
        for side in ("program", "program_tf32_off", "reference32"):
            assert 0.0 <= v[side]["sign"] <= 1.0, (k, side)
    big = max(r["leaves"].values(), key=lambda v: v["norm"])
    assert big["program"]["gap"] < 1e-3 and big["reference32"]["gap"] < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_cell_size(card, workload):
    limits = _limits(workload)
    for seed in (101, 102, 103):
        assert _fails(readings(workload, seed, "control", card), limits)
