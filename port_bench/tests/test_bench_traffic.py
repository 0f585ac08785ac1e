"""The volume generator: the same sizes for the same seed, every size once
a cycle whatever the seed, and the sample the check compares."""

import numpy as np
import pytest
import torch

from port_bench.kinds import serve_volumes as sv
from port_bench.harness import Bench, Env

from .conftest import ROOT


def _state(seed, workload="aideal-serve"):
    bench = Bench(ROOT)
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    env = Env(torch.device("cpu"), seed, cfg, bench.traffic(cell["traffic"]),
              bench.family(cfg["family"]))
    state = sv.State(env, rng=np.random.default_rng(env.seeds["order"]))
    n = env.traffic.get("protocols", 1)
    state.acqs = [np.zeros((env.traffic["pool_slices"], 1))] * n
    for _ in range(3):
        sv._extend_plan(state)
    return state


@pytest.mark.parametrize("workload", ["aideal-serve", "vetnet-serve"])
def test_same_seed_same_volumes(workload):
    a, b = _state(2 ** 31 + 7, workload), _state(2 ** 31 + 7, workload)
    assert a.plan == b.plan


def test_every_size_once_a_cycle_for_any_seed():
    lo, hi = _state(1).env.traffic["volume_slices"]
    cycle = hi - lo + 1
    for seed in (1, 2, 3 * 10 ** 9):
        plan = _state(seed).plan
        for c in range(3):
            sizes = sorted(s for s, _, _ in plan[c * cycle:(c + 1) * cycle])
            assert sizes == list(range(lo, hi + 1))
    assert _state(1).plan != _state(2).plan


def test_volumes_are_views_of_the_pool():
    state = _state(5, "vetnet-serve")
    for size, p, start in state.plan:
        assert 0 <= p < state.env.traffic["protocols"]
        assert 0 <= start <= state.env.traffic["pool_slices"] - size
