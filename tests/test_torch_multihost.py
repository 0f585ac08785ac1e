"""The port's multi-process wiring (`ideal_gan_tpu_torch.parallel.multihost`,
`data/pipeline.py`, the trainer CLIs under `torch.distributed.run`) against
the JAX package's (`tests/test_multihost.py`) on the CPU.

Every group of processes here rendezvouses through a `file://` path or
the launcher's `--standalone` port (never a fixed port), runs torch on one
thread, and has a process-group timeout and a join timeout with a kill.
"""

from __future__ import annotations

import datetime
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from ideal_gan_tpu_torch.cli import common as cli_common
from ideal_gan_tpu_torch.data import Dataset, minmax_norm
from ideal_gan_tpu_torch.parallel import multihost, process_batch_slice

from test_torch_parallel import run_ranks

LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID", "LOCAL_DEVICE_IDS")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.fixture
def captured_init(no_launcher):
    """`init_process_group` replaced by a recorder (no group is made)."""
    calls = []
    no_launcher.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    no_launcher.setattr(multihost, "_state", {"device": None})
    return calls


def test_no_environment_is_a_no_op(captured_init):
    assert multihost.initialize_distributed() is False
    assert captured_init == []
    assert multihost.rank_device() is None


def test_launcher_environment(no_launcher, captured_init):
    env = dict(MASTER_ADDR="localhost", MASTER_PORT="29511", WORLD_SIZE="4",
               RANK="3", LOCAL_RANK="1")
    for k, v in env.items():
        no_launcher.setenv(k, v)
    assert multihost.initialize_distributed(device="cpu", timeout_s=42)
    (kw,) = captured_init
    assert kw["init_method"] == "tcp://localhost:29511"
    assert (kw["world_size"], kw["rank"], kw["backend"]) == (4, 3, "gloo")
    assert kw["timeout"] == datetime.timedelta(seconds=42)
    assert multihost.rank_device() == torch.device("cpu")


def test_jax_environment_names_and_overrides(no_launcher, captured_init):
    for k, v in dict(COORDINATOR_ADDRESS="10.0.0.1:1234", NUM_PROCESSES="2",
                     PROCESS_ID="1", LOCAL_DEVICE_IDS="0").items():
        no_launcher.setenv(k, v)
    assert multihost._launcher_env(None, None, None, None) == (
        "tcp://10.0.0.1:1234", 2, 1, 0)
    # explicit arguments win over the environment
    assert multihost._launcher_env("file:///tmp/x", 8, 5, [3]) == (
        "file:///tmp/x", 8, 5, 3)
    assert multihost.initialize_distributed(device="cpu", backend="gloo")
    assert captured_init[0]["world_size"] == 2
    no_launcher.delenv("NUM_PROCESSES")
    with pytest.raises(ValueError, match="world"):
        multihost._launcher_env("h:1", None, None, None)


def test_a_rank_without_a_card_raises(no_launcher, captured_init):
    """A launcher rank never shares a card or moves to the CPU by itself."""
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT="1",
                     WORLD_SIZE="2", RANK="1", LOCAL_RANK="1").items():
        no_launcher.setenv(k, v)
    with pytest.raises(RuntimeError):
        multihost.initialize_distributed()      # device "cuda" by default
    with pytest.raises(RuntimeError):
        cli_common.resolve_device("cuda")
    no_launcher.setattr(torch.cuda, "is_available", lambda: True)
    no_launcher.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card"):
        cli_common.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no card"):
        multihost.initialize_distributed()
    assert captured_init == []


def test_process_batch_slice():
    assert process_batch_slice(8) == (0, 8)
    assert process_batch_slice(8, process_id=0) == (0, 8)


def test_dataset_matches_jax():
    from ideal_gan_tpu.data import Dataset as JDataset
    from ideal_gan_tpu.data import minmax_norm as jminmax

    xs = np.arange(20)
    ys = np.arange(20) * 10.0

    def pipeline(cls, i):
        return list(cls.from_arrays(xs, ys, seed=7).shuffle().shard(2, i)
                    .filter(lambda r: r[0] % 3).map(lambda r: (r[0], -r[1]))
                    .batch(3).repeat(2).prefetch(2))

    for i in range(2):
        got, want = pipeline(Dataset, i), pipeline(JDataset, i)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).normal(size=(4, 5))
    np.testing.assert_array_equal(minmax_norm(x), jminmax(x))


def test_dataset_shard_partitions():
    shards = [list(Dataset.from_arrays(np.arange(20)).shard(4, i))
              for i in range(4)]
    assert sorted(int(r) for s in shards for r in s) == list(range(20))
    assert all(len(s) == 5 for s in shards)


@pytest.mark.parametrize("shard_first", [False, True])
def test_dataset_shard_and_shuffle_disjoint(shard_first):
    got = []
    for i in range(2):
        ds = Dataset.from_arrays(np.arange(16), seed=7)
        ds = ds.shard(2, i).shuffle() if shard_first \
            else ds.shuffle().shard(2, i)
        got.append([int(r) for r in ds])
    assert len(got[0]) == len(got[1]) == 8
    assert not set(got[0]) & set(got[1])
    assert sorted(got[0] + got[1]) == list(range(16))


def test_shard_default_noop_single_process():
    assert len(list(Dataset.from_arrays(np.arange(6)).shard())) == 6
    with pytest.raises(ValueError):
        Dataset.from_arrays(np.arange(6)).shard(2, 2)


_MEAN_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from ideal_gan_tpu_torch.data import Dataset
    from ideal_gan_tpu_torch.parallel import (global_data_mesh,
        host_local_to_global, initialize_distributed, process_batch_slice)
    from ideal_gan_tpu_torch.parallel.mesh import reduce_metrics

    pid = int(sys.argv[1])
    assert initialize_distributed(sys.argv[2], 2, pid, device="cpu",
                                  timeout_s=60)
    assert initialize_distributed()           # idempotent
    mesh = global_data_mesh(device="cpu")
    assert mesh.size == 2 and mesh.index == pid
    lo, hi = process_batch_slice(8)
    assert hi - lo == 4
    try:
        process_batch_slice(7)
        raise AssertionError("7 rows split over 2 processes")
    except ValueError:
        pass
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    local = host_local_to_global(full[lo:hi], mesh)
    got = float(reduce_metrics({"m": local.mean()}, mesh)["m"])
    assert abs(got - float(full.mean())) < 1e-6, got
    rows = [int(r) for r in Dataset.from_arrays(np.arange(10)).shard()]
    assert rows == list(range(pid, 10, 2)), rows
    print(f"proc {pid}: global_mean OK {got:.4f}")
    dist.destroy_process_group()
""")


def test_two_process_global_mean(groups):
    assert all("global_mean OK" in o for o in groups["mean"])


_LOOP_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from ideal_gan_tpu_torch.cli.common import synthetic_dataset
    from ideal_gan_tpu_torch.parallel import data_mesh, initialize_distributed
    from ideal_gan_tpu_torch.train import unsup
    from ideal_gan_tpu_torch.train.common import TrainLoop

    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    assert initialize_distributed(init, 2, rank, device="cpu", timeout_s=60)
    mesh = data_mesh(device="cpu")
    cfg = dict(unsup.DEFAULTS, n_G_filters=4, out_vars="FM", batch_size=4,
               epochs=3, epoch_ckpt=1)
    acqs, _, te = synthetic_dataset(8, 32, 32)
    g_fm, g_r2 = unsup.build_models(cfg)
    step, tx = unsup.make_train_step(cfg, g_fm, g_r2, mesh)
    state = unsup.init_state(cfg, g_fm, g_r2, tx,
                             torch.Generator().manual_seed(0), "cpu", mesh)
    loop = TrainLoop(step, out, epoch_ckpt=1, device="cpu", mesh=mesh)

    def on_epoch_end(ep, state):
        if rank == 1 and ep == 1:   # a signal to rank 1 alone
            loop.record.guard.should_stop = True

    state = loop.run(state, 3, lambda: [(acqs[:4], te[:4]),
                                        (acqs[4:], te[4:])],
                     hooks={"on_epoch_end": on_epoch_end})
    flat = torch.cat([p.detach().reshape(-1) for p in g_fm.parameters()])
    print(f"rank {rank}: stopped at step {state.step}, params "
          f"{flat.double().sum().item()!r}")
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Two groups of two ranks, started at once: the global-mean worker and
    the `TrainLoop` worker (each its own `file://` rendezvous)."""
    tmp = tmp_path_factory.mktemp("groups")
    (tmp / "mean.py").write_text(_MEAN_WORKER)
    (tmp / "loop.py").write_text(_LOOP_WORKER)

    def argv(i):
        name = ("mean", "loop")[i // 2]
        return [sys.executable, str(tmp / f"{name}.py"), str(i % 2),
                f"file://{tmp / (name + '.rendezvous')}", str(tmp / "run")]

    outs = run_ranks(argv, tmp, n=4, timeout=120)
    return {"mean": outs[:2], "loop": outs[2:], "run": tmp / "run"}


def test_trainloop_on_two_ranks(groups):
    """`TrainLoop` with a mesh: each rank steps on its rows, rank 0 alone
    writes, and a signal to one rank stops both after that epoch's
    checkpoint."""
    outs, run = groups["loop"], groups["run"]
    lines = [next(ln for ln in o.splitlines() if "stopped at" in ln)
             for o in outs]
    assert "step 4," in lines[0], outs
    assert lines[0].split("params")[1] == lines[1].split("params")[1]
    assert "preempted: checkpointed epoch 2, exiting" in outs[0]
    assert "preempted" not in outs[1]
    assert sorted(p.name for p in (run / "checkpoints").glob("*")) == [
        "ckpt-1.pt", "ckpt-2.pt"]
    assert len(list((run / "summaries" / "train").glob("events.*"))) == 1


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """`cli.train_unsup --device cpu` under `torch.distributed.run
    --standalone --nproc_per_node 2` (its two ranks on the CPU), at batch 2
    and at batch 3, the two launches at once: {batch: (output base, the
    launcher's output)}."""
    tmp = tmp_path_factory.mktemp("launched")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in LAUNCH_ENV:
        env.pop(k, None)
    batches = (2, 3)

    def argv(i):
        return [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "2", "-m",
                "ideal_gan_tpu_torch.cli.train_unsup", "--device", "cpu",
                "--synthetic", "6", "--data_size", "32", "--n_G_filters",
                "4", "--epochs", "1", "--out_vars", "FM", "--batch_size",
                str(batches[i]), "--output_base", str(tmp / f"b{batches[i]}")]

    outs = run_ranks(argv, tmp, n=2, timeout=240, env=env)
    return {b: (tmp / f"b{b}", o) for b, o in zip(batches, outs)}


def test_train_unsup_under_the_launcher(launched):
    base, log = launched[2]
    assert "epoch 1/1 cycle_loss=" in log, log
    run = base / "Unsup-v0"
    assert sorted(p.name for p in run.glob("settings*")) == ["settings.yml"]
    assert (run / "checkpoints" / "ckpt-1.pt").exists()
    events = list((run / "summaries" / "train").glob("events.*"))
    assert len(events) == 1, events
    # rank 1 printed nothing of the record: one epoch line in the log
    assert log.count("epoch 1/1 cycle_loss=") == 1, log


def test_idle_rank_under_the_launcher(launched):
    """Batch 3 on two ranks: a one-rank mesh (the warning), rank 1 idle."""
    base, log = launched[3]
    assert "rank 1: idle" in log and "1-device mesh" in log, log
    assert "epoch 1/1 cycle_loss=" in log, log
    assert (base / "Unsup-v0" / "checkpoints" / "ckpt-1.pt").exists()
