"""Multi-process execution (port of `ideal_gan_tpu/parallel/multihost.py`).

The JAX package joins one controller per host to a distributed runtime,
and its devices span the hosts. The port runs one process per card, under
the `torch.distributed.run` launcher:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m ideal_gan_tpu_torch.cli.train_unsup ...

- `initialize_distributed()`: one call at the top of every trainer CLI
  (`cli.common.setup_experiment`). Under a launcher it joins the process
  group and sets the rank's card before any CUDA use; with no launcher
  environment it does nothing and returns False.
- `global_data_mesh()`: the 'data' mesh over every rank.
- `process_batch_slice(n)`: the rows [lo, hi) of the global batch this
  process loads.
- `host_local_to_global(batch, mesh)`: a process's own numpy rows → its
  device tensors (each rank holds only its shard, so no copy across ranks);
  at one process, exactly `shard_batch`.

JAX's TPU-pod auto-detection from the hardware has no counterpart: a run
without a launcher environment is one process.
"""

from __future__ import annotations

import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, _tree_map, data_mesh, shard_batch, world

_log = logging.getLogger(__name__)
_state: dict = {"device": None}


def rank_device() -> torch.device | None:
    """The device `initialize_distributed` set for this rank (None before
    it or without a launcher)."""
    return _state["device"]


def _launcher_env(coordinator_address, num_processes, process_id,
                  local_device_ids):
    """(init_method, world size, rank, local rank) from the arguments, else
    the launcher's environment (`MASTER_ADDR`/`MASTER_PORT`, `WORLD_SIZE`,
    `RANK`, `LOCAL_RANK`), else JAX's names (`COORDINATOR_ADDRESS`
    host:port, `NUM_PROCESSES`, `PROCESS_ID`, `LOCAL_DEVICE_IDS`); None
    where no address is given."""
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        else:
            coordinator_address = env.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return None
    if num_processes is None:
        num = env.get("WORLD_SIZE", env.get("NUM_PROCESSES"))
        num_processes = int(num) if num is not None else None
    if process_id is None:
        pid = env.get("RANK", env.get("PROCESS_ID"))
        process_id = int(pid) if pid is not None else None
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address!r} given without a world "
            "size and a rank (WORLD_SIZE/RANK or NUM_PROCESSES/PROCESS_ID)")
    if local_device_ids is None:
        if "LOCAL_RANK" in env:
            local_device_ids = [int(env["LOCAL_RANK"])]
        elif "LOCAL_DEVICE_IDS" in env:
            local_device_ids = [int(x) for x in
                                env["LOCAL_DEVICE_IDS"].split(",")]
        else:
            local_device_ids = [0]
    elif isinstance(local_device_ids, int):
        local_device_ids = [local_device_ids]
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    return init, int(num_processes), int(process_id), int(local_device_ids[0])


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids=None, backend: str | None = None,
                           device: str | None = None,
                           timeout_s: float = 600.0) -> bool:
    """Join the process group of a multi-process run.

    Returns True when a process group was (or already is) live, False for
    the one-process no-op. Safe to call unconditionally and repeatedly.
    Explicit arguments override the environment (`_launcher_env`);
    `coordinator_address` may be host:port or an init URL (`file://...`).
    `device` "cuda" (the default) gives the rank the card `cuda:<local
    rank>`, set as the current card before any other CUDA use, and raises
    where that card does not exist; "cpu" keeps the rank on the CPU. The
    backend is `nccl` for cards and `gloo` for the CPU unless `backend`
    names one; a backend that fails to initialise raises. Every group gets
    `timeout_s`."""
    if dist.is_initialized():
        return True
    found = _launcher_env(coordinator_address, num_processes, process_id,
                          local_device_ids)
    if found is None:
        return False
    init, n, rank, local = found
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= count:
            raise RuntimeError(
                f"rank {rank} (local rank {local}) has no card: "
                f"{count} visible; start at most {count} processes a node")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = dict(backend=backend, init_method=init, world_size=n, rank=rank,
              timeout=datetime.timedelta(seconds=timeout_s))
    dist.init_process_group(**kw)
    _state["device"] = dev
    _log.info("distributed runtime: rank %d/%d on %s, backend %s", rank, n,
              dev, backend)
    return True


def global_data_mesh(model: int = 1, device=None) -> Mesh:
    """The 'data' mesh over every rank of the run."""
    return data_mesh(model=model, device=device)


def process_batch_slice(global_batch: int,
                        process_id: int | None = None) -> tuple[int, int]:
    """[lo, hi) of the global batch this process loads. The global batch
    must divide by the process count."""
    n, rank = world()
    pid = rank if process_id is None else process_id
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the "
            f"{n}-process pod; pick a multiple of {n}")
    per = global_batch // n
    return pid * per, (pid + 1) * per


def host_local_to_global(batch, mesh: Mesh):
    """This process's host rows (numpy) of a global batch → tensors on its
    device: each rank already holds its own shard. At one process, exactly
    `shard_batch`."""
    if mesh.group is None:
        return shard_batch(batch, mesh)
    return _tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(
        mesh.device), batch)
