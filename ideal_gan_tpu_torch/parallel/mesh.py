"""The data mesh and its collectives (port of `ideal_gan_tpu/parallel/mesh.py`).

The JAX package scales training by data parallelism over a 1-D device mesh
(the 'data' axis): batches are sharded on their leading axis, parameters
and optimizer state are replicated, and jit emits the gradient all-reduce.
The port runs one process per card under `torch.distributed` (the
`torch.distributed.run` launcher; `parallel.multihost`), so its mesh is a
set of ranks: each rank holds the whole model on its own device and its
rows of every batch, and the collectives that JAX's jit inserts implicitly
are explicit calls here:

- `all_reduce_grads`: the gradients summed over the data group and divided
  by its size, in one flat bucket per dtype (a None gradient counts as
  zeros), before the optimizer's update (`train.common.Adam`, `SGD`);
- `reduce_metrics`: a step's metrics averaged over the group, so that a
  summary equals the one-process run's;
- `all_gather_rows`: a tensor's rows from every rank in rank order (the GAN
  replay pool's global fake batch; differentiable, for the latent
  covariance regularizer).

A rank's step must compute its share of the one-process step: batch-mean
terms decompose as they are over equal shards, batch-sum terms carry the
data size (`data_size`), and every random draw is made for the global
batch by a generator in the same state on every rank, the rank keeping its
rows (`rank_rows`), as `jax.random` behaves under sharding.

A 'model' axis is reserved in `data_mesh(model=...)`, as in the JAX
package: nothing uses it in either package, so only its shape is ported.
Without a process group (one process) every function here is the identity
on one device. `gloo` cannot run every collective on CUDA tensors, so its
collectives stage them through pinned host memory.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Iterable

import numpy as np
import torch
import torch.distributed as dist

_log = logging.getLogger(__name__)
_GROUPS: dict = {}


def world() -> tuple[int, int]:
    """(world size, this process's rank) of the live process group, or
    (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def default_device() -> torch.device:
    """This process's device: the one `initialize_distributed` set for its
    rank, or else the current card. Raises without a card: nothing moves to
    the CPU by itself."""
    from .multihost import rank_device
    dev = rank_device()
    if dev is not None:
        return dev
    from ..cli.common import resolve_device
    return resolve_device("cuda")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The torch form of the JAX mesh: the global ranks of the mesh (shape
    (n,), or (n // model, model) with a model axis), its axis names, this
    process's device and rank, and the process group over the mesh's ranks
    (None where the mesh has one rank or the run one process)."""
    ranks: np.ndarray
    axis_names: tuple
    device: torch.device
    rank: int = 0
    group: Any = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        """The number of ranks in the mesh."""
        return int(self.ranks.size)

    @property
    def active(self) -> bool:
        """Whether this process is one of the mesh's ranks (a rank outside
        it takes no step)."""
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        """This rank's position along the 'data' axis."""
        if not self.active:
            raise ValueError(f"rank {self.rank} is outside the "
                             f"{self.size}-rank mesh")
        return int(np.argwhere(self.ranks == self.rank)[0][0])

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes the run's files."""
        return self.rank == 0


def _group(ranks: tuple):
    """The process group over `ranks`: the default group where they are the
    whole world, else a new group, made once per set of ranks (every
    process calls this in the same order, as `new_group` requires)."""
    if len(ranks) == world()[0]:
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def data_mesh(n_devices: int | None = None, model: int = 1,
              device=None) -> Mesh:
    """The mesh over the first `n_devices` ranks (default all of them), 1-D,
    or (n // model, model) with a model axis. `device` is this rank's
    (default `default_device()`)."""
    n_world, rank = world()
    n = n_devices or n_world
    if n > n_world:
        raise ValueError(f"a {n}-rank mesh needs {n} processes; the run has "
                         f"{n_world}")
    ranks = np.arange(n)
    group = _group(tuple(range(n))) if n > 1 else None
    dev = torch.device(device) if device is not None else default_device()
    if model > 1:
        return Mesh(ranks.reshape(n // model, model), ("data", "model"), dev,
                    rank, group)
    return Mesh(ranks, ("data",), dev, rank, group)


def split_count(batch_size: int, n_devices: int) -> int:
    """The largest count ≤ n_devices that divides the batch (1 for a batch
    of 1)."""
    n = n_devices
    while n > 1 and batch_size % n != 0:
        n -= 1
    return n


def data_mesh_for_batch(batch_size: int, model: int = 1,
                        device=None) -> Mesh:
    """The largest mesh whose size divides the batch. Warns when the batch
    size leaves ranks idle (e.g. the GAN's default batch 1 on 8 cards
    trains on one): those ranks take no step."""
    n_avail = world()[0]
    n = split_count(batch_size, n_avail)
    if n < n_avail:
        _log.warning(
            "data_mesh_for_batch: batch_size=%d is not divisible by the "
            "%d available devices — using a %d-device mesh (%d devices "
            "idle). Pick a batch size divisible by the device count to "
            "use the full slice.", batch_size, n_avail, n, n_avail - n)
    return data_mesh(n, model=model, device=device)


def data_size(mesh: Mesh | None) -> int:
    """The 'data' axis's size (1 without a mesh): the factor of a rank's
    batch-sum loss terms."""
    return 1 if mesh is None else mesh.shape["data"]


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def rank_rows(x: torch.Tensor, mesh: Mesh | None):
    """This rank's rows [r·per, (r+1)·per) of `x`'s leading axis, per =
    len(x) / the data size (all of `x` without a mesh). ValueError where
    the data size does not divide it."""
    n = data_size(mesh)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"leading axis {x.shape[0]} must divide over the "
                         f"{n}-rank 'data' mesh")
    per = x.shape[0] // n
    return x[mesh.index * per:(mesh.index + 1) * per]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a batch goes on a mesh (the torch form of a `NamedSharding`):
    `sharded`, this rank's rows of every tensor, else all of it; on the
    rank's device. Calling it on a pytree of tensors or numpy arrays places
    each leaf."""
    mesh: Mesh
    sharded: bool

    def __call__(self, batch):
        def place(x):
            x = torch.as_tensor(x)
            if self.sharded:
                x = rank_rows(x, self.mesh)
            return x.to(self.mesh.device)
        return _tree_map(place, batch)


def batch_sharding(mesh: Mesh) -> Placement:
    """The leading (batch) axis split over 'data'."""
    return Placement(mesh, True)


def replicate(mesh: Mesh) -> Placement:
    """The whole of every tensor on every rank."""
    return Placement(mesh, False)


def shard_batch(batch, mesh: Mesh):
    """Every tensor of `batch` with its leading axis split over 'data': this
    rank's rows, on its device."""
    return batch_sharding(mesh)(batch)


def _staged(t: torch.Tensor, group, op):
    """Run `op(buffer)` on `t`, through pinned host memory where the group's
    backend is gloo and `t` is on a card; the result written back to `t`."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        op(host)
        t.copy_(host)
    else:
        op(t)
    return t


def all_reduce_grads(params: Iterable[torch.Tensor], mesh: Mesh | None):
    """The mean over the mesh's ranks of every parameter's `.grad`, written
    back to `.grad`: one sum over the group per dtype, on a flat bucket of
    that dtype's gradients (a None gradient counts as zeros), then a
    division by the group's size. The identity without a group."""
    if mesh is None or mesh.group is None:
        return
    params = list(params)
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([(torch.zeros_like(p) if p.grad is None
                           else p.grad).reshape(-1) for p in ps])
        _staged(flat, mesh.group,
                lambda b: dist.all_reduce(b, dist.ReduceOp.SUM, mesh.group))
        flat.div_(mesh.size)
        offset = 0
        for p in ps:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n


def reduce_metrics(metrics: dict, mesh: Mesh | None) -> dict:
    """A step's scalar metrics averaged over the mesh's ranks in one
    all-reduce (as float32 on the rank's device); the metrics as they are
    without a group."""
    if mesh is None or mesh.group is None or not metrics:
        return metrics
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                        device=mesh.device).reshape(())
                        for k in keys])
    return dict(zip(keys, mean_over_ranks(vals, mesh).unbind()))


def any_rank(flag: bool, mesh: Mesh | None) -> bool:
    """`flag` or'ed over the mesh's ranks (the maximum of 0/1)."""
    if mesh is None or mesh.group is None:
        return bool(flag)
    t = torch.tensor([float(flag)], device=mesh.device)
    _staged(t, mesh.group,
            lambda b: dist.all_reduce(b, dist.ReduceOp.MAX, mesh.group))
    return bool(t.item() > 0)


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0],) + x.shape[1:],
                      dtype=x.dtype, device=x.device)
    if x.is_cuda and dist.get_backend(mesh.group) == "gloo":
        host = torch.empty(out.shape, dtype=x.dtype, pin_memory=True)
        src = x.cpu()
        dist.all_gather(list(host.chunk(mesh.size)), src, group=mesh.group)
        out.copy_(host)
    else:
        dist.all_gather(list(out.chunk(mesh.size)), x, group=mesh.group)
    return out


class _AllGatherRows(torch.autograd.Function):
    """All-gather on the rows; its backward sums the gradient over the
    ranks and keeps this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        _staged(g, mesh.group,
                lambda b: dist.all_reduce(b, dist.ReduceOp.SUM, mesh.group))
        return rank_rows(g, mesh), None


def all_gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Every rank's `x` stacked on the leading axis in rank order: the
    global batch of a tensor of which each rank holds its rows. `x` itself
    without a group. Differentiable: the gradient of a rank's rows is the
    sum over the ranks of the gradients that reach them."""
    if mesh is None or mesh.group is None:
        return x
    return _AllGatherRows.apply(x, mesh)


def draw_rows(draw, nb: int, mesh: Mesh | None, chunk: int = 0):
    """A random draw for the global batch, and this rank's rows of it:
    `draw(k)` makes k rows; it is called for the n·nb rows of the global
    batch (n the data size, nb the rank's rows) in chunks of `chunk` rows
    in order (at once where 0), and the rank keeps rows [r·nb, (r+1)·nb).
    A generator in the same state on every rank so gives every rank its
    share of the one-process draw."""
    total = nb * data_size(mesh)
    step = chunk or total
    parts = [draw(min(step, total - i)) for i in range(0, total, step)]
    x = parts[0] if len(parts) == 1 else torch.cat(parts)
    return rank_rows(x, mesh)


@torch.no_grad()
def mean_over_ranks(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The mean of `x` over the mesh's ranks, without a gradient (`x`
    without a group)."""
    if mesh is None or mesh.group is None:
        return x
    out = x.detach().clone().contiguous()
    _staged(out, mesh.group,
            lambda b: dist.all_reduce(b, dist.ReduceOp.SUM, mesh.group))
    return out / mesh.size
