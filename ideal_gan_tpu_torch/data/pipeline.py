"""Composable host-side input pipeline (port of
`ideal_gan_tpu/data/pipeline.py`, the rebuild of tf2lib/data/dataset.py).

The reference builds tf.data pipelines as shuffle → filter → map → batch →
repeat → prefetch (tf2lib/data/dataset.py:6-129); this is the numpy
equivalent feeding the train steps, with background prefetch to overlap
host work (augmentation, HDF5 reads) with the card's compute. `shard()`
is the per-process data split of a multi-process run (`torch.distributed`).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np


class Dataset:
    """Lazy record pipeline over an indexable source (arrays or a list of
    per-example tuples)."""

    def __init__(self, source, length: int | None = None, seed: int = 0):
        self._source = source
        self._length = length if length is not None else len(source)
        self._ops: list[tuple] = []
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_arrays(cls, *arrays, seed: int = 0) -> "Dataset":
        n = len(arrays[0])
        assert all(len(a) == n for a in arrays)
        if len(arrays) == 1:
            return cls(list(arrays[0]), n, seed)
        return cls(list(zip(*arrays)), n, seed)

    @classmethod
    def from_image_files(cls, paths, labels=None, loader=None,
                         seed: int = 0) -> "Dataset":
        """Disk-image pipeline (reference disk_image_batch_dataset,
        tf2lib/data/dataset.py:81-129): items are file paths, decoded
        lazily per iteration via `loader` (default: matplotlib imread →
        float32 HWC). With `labels`, yields (image, label) tuples."""
        paths = list(paths)
        if loader is None:
            def loader(p):
                import matplotlib.pyplot as plt
                return np.asarray(plt.imread(p), dtype=np.float32)
        if labels is not None:
            assert len(labels) == len(paths)
            ds = cls(list(zip(paths, list(labels))), len(paths), seed)
            return ds.map(lambda rec: (loader(rec[0]), rec[1]))
        return cls(paths, len(paths), seed).map(loader)

    def shuffle(self) -> "Dataset":
        self._ops.append(("shuffle",))
        return self

    def shard(self, num_shards: int | None = None,
              index: int | None = None) -> "Dataset":
        """Per-process data sharding for multi-host (pod) training: keep
        every `num_shards`-th record starting at `index`. Defaults come
        from the live `torch.distributed` process group (its world size
        and rank), so a single-process run is a no-op.
        The epoch permutation is drawn from the dataset's own seeded rng,
        identical on every process, so striding the shuffled stream
        (`ds.shuffle().shard().batch(per_process)`) gives each process a
        disjoint, epoch-reshuffled partition; shard-before-shuffle is
        re-applied after the shuffle reset and is equivalent."""
        if num_shards is None or index is None:
            from ..parallel.mesh import world
            n_world, rank = world()
            num_shards = n_world if num_shards is None else num_shards
            index = rank if index is None else index
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} not in "
                             f"[0, {num_shards})")
        if num_shards > 1:
            self._ops.append(("shard", num_shards, index))
        return self

    def filter(self, pred: Callable) -> "Dataset":
        self._ops.append(("filter", pred))
        return self

    def map(self, fn: Callable) -> "Dataset":
        self._ops.append(("map", fn))
        return self

    def batch(self, batch_size: int, drop_remainder: bool = True) -> "Dataset":
        self._ops.append(("batch", batch_size, drop_remainder))
        return self

    def repeat(self, count: int | None = None) -> "Dataset":
        self._ops.append(("repeat", count))
        return self

    def prefetch(self, buffer_size: int = 2) -> "Dataset":
        self._ops.append(("prefetch", buffer_size))
        return self

    # -- execution -------------------------------------------------------
    def _build(self, ops) -> Iterator:
        """Build the record stream for a prefix of the op list (each call
        re-draws shuffles, so repeat() reshuffles every epoch)."""
        stream: Iterable = (self._source[i]
                            for i in np.arange(self._length))

        def _filter(s, pred):
            return (r for r in s if pred(r))

        def _map(s, fn):
            return (fn(r) for r in s)

        def _shard(s, n, idx):
            return (r for k, r in enumerate(s) if k % n == idx)

        shards_seen = []
        for i, op in enumerate(ops):
            if op[0] == "shard":
                shards_seen.append(op)
                stream = _shard(stream, op[1], op[2])
            elif op[0] == "shuffle":
                perm = self._rng.permutation(self._length)
                stream = (self._source[j] for j in perm)
                # shuffle resets the stream from the source; re-apply any
                # earlier shard ops so shard→shuffle never silently feeds
                # every process the full dataset (the permutation is
                # process-identical — same seeded rng — so partitions
                # stay disjoint either way)
                for sh in shards_seen:
                    stream = _shard(stream, sh[1], sh[2])
            elif op[0] == "filter":
                stream = _filter(stream, op[1])
            elif op[0] == "map":
                stream = _map(stream, op[1])
            elif op[0] == "batch":
                stream = _batched(stream, op[1], op[2])
            elif op[0] == "repeat":
                prefix = ops[:i]
                stream = _repeated(lambda: self._build(prefix), stream,
                                   op[1])
            elif op[0] == "prefetch":
                stream = _prefetched(stream, op[1])
        return iter(stream)

    def __iter__(self):
        return self._build(self._ops)


def _batched(stream, batch_size, drop_remainder):
    buf = []
    for r in stream:
        buf.append(r)
        if len(buf) == batch_size:
            yield _stack(buf)
            buf = []
    if buf and not drop_remainder:
        yield _stack(buf)


def _stack(records):
    if isinstance(records[0], tuple):
        return tuple(np.stack([r[i] for r in records])
                     for i in range(len(records[0])))
    return np.stack(records)


def _repeated(make_stream, first_stream, count):
    yield from first_stream
    n = count - 1 if count else None
    while n is None or n > 0:
        yield from make_stream()
        if n is not None:
            n -= 1


def _prefetched(stream, buffer_size):
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    sentinel = object()

    def producer():
        try:
            for item in stream:
                q.put(item)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            break
        yield item


def minmax_norm(x: np.ndarray, epsilon: float = 1e-12) -> np.ndarray:
    """Min-max normalization to [0, 1] (tf2lib/ops/ops.py:5)."""
    lo, hi = np.min(x), np.max(x)
    return (x - lo) / (hi - lo + epsilon)
