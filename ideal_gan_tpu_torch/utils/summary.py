"""Dict-based TensorBoard summaries (port of
`ideal_gan_tpu/utils/summary.py`): per-tensor mean/std/max/min/sparsity
scalars and histograms, with the JAX package's tags.

The JAX package writes through tensorboardX; the port writes the same
`Event` protocol buffers through TensorBoard's own protos and record writer
(the `tensorboard` package, imported where a writer opens or a file is
read; `torch.utils.tensorboard` is not used, since it imports TensorFlow
wherever that is installed). Histograms take tensorboardX's default bins
(±1e-12·1.1^k and 0). `read_events` reads a file back through
TensorBoard's record reader, which checks the CRCs.
"""

from __future__ import annotations

import itertools
import os
import re
import socket
import time
from pathlib import Path
from typing import Mapping

import numpy as np

_FILE_IDS = itertools.count()

# tensorboardX's tag rule and default histogram bins

_INVALID_TAG_CHARACTERS = re.compile(r"[^-/\w\.]")


def clean_tag(name: str) -> str:
    return _INVALID_TAG_CHARACTERS.sub("_", name).lstrip("/")


def _default_bins() -> list:
    v, buckets = 1e-12, []
    while v < 1e20:
        buckets.append(v)
        v *= 1.1
    return [-b for b in buckets[::-1]] + [0] + buckets


def make_histogram(values):
    """The `HistogramProto` of `values` (as float64) at the default bins,
    trimmed to the support with one empty bucket on the left, as
    tensorboardX builds it."""
    from tensorboard.compat.proto.summary_pb2 import HistogramProto

    values = np.asarray(values, np.float64).reshape(-1)
    if values.size == 0:
        raise ValueError("the input has no element")
    counts, limits = np.histogram(values, bins=_default_bins())
    cum = np.cumsum(np.greater(counts, 0))
    start, end = np.searchsorted(cum, [0, cum[-1] - 1], side="right")
    start, end = int(start), int(end) + 1
    counts = (counts[start - 1:end] if start > 0
              else np.concatenate([[0], counts[:end]]))
    limits = limits[start:end + 1]
    return HistogramProto(min=values.min(), max=values.max(),
                          num=len(values), sum=values.sum(),
                          sum_squares=values.dot(values),
                          bucket_limit=limits.tolist(),
                          bucket=counts.tolist())


class DictSummaryWriter:
    """One event file `events.out.tfevents.<seconds>.<host>.<pid>.<n>` in
    `logdir`, starting with the file_version event. `write(data, step,
    name)`: for each key, a one-element value as the scalar `name/key`; an
    array as the scalars `name/key/<type>` of `types` (mean, std, max, min,
    sparsity) and, with `histogram`, the histogram `name/key/hist`."""

    def __init__(self, logdir: str | Path):
        from tensorboard.compat.proto import event_pb2, summary_pb2
        from tensorboard.summary.writer.record_writer import RecordWriter

        self._event, self._summary = event_pb2.Event, summary_pb2.Summary
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        self.path = logdir / (f"events.out.tfevents.{int(time.time()):010d}."
                              f"{socket.gethostname()}.{os.getpid()}."
                              f"{next(_FILE_IDS):04d}")
        self._file = open(self.path, "wb")
        self._records = RecordWriter(self._file)
        self._write_event(file_version="brain.Event:2")

    def _write_event(self, **fields) -> None:
        event = self._event(wall_time=time.time(), **fields)
        self._records.write(event.SerializeToString())

    def write(self, data: Mapping[str, object], step: int, name: str = "",
              types=("mean",), histogram: bool = False) -> None:
        prefix = f"{name}/" if name else ""
        values = []
        for key, value in data.items():
            arr = np.asarray(value)
            tag = f"{prefix}{key}"
            if arr.size == 1:
                values.append(self._summary.Value(
                    tag=clean_tag(tag), simple_value=arr.item()))
                continue
            stats = {"mean": np.mean(arr), "std": np.std(arr),
                     "max": np.max(arr), "min": np.min(arr),
                     "sparsity": np.mean(arr == 0.0)}
            for t in types:
                values.append(self._summary.Value(
                    tag=clean_tag(f"{tag}/{t}"), simple_value=stats[t]))
            if histogram:
                values.append(self._summary.Value(
                    tag=clean_tag(f"{tag}/hist"), histo=make_histogram(arr)))
        if values:
            self._write_event(step=int(step),
                              summary=self._summary(value=values))

    def flush(self) -> None:
        self._file.flush()
        os.fsync(self._file.fileno())

    def close(self) -> None:
        if not self._file.closed:
            self.flush()
            self._file.close()


def read_events(path: str | Path) -> list:
    """[(step, tag, value)] of an event file, in order: a float for a
    simple value, a `HistogramProto` for a histogram. A corrupted record
    raises (`DataLossError`)."""
    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.tensorflow_stub import errors
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
        PyRecordReader_New)

    reader, out = PyRecordReader_New(str(path)), []
    while True:
        try:
            reader.GetNext()
        except errors.OutOfRangeError:
            return out
        event = Event.FromString(reader.record())
        for v in event.summary.value:
            kind = v.WhichOneof("value")
            out.append((event.step, v.tag, v.histo if kind == "histo"
                        else v.simple_value))


def read_scalars(logdir: str | Path) -> dict:
    """{tag: [(step, value)]} of the simple values in every event file of
    `logdir`, files in name order."""
    out: dict = {}
    for path in sorted(Path(logdir).glob("events.out.tfevents.*")):
        for step, tag, val in read_events(path):
            if isinstance(val, float):
                out.setdefault(tag, []).append((step, val))
    return out
