"""Generated-dataset shards (a copy of the pure-numpy
`ideal_gan_tpu/data/records.py`, so that the port imports nothing of the
JAX package).

The reference serializes LDM-generated training pairs as one TFRecord of
(acqs, out_maps) features (gen_LDM_dataset.py:214-255, data.py:332-346)
and train-sup/--DL_gen re-reads them with optional partial-real mixing
(train-sup.py:101-164). Here shards are compressed npz files — a
self-describing, dependency-free container with the same roles.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Sequence

import numpy as np


def write_shard(path: str, acqs: np.ndarray, out_maps: np.ndarray,
                **extra) -> str:
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, acqs=np.asarray(acqs, np.float32),
                        out_maps=np.asarray(out_maps, np.float32), **extra)
    return path


def list_shards(directory: str, prefix: str = "") -> list[str]:
    return sorted(str(p) for p in Path(directory).glob(f"{prefix}*.npz"))


def read_shards(paths: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    acqs, maps = [], []
    for p in paths:
        with np.load(p) as data:
            acqs.append(data["acqs"])
            maps.append(data["out_maps"])
    return np.concatenate(acqs), np.concatenate(maps)


def iter_shards(paths: Sequence[str]) -> Iterator[tuple]:
    for p in paths:
        with np.load(p) as data:
            for i in range(len(data["acqs"])):
                yield data["acqs"][i], data["out_maps"][i]


def mix_partial_real(gen_acqs: np.ndarray, gen_maps: np.ndarray,
                     real_acqs: np.ndarray, real_maps: np.ndarray,
                     n_real: int):
    """DL_partial_real mixing (train-sup.py:151-164): prepend n_real real
    slices to the generated corpus."""
    if n_real <= 0:
        return gen_acqs, gen_maps
    return (np.concatenate([real_acqs[:n_real], gen_acqs]),
            np.concatenate([real_maps[:n_real], gen_maps]))
