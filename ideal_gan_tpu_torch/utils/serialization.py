"""JSON / YAML / pickle save and load with extension fixing, and a parallel
map (port of `ideal_gan_tpu/utils/serialization.py`). PyYAML is imported by
the YAML functions only."""

from __future__ import annotations

import json
import multiprocessing
import pickle
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path


def _fix_ext(path, ext: str) -> Path:
    p = Path(path)
    if p.suffix != f".{ext}":
        p = p.with_suffix(f".{ext}")
    return p


def save_json(path, obj, **kw) -> str:
    p = _fix_ext(path, "json")
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(obj, f, **kw)
    return str(p)


def load_json(path):
    with open(_fix_ext(path, "json")) as f:
        return json.load(f)


def save_yaml(path, obj, **kw) -> str:
    import yaml
    p = _fix_ext(path, "yml")
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        yaml.safe_dump(obj, f, sort_keys=False, **kw)
    return str(p)


def load_yaml(path):
    import yaml
    with open(_fix_ext(path, "yml")) as f:
        return yaml.safe_load(f)


def save_pickle(path, obj) -> str:
    p = _fix_ext(path, "pkl")
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        pickle.dump(obj, f)
    return str(p)


def load_pickle(path):
    """Unpickles `path`: only for files this program wrote."""
    with open(_fix_ext(path, "pkl"), "rb") as f:
        return pickle.load(f)


def run_parallels(fn, iterable, max_workers: int | None = None,
                  mode: str = "thread") -> list:
    """`list(map(fn, iterable))` on a thread pool, or with `mode="process"`
    a pool of spawned processes (`fn` and the items must pickle)."""
    if mode == "thread":
        pool = ThreadPoolExecutor(max_workers=max_workers)
    else:
        pool = ProcessPoolExecutor(max_workers=max_workers,
                                   mp_context=multiprocessing.get_context(
                                       "spawn"))
    with pool:
        return list(pool.map(fn, iterable))
