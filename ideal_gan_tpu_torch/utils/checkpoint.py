"""Checkpoints with the JAX package's semantics (port of
`ideal_gan_tpu/utils/checkpoint.py`), written with `torch.save`: one file
per step, `ckpt-<step>.pt`, the newest `max_to_keep` kept, `latest_step()`
for crash-resume. Saves are synchronous: the file is written, flushed to
the disk and closed before `save` returns, so a run may exit right after
it (the preemption guard's checkpoint)."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

import torch


class Checkpoint:
    def __init__(self, directory: str | Path, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt-{step}.pt"

    def steps(self) -> list[int]:
        return sorted(int(p.stem.split("-")[1])
                      for p in self.directory.glob("ckpt-*.pt"))

    def save(self, step: int, state: Any) -> None:
        """Write `state` (tensors moved to the CPU by the caller or not)
        atomically, then drop all but the newest `max_to_keep`."""
        tmp = self._path(step).with_suffix(".tmp")
        with open(tmp, "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        tmp.replace(self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            self._path(old).unlink()

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None,
                map_location: str | torch.device = "cpu") -> Any:
        """The state saved at `step` (default the latest); raises if there
        is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)
