"""Wall-clock timer context manager and a `torch.profiler` trace scope for
`--profile_dir` (port of `ideal_gan_tpu/utils/timer.py`, whose `profile`
is a `jax.profiler` trace)."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path


class Timer:
    """Context-manager timer: `with Timer() as t: ...; t.elapsed`."""

    def __init__(self, verbose: bool = False, fmt: str = "elapsed {:.6f}s"):
        self.verbose = verbose
        self.fmt = fmt
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        if self.verbose:
            print(self.fmt.format(self.elapsed))
        return False


@contextlib.contextmanager
def profile(profile_dir: str | None):
    """A `torch.profiler` trace of the scope (CPU activity, and CUDA
    activity where a card is present) written as a Chrome trace
    `trace.json` under `profile_dir`; a no-op when `profile_dir` is
    empty."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))
