"""The traced sub-window: `torch.profiler` over whole chunks or steps, and
its reduction to device intervals, kernel times by name, time inside
named host ranges, the device's busy time (the union of its intervals)
and the idle gaps, each named by the host operation running during it.

The kernel-name categories are those of the program's
`cli/profile_train.py` (copied: the benchmark reads the program's kernel
names, not its code).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

WINDOW_RANGE = "port_bench window"

CATEGORIES = (
    ("convlstm", ("convlstm_echo", "gates_mma", "gates_wg", "dinp_mma",
                  "dk_mma", "sum_slots")),
    ("ideal", ("cycle_kernel", "synth_kernel", "mag_ls_kernel",
               "fit_kernel")),
    ("copies", ("memcpy", "memset")),
    ("convolutions", ("conv", "cudnn", "xmma", "implicit", "winograd",
                      "dgrad", "wgrad", "fprop")),
    ("matmuls", ("gemm", "matmul")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


@dataclass
class Trace:
    """Device intervals (name, start_us, end_us) inside the window, the
    window (start_us, end_us), host ops (name, start_us, end_us), the
    device-side spans of named ranges {name: [(start, end)]}, and the
    number of units (chunks or steps) the window ran."""
    kernels: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    host_ops: list = field(default_factory=list)
    ranges: dict = field(default_factory=dict)
    units: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self):
        out = []
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def seconds_by(self, cat: str) -> float:
        """Device seconds of the kernels of category `cat`."""
        return sum(b - a for n, a, b in self.kernels
                   if category(n) == cat) / 1e6

    def seconds_in_range(self, name: str) -> float:
        """Device seconds of the kernels that start inside the device-side
        span of the host range `name`."""
        spans = self.ranges.get(name, [])
        return sum(b - a for _, a, b in self.kernels
                   if any(s <= a < e for s, e in spans)) / 1e6

    def top_ops(self, k: int = 10):
        tot = {}
        for n, a, b in self.kernels:
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
        return sorted(([n[:120], s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The `k` longest gaps between device intervals inside the window
        (its edges included), each named by the innermost host operation
        running at the gap's midpoint, or else, as "after <op>", by the
        last one that ended before it (the host then runs Python between
        operations the profiler records)."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] \
            + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        ops = [(n, s, e) for n, s, e in self.host_ops if n != WINDOW_RANGE]
        out = []
        for a, b in gaps[:k]:
            mid = 0.5 * (a + b)
            inner = [(e - s, n) for n, s, e in ops if s <= mid <= e]
            if inner:
                name = min(inner)[1]
            else:
                before = [(e, n) for n, s, e in ops if e <= mid]
                name = f"after {max(before)[1]}" if before else "host idle"
            out.append([name[:120], (b - a) / 1e6])
        return out


@contextlib.contextmanager
def profiled(device, ranges=()):
    """Profile the body on `device`'s card; yields a `Trace` filled when
    the body ends (the body sets `units`). The window is the host range
    `WINDOW_RANGE` around the body, which synchronizes at both ends; the
    device-side spans of the host ranges named in `ranges` are kept."""
    from torch.autograd import DeviceType
    acts = [torch.profiler.ProfilerActivity.CPU]
    card = torch.device(device).type == "cuda"
    if card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    tr = Trace(ranges={name: [] for name in ranges})
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_RANGE):
            yield tr
            if card:
                torch.cuda.synchronize(device)
    events = prof.events()
    win = next(ev for ev in events if ev.name == WINDOW_RANGE
               and ev.device_type != DeviceType.CUDA)
    tr.window = (win.time_range.start, win.time_range.end)
    # the host's profiler ranges ("adam step", the program's own ranges):
    # their device-side spans are no kernels
    ranges = {ev.name for ev in events if ev.device_type != DeviceType.CUDA
              and getattr(ev, "is_user_annotation", False)}
    ranges |= {WINDOW_RANGE}
    for ev in events:
        r = ev.time_range
        if ev.device_type == DeviceType.CUDA:
            if r.start >= tr.window[1] or r.end <= tr.window[0]:
                continue
            if ev.name in tr.ranges:
                tr.ranges[ev.name].append((r.start, r.end))
            elif ev.name not in ranges and not getattr(
                    ev, "is_user_annotation", False):
                tr.kernels.append((ev.name, max(r.start, tr.window[0]),
                                   min(r.end, tr.window[1])))
        else:
            tr.host_ops.append((ev.name, r.start, r.end))

