"""One run of one cell: find its configuration, traffic mix, family,
traffic kind and metrics by the names in `BENCHMARK.json`, set up, measure the
window, read the metrics, check the outputs, and build the result line.

Everything a cell is made of sits in files of its own under this folder,
found by name: `configs/<config>.json` (its `family` names
`families/<family>.py`), `traffic/<mix>.json` (its `kind` names
`kinds/<kind>.py`) and `metrics/<metric>.py` (a `read(ctx)` returning a
number, or None where it finds nothing to read).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")
FORBIDDEN = ("jax", "jaxlib", "flax", "ideal_gan_tpu")


def check_name(name: str) -> str:
    if not (0 < len(name) <= 64 and set(name) <= NAME_CHARS
            and name[0] not in ".-"):
        raise ValueError(f"bad name {name!r}")
    return name


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in FORBIDDEN)


class Bench:
    """`BENCHMARK.json` and the files it names, under `root`."""

    def __init__(self, root: Path, spec: dict | None = None):
        self.root = Path(root)
        self.dir = self.root / "port_bench"
        self.spec = spec if spec is not None else json.loads(
            (self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.spec["configs"]
                     if c["name"] == check_name(name))
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.dir / "traffic" / f"{check_name(name)}.json").read_text())

    def family(self, name: str):
        return importlib.import_module(
            f"port_bench.families.{check_name(name)}")

    def traffic_kind(self, kind: str):
        return importlib.import_module(f"port_bench.kinds.{check_name(kind)}")

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{check_name(metric)}.py"
        spec = importlib.util.spec_from_file_location(
            "port_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def metrics_for(self, cell: str, section: str) -> list:
        """The metrics of `section` ("end_to_end" or "per_layer") that
        `cell` reports."""
        return [m for m in self.spec[section]
                if cell in m.get("workloads", [cell])]


@dataclass
class Env:
    """What a traffic kind's module is given: the device, the run's
    seeds, the cell's configuration, traffic and family, and the faults a
    test plants."""
    device: torch.device
    seed: int
    cfg: dict
    traffic: dict
    family: object
    faults: frozenset = frozenset()
    log: object = None
    t0: float = field(default_factory=time.perf_counter)
    seeds: dict = field(default_factory=dict)

    def __post_init__(self):
        names = ("weights", "inputs", "order", "feed_np", "feed_torch",
                 "noise")
        state = np.random.SeedSequence(int(self.seed)).generate_state(
            len(names))
        self.seeds = {n: int(s) for n, s in zip(names, state)}
        if self.log is None:
            self.log = lambda *a: print(*a, file=sys.stderr, flush=True)

    def stage(self, what: str) -> None:
        """Log the run's seconds so far at the end of a set-up stage."""
        self.log(f"{time.perf_counter() - self.t0:9.3f} s  {what}")


@dataclass
class Context:
    """What a metric's reader reads."""
    kind: str
    cfg: dict
    window: dict
    setup_s: float
    trace: object = None
    calls: tuple = ((), ())
    flops_per_unit: float | None = None


def device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def count_flops(env, train: bool) -> float:
    """FLOPs of one unit (a chunk or a step) of the reference, counted by
    `torch.utils.flop_counter` on the meta device at the cell's shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        nets = env.family.reference_nets(env.cfg)
    counter = FlopCounterMode(display=False)
    with counter:
        env.family.count_unit(env.cfg, nets, torch.device("meta"), train)
    return float(counter.get_total_flops())


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float | None = None, faults=(),
             cfg_overrides=None, traffic_overrides=None, spec=None) -> dict:
    """One run; returns the result line's object, its compared numbers
    under "checks", last."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = Bench(root, spec)
    cell = bench.workload(workload)
    cfg = dict(bench.config(cell["config"]), **(cfg_overrides or {}))
    traffic = dict(bench.traffic(cell["traffic"]), **(traffic_overrides or {}))
    env = Env(torch.device(device), seed, cfg, traffic,
              bench.family(cfg["family"]), frozenset(faults), t0=t_start)
    kind = bench.traffic_kind(traffic["kind"])
    # the configuration's stated precision of cuDNN's convolutions
    torch.backends.cudnn.allow_tf32 = bool(cfg["cudnn_tf32"])
    env.stage("imports and the card")
    if env.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(env.device)
    state = kind.setup(env)
    setup_s = time.perf_counter() - t_start
    env.log(f"set-up {setup_s:.3f} s")
    window = kind.window(state, seconds)
    ctx = Context(traffic["kind"], cfg, window, setup_s)
    if trace:
        ctx.trace = kind.traced(state)
        ctx.calls = kind.calls(state)
        ctx.flops_per_unit = count_flops(env, kind.TRAINS)
    dev_info = device_info(env.device)
    if trace:
        dev_info.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
    checks = kind.check(state)
    correct = all(v <= lim for _, v, lim in checks) and window["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_for(workload, section):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result
