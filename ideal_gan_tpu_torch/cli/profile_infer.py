"""Device-time breakdown of the serving path on the card.

    python -m ideal_gan_tpu_torch.cli.profile_infer [--model_sel VET-Net]
        [--experiment_dir DIR] [--data_size 384] [--infer_batch 8]
        [--chunks 3] [--seed 0]

Runs `--chunks` chunks of `--infer_batch` synthetic slices through the same
closure `cli.infer` serves for `--model_sel` (VET-Net by default, as in
`cli.infer`; `roi_analysis._per_slice` with host→card and card→host
copies) under `torch.profiler`, after one warm-up chunk, and prints one
JSON line: the card's name and power limit, the wall time per chunk, the
device time per chunk in each kernel category (the hand-written kernels,
cuDNN convolutions, matmuls, copies, the rest) and the share of the window
the card was idle.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.autograd import DeviceType

from .common import parse_flags, resolve_device, synthetic_dataset
from .infer import DEFAULTS
from .roi_analysis import _per_slice, make_infer_run

CATEGORIES = (
    ("convlstm_fwd kernel", ("convlstm_echo",)),
    ("ideal_fit kernel", ("fit_kernel",)),
    ("copies", ("memcpy", "memset")),
    ("convolutions", ("conv", "cudnn", "xmma", "implicit", "winograd",
                      "dgrad", "fprop")),
    ("matmuls", ("gemm", "matmul")),
)


def category(name: str, categories=CATEGORIES) -> str:
    """The first of `categories` ((category, name fragments), ...) whose
    fragment occurs in a kernel's name, else "other kernels"."""
    low = name.lower()
    for cat, keys in categories:
        if any(k in low for k in keys):
            return cat
    return "other kernels"


def main(argv=None):
    cfg = parse_flags(dict(DEFAULTS, data_size=384, chunks=3, seed=0,
                           device="cuda"), argv)
    dev = resolve_device(cfg["device"])
    if dev.type != "cuda":
        raise SystemExit("profile_infer measures the card: --device cuda")
    bs, size = cfg["infer_batch"], cfg["data_size"]
    acqs, _, te = synthetic_dataset(bs, h=size, w=size, ne=cfg["n_echoes"],
                                    field=cfg["field"])
    run = make_infer_run(cfg, acqs, dev)
    _per_slice(run, acqs, te, bs, dev)
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(cfg["chunks"]):
            _per_slice(run, acqs, te, bs, dev)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_cat: dict[str, float] = {}
    per_kernel: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        cat = category(ev.name)
        per_cat[cat] = per_cat.get(cat, 0.0) + us / 1e3
        per_kernel[ev.name] = per_kernel.get(ev.name, 0.0) + us / 1e3
    n = cfg["chunks"]
    busy = sum(per_cat.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "batch": bs, "size": size, "chunks": n,
        "wall_ms_per_chunk": wall_ms / n,
        "device_ms_per_chunk": {k: v / n for k, v in sorted(per_cat.items())},
        "device_busy_ms_per_chunk": busy / n,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top_kernels_ms_per_chunk": [[k[:90], v / n] for k, v in top],
    }))


if __name__ == "__main__":
    main()
