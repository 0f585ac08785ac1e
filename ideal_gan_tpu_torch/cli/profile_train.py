"""Device-time breakdown of the AI-DEAL training step pair on the card.

    python -m ideal_gan_tpu_torch.cli.profile_train [--data_size 384]
        [--batch_size 8] [--steps 3] [--n_G_filters 36] [--seed 0]

Runs `--steps` PM-mode step pairs (the FM step, then the R2 step with g_fm
frozen, as `cli.train_unsup` runs them) on one synthetic batch under
`torch.profiler`, after one warm-up pair, and prints one JSON line: the
card's name and power limit, the wall time per step pair, the device time
per step pair in each kernel category (the four hand-written kernels, cuDNN
convolutions, matmuls, copies, the rest), the device time inside the
physics Functions' reference backward and the optimizer steps (profiler
ranges), and the share of the window the card was idle.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch
from torch.autograd import DeviceType

from ..ops.ideal import BACKWARD_RANGE
from ..train import unsup
from ..train.common import STEP_RANGE
from .common import parse_flags, resolve_device, synthetic_dataset
from .profile_infer import category

CATEGORIES = (
    ("convlstm_fwd kernel", ("convlstm_echo",)),
    ("convlstm_bwd kernels", ("gates_bwd", "dinp_kernel", "dk_kernel",
                              "reduce_kernel")),
    ("ideal_cycle kernel", ("cycle_kernel",)),
    ("copies", ("memcpy", "memset")),
    ("convolutions", ("conv", "cudnn", "xmma", "implicit", "winograd",
                      "dgrad", "wgrad", "fprop")),
    ("matmuls", ("gemm", "matmul")),
)
RANGES = (BACKWARD_RANGE, STEP_RANGE)


def main(argv=None):
    cfg = parse_flags(dict(unsup.DEFAULTS, data_size=384, steps=3, seed=0,
                           device="cuda", out_vars="PM"), argv)
    dev = resolve_device(cfg["device"])
    if dev.type != "cuda":
        raise SystemExit("profile_train measures the card: --device cuda")
    bs, size = cfg["batch_size"], cfg["data_size"]
    acqs, _, te = synthetic_dataset(bs, h=size, w=size, ne=cfg["n_echoes"],
                                    field=cfg["field"])
    batch = (torch.from_numpy(acqs).to(dev), torch.from_numpy(te).to(dev))
    g_fm, g_r2 = unsup.build_models(cfg)
    step_fn, tx = unsup.make_train_step(cfg, g_fm, g_r2)
    r2_step_fn = unsup.make_r2_train_step(cfg, g_fm, g_r2, tx)
    state = unsup.init_state(cfg, g_fm, g_r2, tx,
                             torch.Generator().manual_seed(cfg["seed"]), dev)

    def pair():
        nonlocal state
        state, _ = step_fn(state, batch)
        state, _ = r2_step_fn(state, batch)

    pair()
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(cfg["steps"]):
            pair()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, spans = [], {r: [] for r in RANGES}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tr = ev.time_range
        if ev.name in spans:  # the ranges' device-side annotations
            spans[ev.name].append((tr.start, tr.end))
        else:
            kernels.append((ev.name, tr.start, tr.elapsed_us()))
    per_cat: dict[str, float] = {}
    per_kernel: dict[str, float] = {}
    in_range = {r: 0.0 for r in RANGES}
    for name, start, us in kernels:
        cat = category(name, CATEGORIES)
        per_cat[cat] = per_cat.get(cat, 0.0) + us / 1e3
        per_kernel[name] = per_kernel.get(name, 0.0) + us / 1e3
        for r, ranges in spans.items():
            if any(a <= start < b for a, b in ranges):
                in_range[r] += us / 1e3
    n = cfg["steps"]
    busy = sum(per_cat.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "batch": bs, "size": size, "F": cfg["n_G_filters"],
        "step_pairs": n, "wall_ms_per_step_pair": wall_ms / n,
        "slices_per_s": bs * n * 1e3 / wall_ms,
        "device_ms_per_step_pair": {k: v / n
                                    for k, v in sorted(per_cat.items())},
        "device_ms_in_ranges_per_step_pair": {k: v / n
                                              for k, v in in_range.items()},
        "device_busy_ms_per_step_pair": busy / n,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "top_kernels_ms_per_step_pair": [[k[:90], v / n] for k, v in top],
    }))


if __name__ == "__main__":
    main()
