"""The benchmark of `ideal_gan_tpu_torch` on the card: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Runs from the root of a checkout that holds `BENCHMARK.json`. Sets up the
cell (its weights and inputs made on the card from `--seed`, its shapes
warmed), measures for `--seconds`, with `--trace 1` then profiles a short
sub-window, checks the outputs against the plain reference, and prints
one JSON line last on standard output: the cell's end-to-end metrics
(`--trace 0`) or its per-layer metrics (`--trace 1`), with `correct`,
`attempted`, `failed`, `device` and, last, `checks` (each compared number
beside its limit, also printed last on standard error). Exits non-zero,
printing no result, without a card, or where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, leads the path (this folder's
# module names would shadow the standard library's)
sys.path[0] = str(ROOT)
CACHE = ROOT / ".port_bench_cache"
# every build and kernel cache at a fixed path inside the checkout, made
# here (PyTorch does not create its kernel cache's parents)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda")):
    (CACHE / sub).mkdir(parents=True, exist_ok=True)
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"  # libraries that would load Flax by themselves


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from port_bench.harness import Bench, forbidden_modules, run_cell

    chips = Bench(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"port_bench: {torch.cuda.get_device_name(dev)}, torch "
          f"{torch.__version__}, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), dev, t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
