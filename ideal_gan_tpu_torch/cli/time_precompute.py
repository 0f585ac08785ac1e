"""Time the per-voxel kernels' per-row operand builds of one checkout on
the card, to compare builds.

    python ideal_gan_tpu_torch/cli/time_precompute.py --tag new
    PYTHONPATH=<other checkout> \\
        python ideal_gan_tpu_torch/cli/time_precompute.py --tag old

Run as a file, the script imports the `ideal_gan_tpu_torch` that PYTHONPATH
names first, as `cli/time_convlstm.py` does; run it for two checkouts in
turns (a, b, b, a) in one call to compare them. For a TE train of `--nb`
rows and 6 echoes it prints one JSON line: the card's name and power
limit, and the host ms per call of each of `ops.precompute_fit_matrices`,
`precompute_cycle_matrices`, `precompute_synth_matrices` and
`precompute_mag_matrices` (the median of `--reps` runs of `--iters` calls,
each run ending in a synchronisation). Every fused physics call that is
given no precomputed operands pays its build once.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def host_ms(fn, iters: int) -> float:
    """Host ms per call over `iters` calls ending in a synchronisation,
    after warm-up calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tag", default="")
    p.add_argument("--nb", type=int, default=8)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    from ideal_gan_tpu_torch import ops, physics
    from ideal_gan_tpu_torch.ops import ideal

    dev = torch.device("cuda", 0)
    te = physics.te_train(6, args.nb, device=dev)
    builds = {"fit": ops.precompute_fit_matrices,
              "cycle": ideal.precompute_cycle_matrices,
              "synth": ideal.precompute_synth_matrices,
              "mag": ops.precompute_mag_matrices}
    out = {"tag": args.tag, "nb": args.nb, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    for name, build in builds.items():
        out[f"{name}_ms"] = statistics.median(
            host_ms(lambda: build(te), args.iters) for _ in range(args.reps))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
