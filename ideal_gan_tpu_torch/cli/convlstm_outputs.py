"""The ConvLSTM kernels' outputs on fixed inputs, to hold two builds of
their sources bit for bit (on a card).

    python ideal_gan_tpu_torch/cli/convlstm_outputs.py --out new.pt
    PYTHONPATH=<other checkout> \\
        python ideal_gan_tpu_torch/cli/convlstm_outputs.py --out old.pt
    python ideal_gan_tpu_torch/cli/convlstm_outputs.py --compare new.pt old.pt \
        [--dtype float32]
    python ideal_gan_tpu_torch/cli/convlstm_outputs.py --sass \\
        ideal_gan_tpu_torch/_build <other checkout>/ideal_gan_tpu_torch/_build

Run as a file, the script imports the `ideal_gan_tpu_torch` that PYTHONPATH
names first, so one copy of it drives another checkout's kernels (built from
that checkout's `csrc/`). `--out` runs the forward (h) and the backward (dx,
dk, db) on seeded inputs at nb=2, 384², 6 echoes, Cin 2 and 1, F=36 and 72,
in float32 and, where that checkout has the bf16 storage mode, in
bfloat16, and saves them. `--compare` prints one JSON line: for every
output both files hold (with `--dtype`, of that dtype only), whether the
two are bit-identical, and fails unless all are. `--sass` compares the float32 kernels' SASS in two build
directories (`cuobjdump -sass`, instruction text without addresses and
encodings) and prints, per kernel, whether it is the same and how many
instructions each has.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = ((2, 36), (1, 36), (2, 72), (1, 72))  # (Cin, F)
NB, NE, SIZE = 2, 6, 384


def _inputs(cin: int, f: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(NB, NE, SIZE, SIZE, cin)) * 0.5
    k = rng.normal(size=(3, 3, cin + f, 4 * f)) * (2.0 / (9 * (cin + f))) ** 0.5
    b = rng.normal(size=(4 * f,)) * 0.1
    g = rng.normal(size=(NB, SIZE, SIZE, f))
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, k, b, g)]


def outputs(dev) -> dict:
    """{"<dtype> cin<C> F<F> <name>": CPU tensor} for every case."""
    from ideal_gan_tpu_torch import ops
    dtypes = [torch.float32]
    if hasattr(ops, "CONVLSTM_BF16_KERNEL"):
        dtypes.append(torch.bfloat16)
    out = {}
    for cin, f in SHAPES:
        for dtype in dtypes:
            x, k, b, g = (t.to(dev).to(dtype)
                          for t in _inputs(cin, f, 10 * cin + f))
            key = f"{str(dtype).split('.')[-1]} cin{cin} F{f}"
            out[f"{key} h"] = ops.convlstm_forward(x, k, b).cpu()
            for name, t in zip(("dx", "dk", "db"),
                               ops.convlstm_backward(x, k, b, g)):
                out[f"{key} {name}"] = t.cpu()
    return out


def compare(a: dict, b: dict) -> dict:
    shared = sorted(set(a) & set(b))
    return {k: torch.equal(a[k], b[k]) for k in shared}


# the float32 kernels (the bf16 storage mode's names end in _bf16)
F32_KERNELS = {"convlstm_fwd": ("convlstm_echo_mma",),
               "convlstm_bwd": ("gates_mma", "dinp_mma", "dk_mma",
                                "sum_slots")}


def sass(build_dir: Path) -> dict:
    """{kernel: [instruction text]} of the float32 ConvLSTM kernels in a
    build directory's newest libraries."""
    out = {}
    for lib, kernels in F32_KERNELS.items():
        path = max(Path(build_dir).glob(f"lib{lib}.*.so"),
                   key=lambda p: p.stat().st_mtime)
        text = subprocess.run(["cuobjdump", "-sass", str(path)], check=True,
                              capture_output=True, text=True).stdout
        func = None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                func = next((k for k in kernels if k in name
                             and "bf16" not in name), None)
                if func:
                    out[func] = []
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if func and m:
                out[func].append(m.group(1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="save the outputs of this run here")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"),
                   help="two saved runs to hold bit for bit")
    p.add_argument("--dtype", help="with --compare: only the outputs of this "
                                   "dtype (float32 or bfloat16)")
    p.add_argument("--sass", nargs=2, metavar=("DIR_A", "DIR_B"),
                   help="two build directories whose float32 kernels' SASS "
                        "to compare")
    args = p.parse_args(argv)
    if args.sass:
        a, b = (sass(Path(d)) for d in args.sass)
        same = {k: dict(same=a.get(k) == b.get(k),
                        instructions=[len(a.get(k, [])), len(b.get(k, []))])
                for k in sorted(set(a) | set(b))}
        print(json.dumps({"dirs": args.sass, "sass": same}))
        return 0
    if args.compare:
        a, b = (torch.load(f) for f in args.compare)
        same = {k: v for k, v in compare(a, b).items()
                if args.dtype is None or k.startswith(args.dtype + " ")}
        print(json.dumps({"files": args.compare, "outputs": len(same),
                          "bit_identical": same}))
        return 0 if same and all(same.values()) else 1
    if not args.out or not torch.cuda.is_available():
        p.error("--out needs a CUDA device")
    torch.save(outputs(torch.device("cuda", 0)), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
