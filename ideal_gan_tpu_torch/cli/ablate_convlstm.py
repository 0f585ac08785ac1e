"""Ablation builds of the ConvLSTM forward kernel on the card: what holds it.

    python -m ideal_gan_tpu_torch.cli.ablate_convlstm [--data_size 384]
        [--batch_size 8] [--iters 5]

Builds `csrc/convlstm_fwd.cu` as it is ("base") and in variants that each
remove one part of its work (a source edit, so the variant computes wrong
values), then times `ops.convlstm_forward` at Cin=2, F=36 and Cin=2, F=72
(ne=6) with every variant's library in turn, in the order base .. last,
last .. base (CUDA events, TF32 off). Prints one JSON line: the card's name
and power limit, each variant's ptxas register and spill report, and per
shape each variant's two times and its max |difference| from base. A
variant whose source text is no longer in the kernel is not built; it is
listed under "stale". The variants:

- one_product: hi·hi alone, not the three products of 3xTF32;
- no_split: the operands passed to the tensor core unsplit (no cvt to TF32,
  no hi/lo), still three products;
- one_product_no_split: both;
- no_round: every k8 step summed on the tensor core into the accumulators,
  not from zero and then rounded into FP32 registers;
- no_epilogue: the cell update computed but not stored;
- no_staging: the shared-memory stages never loaded;
- three_blocks: `__launch_bounds__` asking for three blocks an SM.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from .. import ops
from ..ops import _build
from .common import parse_flags, resolve_device

_PRODUCTS = """#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_zero(d[mi][q], fa[mi].lo, fb[q].hi);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) mma(d[mi][q], fa[mi].hi, fb[q].lo);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q) mma(d[mi][q], fa[mi].hi, fb[q].hi);"""
_ONE_PRODUCT = """#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mma_zero(d[mi][q], fa[mi].hi, fb[q].hi);"""
_ROUND = """#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][jj][q][r] += d[mi][q][r];"""
_SPLIT = """    hi[i] = to_tf32(v);
    lo[i] = to_tf32(v - __uint_as_float(hi[i]));"""
_NO_SPLIT = """    hi[i] = __float_as_uint(v);
    lo[i] = hi[i];"""
_STORE = """          store_f(ea.h_next, o, go * leaky_relu(cn));
          if (ea.c_next) store_f(ea.c_next, o, cn);"""
_LOAD = "        gates_load(a, buf, 8 * s, ceff, b, ty0, tx0, j0);"
_BOUNDS = "__launch_bounds__(kWarps * 32, 2)"

# name: (edits of convlstm_tile.cuh, edits of convlstm_fwd.cu)
VARIANTS = {
    "base": ((), ()),
    "one_product": (((_PRODUCTS, _ONE_PRODUCT),), ()),
    "no_split": (((_SPLIT, _NO_SPLIT),), ()),
    "one_product_no_split": (((_PRODUCTS, _ONE_PRODUCT),
                              (_SPLIT, _NO_SPLIT)), ()),
    "no_round": (((_PRODUCTS, _PRODUCTS.replace("d[mi][q]", "acc[mi][jj][q]")
                   .replace("mma_zero(", "mma(")), (_ROUND, "")), ()),
    "no_epilogue": ((), ((_STORE, "          if (cn == 1234.5f) "
                                  "ea.h_next[o] = go;"),)),
    "no_staging": (((_LOAD, "        if (s < 0) " + _LOAD.strip()
                     + "\n        __pipeline_commit();"),), ()),
    "three_blocks": ((), ((_BOUNDS, _BOUNDS.replace("2)", "3)")),)),
}


def _edit(text: str, edits):
    """(text with the edits made, or None if the text of one of them is no
    longer in the source)."""
    for old, new in edits:
        if old not in text:
            return None
        text = text.replace(old, new)
    return text


def build_variants(names) -> tuple[dict, list]:
    """({name: (ctypes library, ptxas report lines)}, the names whose edits
    no longer apply to the sources), built in parallel into
    `_build/ablate/<name>/`."""
    tile = (_build.CSRC / "convlstm_tile.cuh").read_text()
    fwd = (_build.CSRC / "convlstm_fwd.cu").read_text()
    procs, stale = {}, []
    for name in names:
        tile_edits, fwd_edits = VARIANTS[name]
        sources = _edit(tile, tile_edits), _edit(fwd, fwd_edits)
        if None in sources:
            stale.append(name)
            continue
        d = _build.BUILD_DIR / "ablate" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "convlstm_tile.cuh").write_text(sources[0])
        (d / "convlstm_fwd.cu").write_text(sources[1])
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "convlstm_fwd.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for sym, (res, args) in ops.CONVLSTM_KERNEL._signatures.items():
            getattr(lib, sym).restype = res
            getattr(lib, sym).argtypes = args
        built[name] = (lib, [ln.strip() for ln in out.splitlines()
                             if "registers" in ln or "spill" in ln])
    return built, stale


def _time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    cfg = parse_flags(dict(data_size=384, batch_size=8, iters=5, seed=0,
                           device="cuda"), argv)
    dev = resolve_device(cfg["device"])
    if dev.type != "cuda":
        raise SystemExit("ablate_convlstm measures the card: --device cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    built, stale = build_variants(list(VARIANTS))
    names = list(built)
    kernel = ops.CONVLSTM_KERNEL
    kernel.fn("convlstm_echo_fwd")  # sets up the wrapper's own library
    own = kernel._lib
    nb, size = cfg["batch_size"], cfg["data_size"]
    shapes = []
    try:
        for cin, f in ((2, 36), (2, 72)):
            gen = torch.Generator().manual_seed(cfg["seed"])
            x = (torch.randn((nb, 6, size, size, cin), generator=gen)
                 * 0.5).to(dev)
            k = (torch.randn((3, 3, cin + f, 4 * f), generator=gen)
                 * (2.0 / (9 * (cin + f))) ** 0.5).to(dev)
            b = (torch.randn((4 * f,), generator=gen) * 0.1).to(dev)

            def call():
                return ops.convlstm_forward(x, k, b)

            times = {n: [] for n in names}
            for name in names + names[::-1]:
                kernel._lib = built[name][0]
                times[name].append(_time_ms(call, cfg["iters"]))
            kernel._lib = built["base"][0]
            ref = call()
            diff = {}
            for name in names:
                kernel._lib = built[name][0]
                diff[name] = float((call() - ref).abs().max())
            shapes.append(dict(cin=cin, F=f, nb=nb, size=size, ne=6,
                               ms=times, max_abs_diff_vs_base=diff))
    finally:
        kernel._lib = own
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "stale": stale,
                      "ptxas": {n: built[n][1] for n in names},
                      "shapes": shapes}))


if __name__ == "__main__":
    main()
