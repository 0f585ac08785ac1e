"""Ablation builds of the ConvLSTM forward kernel on the card: what holds it.

    python -m ideal_gan_tpu_torch.cli.ablate_convlstm [--data_size 384]
        [--batch_size 8] [--iters 5]

Builds `csrc/convlstm_fwd.cu` as it is ("base") and in variants that each
remove one part of its work (a source edit, so the variant computes wrong
values), then times `ops.convlstm_forward` at Cin=2, F=36 and Cin=2, F=72
(ne=6) with every variant's library in turn, in the order base .. last,
last .. base (CUDA events, TF32 off): the float32 variants on float32
inputs, the bf16 ones on bfloat16 inputs. Prints one JSON line: the card's
name and power limit, each variant's ptxas register and spill report, and
per shape and dtype each variant's two times and its max |difference| from
base. A variant whose source text is no longer in the kernel is not built;
it is listed under "stale". The float32 variants (the 3xTF32 mainloop):

- one_product: hi·hi alone, not the three products of 3xTF32;
- no_split: the operands passed to the tensor core unsplit (no cvt to TF32,
  no hi/lo), still three products;
- one_product_no_split: both;
- no_round: every k8 step summed on the tensor core into the accumulators,
  not from zero and then rounded into FP32 registers;
- no_epilogue: the cell update computed but not stored;
- no_staging: the shared-memory stages never loaded;
- three_blocks: `__launch_bounds__` asking for three blocks an SM.

The bf16 variants (the wgmma mainloop, `gate_mainloop_wg`):

- bf16_no_staging: no TMA box or weight copy issued (each stage's barrier
  completes at once on whatever the ring holds);
- bf16_no_mma: no wgmma issued (the fragments are still loaded);
- bf16_no_epilogue: the cell computed, nothing stored;
- bf16_chunks16: the base library with every K chunk 16 channels wide (Cp
  rounded up to 16: at F=36 48 channels, not 32 + an 8-channel chunk), a
  plan and not a source edit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from .. import ops
from ..ops import _build
from ..ops import convlstm as cl
from .common import parse_flags, resolve_device
from .time_convlstm import event_ms

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
_STORE = """          store_f(ea.h_next, o, c.o * leaky_relu(c.c));
          if (ea.c_next) store_f(ea.c_next, o, c.c);"""
_LOAD = "        gates_load(a, buf, 8 * s, ceff, b, ty0, tx0, j0);"
_BOUNDS = "__launch_bounds__(kWarps * 32, 2)"
_COPIES = """    mbar_expect_tx(bar, boxes * kBox + wbytes);
    for (int h = 0; h < boxes; ++h)
      tma_box(st + h * kBoxPad, &a.in, 16 * s + 8 * h, tx0 - 1, ty0 - 1, b,
              bar);
    bulk_copy(st + kPatch, w + (long long)s * 9 * 512 * NG, wbytes, bar);"""
_WGMMA = "    wgmma_rs(acc, fa[s], desc + ((s * 1024 * NG) >> 4));"
_H_STORE = "        uint16_t* hp = ea.h_next + pix * ea.h_stride + f0;"

# name: (edits of convlstm_tile.cuh, edits of convlstm_fwd.cu)
VARIANTS = {
    "base": ((), ()),
    "one_product": (((_PRODUCTS, _ONE_PRODUCT),), ()),
    "no_split": (((_SPLIT, _NO_SPLIT),), ()),
    "one_product_no_split": (((_PRODUCTS, _ONE_PRODUCT),
                              (_SPLIT, _NO_SPLIT)), ()),
    "no_round": (((_PRODUCTS, _PRODUCTS.replace("d[mi][q]", "acc[mi][jj][q]")
                   .replace("mma_zero(", "mma(")), (_ROUND, "")), ()),
    "no_epilogue": ((), ((_STORE, "          if (c.c == 1234.5f) "
                                  "ea.h_next[o] = c.o;"),)),
    "no_staging": (((_LOAD, "        if (s < 0) " + _LOAD.strip()
                     + "\n        __pipeline_commit();"),), ()),
    "three_blocks": ((), ((_BOUNDS, _BOUNDS.replace("2)", "3)")),)),
}
# the bf16 variants, timed on bf16 inputs against the same base
BF16_VARIANTS = {
    "bf16_no_staging": (((_COPIES, "    mbar_expect_tx(bar, 0 * (boxes + "
                                  "wbytes));"),), ()),
    "bf16_no_mma": (((_WGMMA, "    if (fa[s][0] == 0x7fc00001u) acc[0] += "
                              "1.f;"),), ()),
    "bf16_no_epilogue": ((), ((_H_STORE, "        if (hv[0] == 1234.5f) "
                                         "ea.h_next[0] = 0;\n        continue;"
                                         "\n" + _H_STORE),)),
}
# a plan variant of the base library: every K chunk 16 channels
PLAN_VARIANTS = ("bf16_chunks16",)


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
        tile_edits, fwd_edits = {**VARIANTS, **BF16_VARIANTS}[name]
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
        for kern in (ops.CONVLSTM_KERNEL, ops.CONVLSTM_BF16_KERNEL):
            for sym, (res, args) in kern._signatures.items():
                getattr(lib, sym).restype = res
                getattr(lib, sym).argtypes = args
        built[name] = (lib, [ln.strip() for ln in out.splitlines()
                             if "registers" in ln or "spill" in ln])
    return built, stale


def _chunks16(plan):
    """`plan` (ops.convlstm._bf16_plan) with Cp rounded up to 16."""
    def chunks16(cin, f):
        cp, gpb, cpb = plan(cin, f)
        return -(-cp // 16) * 16, gpb, cpb
    return chunks16


def main(argv=None):
    cfg = parse_flags(dict(data_size=384, batch_size=8, iters=5, seed=0,
                           device="cuda"), argv)
    dev = resolve_device(cfg["device"])
    if dev.type != "cuda":
        raise SystemExit("ablate_convlstm measures the card: --device cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    built, stale = build_variants(list(VARIANTS) + list(BF16_VARIANTS))
    kernels = (ops.CONVLSTM_KERNEL, ops.CONVLSTM_BF16_KERNEL)
    kernels[0].fn("convlstm_echo_fwd")  # set up the wrappers' own library
    kernels[1].fn("convlstm_echo_fwd_bf16")
    own = kernels[0]._lib
    plan = cl._bf16_plan
    nb, size = cfg["batch_size"], cfg["data_size"]
    shapes = []

    def use(name):
        """Point both wrappers at a variant's library (a plan variant: the
        base library with its plan)."""
        lib = built["base" if name in PLAN_VARIANTS else name][0]
        for kern in kernels:
            kern._lib = lib
        cl._bf16_plan = _chunks16(plan) if name in PLAN_VARIANTS else plan

    try:
        for cin, f in ((2, 36), (2, 72)):
            gen = torch.Generator().manual_seed(cfg["seed"])
            x = (torch.randn((nb, 6, size, size, cin), generator=gen)
                 * 0.5).to(dev)
            k = (torch.randn((3, 3, cin + f, 4 * f), generator=gen)
                 * (2.0 / (9 * (cin + f))) ** 0.5).to(dev)
            b = (torch.randn((4 * f,), generator=gen) * 0.1).to(dev)
            for dtype, variants in (
                    (torch.float32, [n for n in VARIANTS if n in built]),
                    (torch.bfloat16, ["base"] + [n for n in BF16_VARIANTS
                                                 if n in built]
                     + list(PLAN_VARIANTS))):
                xd, kd, bd = (t.to(dtype) for t in (x, k, b))

                def call():
                    return ops.convlstm_forward(xd, kd, bd)

                times = {n: [] for n in variants}
                for name in variants + variants[::-1]:
                    use(name)
                    times[name].append(event_ms(call, cfg["iters"]))
                use("base")
                ref = call().float()
                diff = {}
                for name in variants:
                    use(name)
                    diff[name] = float((call().float() - ref).abs().max())
                use("base")
                shapes.append(dict(cin=cin, F=f, nb=nb, size=size, ne=6,
                                   dtype=str(dtype).split(".")[-1],
                                   ms=times, max_abs_diff_vs_base=diff))
    finally:
        for kern in kernels:
            kern._lib = own
        cl._bf16_plan = plan
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "stale": stale,
                      "ptxas": {n: built[n][1] for n in built},
                      "shapes": shapes}))


if __name__ == "__main__":
    main()
