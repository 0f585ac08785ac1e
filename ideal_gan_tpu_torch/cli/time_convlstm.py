"""Time the ConvLSTM kernels of one checkout on the card, to compare builds.

    python ideal_gan_tpu_torch/cli/time_convlstm.py --tag new
    PYTHONPATH=<other checkout> \\
        python ideal_gan_tpu_torch/cli/time_convlstm.py --tag old

Run as a file, the script imports the `ideal_gan_tpu_torch` that PYTHONPATH
names first (and builds that checkout's kernels), as
`cli/convlstm_outputs.py` does; run it for two checkouts in turns (a, b, b,
a) in one call to compare them. At nb=8, 384², 6 echoes, Cin=2 and F=36,
72, in the bf16 storage mode, it prints one JSON line: the card's name
and power limit, and per F the forward's and the backward's
(no dx, as the trainers call it) CUDA-event ms per call, their device ms
per kernel family from one torch.profiler window (the forward kernel, which
is also the backward's recompute, the backward's stages, the slot sums,
PyTorch's copies and fills), and the ms of copying the forward's (nb, H, W,
F) result into the NCHW layout the nets take (`models/convlstm.py`).
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

# kernel-name fragments of the families the device split reports
FAMILIES = ("convlstm_echo", "gates_", "dinp_mma", "dk_mma", "sum_slots",
            "copy", "elementwise")


def event_ms(fn, iters: int) -> float:
    """CUDA-event ms per call of fn over iters calls, after one warm-up."""
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


def _device_split(fn) -> dict:
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            fam = next((f for f in FAMILIES if f in ev.name), "other")
            out[fam] = out.get(fam, 0.0) + ev.time_range.elapsed_us() / 1e3
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tag", default="", help="a name for this checkout")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        p.error("needs a CUDA device")
    from ideal_gan_tpu_torch import ops
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    nb, ne, size, cin = 8, 6, 384, 2
    out = {"tag": args.tag, "dtype": "bfloat16"}
    for f in (36, 72):
        gen = torch.Generator().manual_seed(f)
        x = torch.randn((nb, ne, size, size, cin), generator=gen) * 0.5
        k = torch.randn((3, 3, cin + f, 4 * f), generator=gen) \
            * (2.0 / (9 * (cin + f))) ** 0.5
        b = torch.randn((4 * f,), generator=gen) * 0.1
        g = torch.randn((nb, size, size, f), generator=gen)
        x, k, b, g = (t.to(dev).to(torch.bfloat16) for t in (x, k, b, g))

        def fwd():
            return ops.convlstm_forward(x, k, b)

        def bwd():
            return ops.convlstm_backward(x, k, b, g, need_dx=False)

        h = fwd()
        out[f"F{f}"] = dict(
            fwd_ms=event_ms(fwd, 10), bwd_ms=event_ms(bwd, 5),
            fwd_device_ms=_device_split(fwd), bwd_device_ms=_device_split(bwd),
            nchw_copy_ms=event_ms(
                lambda: h.permute(0, 3, 1, 2).contiguous(), 20))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
