"""The ConvLSTM backward's random-input float64 gate over many inputs, on
the card.

    python -m ideal_gan_tpu_torch.cli.convlstm_pair_gate [--seeds 12]
        [--data_size 384]

`chip_smoke.py::convlstm_bwd_entry` holds, on random inputs, the first pair
of samples' dx, dk and db each to 1e-4 of the float64 plain version's
scale, with g zeroed around every value within `KINK_TOL` (1e-6) of
leaky_relu's kink (`ops.kink_masked_gradient`). Before the mask the gate
held g as drawn to twice the plain float32 version's distance from
float64, plus 1e-5 of the scale. This runs both ("masked", "unmasked") at nb=2 on
`chip_smoke.py`'s own inputs (seed "chip_smoke": the first two of its nb=8
draws) and on `--seeds` others (default_rng(5000 + seed), drawn the same
way), for each (Cin, F) of (2, 36), (1, 36), (2, 72) at ne=6, with the
backward's reverse sweep (`csrc/convlstm_bwd.cu`) run around four stacks
of states:

- "kernel": the forward kernel's, which `convlstm_backward` recomputes;
- "plain_f32": the plain float32 recurrence's;
- "f64_rounded": the float64 recurrence's rounded to float32, the most
  exact states a float32 stack can hold;
- "plain_tf32": the plain recurrence's with cuDNN's TF32 convolutions, a
  stack ~1e-3 off: the gate must fail on it.

Per case, stack and form it reports the largest of dx's, dk's and db's
distance from float64 over the form's bound (above 1 fails), and, masked,
each one's distance over its scale (the plain f32 version's beside it);
per stack the
largest state error against float64, the cells c_e (e < ne-1) whose sign
differs from float64's, and the largest error of the values within 1e-4 of
the kink that decide the sweep's branches (the cells c_e, and the g-gate
pre-activations z_g,e computed in float64 from the stack's h_{e-1}); the
share of pixels the mask zeroes. Where the kernel stack fails unmasked it
also reports the worst dx element and, in the cells that feed it (its 3×3
neighbourhood, at its echo and later), the cell nearest the kink: its
value in float64, in the forward kernel's states and in the plain
version's. Prints one JSON line: the card's name and power limit, every
case, and per stack and form the number of failing cases.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import convlstm as cl
from .common import parse_flags, resolve_device

SHAPES = ((2, 36), (1, 36), (2, 72))
NE = 6
STACKS = ("kernel", "plain_f32", "f64_rounded", "plain_tf32")
_ACTS = ("leaky_relu", "sigmoid")
_NEAR = 1e-4


def _inputs(cin, f, size, seed, dev):
    """(x, k, b, g) of one pair of samples."""
    rng = np.random.default_rng(10 + cin if seed is None else 5000 + seed)
    nb = 8 if seed is None else 2
    x = (rng.normal(size=(nb, NE, size, size, cin)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin + f, 4 * f))
         * (2.0 / (9 * (cin + f))) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(4 * f,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(nb, size, size, f)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (x[:2], k, b, g[:2])]


def _plain_states(x, k, b, tf32):
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return cl._reference_states(x, k, b, *_ACTS)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _near_kink_err(x, k, b, st, s64):
    """The largest error of the cells c_e and of z_g,e (in float64 from the
    stack's h_{e-1}) among those within 1e-4 of the kink in float64."""
    f = k.shape[3] // 4
    w = k.double().permute(3, 2, 0, 1)[2 * f:3 * f]

    def z_g(e, h_prev):
        inp = torch.cat([x[:, e].double().permute(0, 3, 1, 2),
                         h_prev.double()], 1)
        return F.conv2d(inp, w, padding=1)

    pairs = [(st[e][1], s64[e][1]) for e in range(NE)]
    pairs += [(z_g(e, st[e - 1][0]), z_g(e, s64[e - 1][0]))
              for e in range(1, NE)]
    worst = 0.0
    for v, v64 in pairs:
        near = v64.abs() < _NEAR
        if near.any():
            worst = max(worst, float((v.double() - v64)[near].abs().max()))
    return worst


def _nearest_kink(dx_err, stacks, s64):
    """The worst dx element and the cell nearest the kink among those that
    feed it."""
    bi, ei, yi, xi, _ = np.unravel_index(int(dx_err.argmax()),
                                         tuple(dx_err.shape))
    y0, x0 = max(yi - 1, 0), max(xi - 1, 0)
    best = None
    for e in range(ei, NE):
        c64 = s64[e][1][bi, :, y0:yi + 2, x0:xi + 2]
        j = tuple(int(v) for v in np.unravel_index(
            int(c64.abs().argmin()), tuple(c64.shape)))
        v = float(c64[j])
        if best is None or abs(v) < abs(best["f64"]):
            best = dict(echo=e, f64=v, **{
                name: float(stacks[name][e][1][bi, :, y0:yi + 2, x0:xi + 2][j])
                for name in ("kernel", "plain_f32")})
    return dict(dx_worst=[int(bi), int(ei), int(yi), int(xi)],
                nearest_kink_cell=best)


def run_case(cin, f, size, seed, dev) -> dict:
    x, k, b, g = _inputs(cin, f, size, seed, dev)
    s64 = cl._reference_states(x.double(), k.double(), b.double(), *_ACTS)
    hk, ck = cl._kernel_states(x, cl._aligned(k), b, NE)
    stacks = {"kernel": list(zip(hk, ck)),
              "plain_f32": _plain_states(x, k, b, False),
              "f64_rounded": [(h.float(), c.float()) for h, c in s64],
              "plain_tf32": _plain_states(x, k, b, True)}
    gm = cl.kink_masked_gradient(x, k, b, g)
    case = dict(cin=cin, F=f, seed="chip_smoke" if seed is None else seed,
                masked_share=float((gm == 0).all(-1).double().mean()))
    for name, st in stacks.items():
        case[name] = dict(
            state_max_err=max(float((v.double() - r).abs().max())
                              for (hv, cv), (hr, cr) in zip(st[:NE - 1],
                                                            s64[:NE - 1])
                              for v, r in ((hv, hr), (cv, cr))),
            kink_flips=sum(int(((c >= 0) != (c64 >= 0)).sum())
                           for (_, c), (_, c64) in zip(st[:NE - 1],
                                                       s64[:NE - 1])),
            near_kink_max_err=_near_kink_err(x, k, b, st, s64))
    hs = {n: torch.stack([h for h, _ in st[:NE - 1]])
          for n, st in stacks.items()}
    cs = {n: torch.stack([c for _, c in st[:NE - 1]])
          for n, st in stacks.items()}
    for form, grad in (("unmasked", g), ("masked", gm)):
        ref = cl.convlstm_backward_reference(x, k, b, grad)
        ref64 = cl.convlstm_backward_reference(
            *(t.double() for t in (x, k, b, grad)))
        scale = [float(t.abs().max()) for t in ref64]
        plain = [float((r.double() - t).abs().max())
                 for r, t in zip(ref, ref64)]
        bound = [1e-4 * sc for sc in scale] if form == "masked" else \
            [2 * p + 1e-5 * sc for p, sc in zip(plain, scale)]
        if form == "masked":
            case["plain_f32_rel_masked"] = [p / sc
                                            for p, sc in zip(plain, scale)]
        for name in stacks:
            got = cl._reverse_sweep(x, k, b, grad, hs[name], cs[name], True)
            errs = [(a.double() - t).abs() for a, t in zip(got, ref64)]
            ratio = max(float(err.max()) / bd for err, bd in zip(errs, bound))
            case[name][f"gate_ratio_{form}"] = ratio
            if form == "masked":
                case[name]["rel_masked"] = [float(err.max()) / sc
                                            for err, sc in zip(errs, scale)]
            if name == "kernel" and form == "unmasked" and ratio > 1:
                case[name].update(_nearest_kink(errs[0], stacks, s64))
    return case


def main(argv=None):
    cfg = parse_flags(dict(seeds=12, data_size=384, device="cuda"), argv)
    dev = resolve_device(cfg["device"])
    if dev.type != "cuda":
        raise SystemExit("convlstm_pair_gate runs the card's kernels: "
                         "--device cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for cin, f in SHAPES:
        for seed in [None] + list(range(cfg["seeds"])):
            cases.append(run_case(cin, f, cfg["data_size"], seed, dev))
            torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "card": smi, "size": cfg["data_size"], "ne": NE, "nb": 2,
        "tol": cl.KINK_TOL, "cases": cases,
        "failing": {f"{s}_{form}": sum(c[s][f"gate_ratio_{form}"] > 1
                                       for c in cases)
                    for s in STACKS for form in ("unmasked", "masked")},
        "worst_masked_ratio": {s: max(c[s]["gate_ratio_masked"]
                                      for c in cases) for s in STACKS},
        "worst_masked_rel_dx_dk_db": {
            s: [max(c[s]["rel_masked"][i] for c in cases) for i in range(3)]
            for s in STACKS},
        "worst_masked_plain_f32_rel_dx_dk_db": [
            max(c["plain_f32_rel_masked"][i] for c in cases)
            for i in range(3)],
        "near_kink_max_err": {s: max(c[s]["near_kink_max_err"]
                                     for c in cases) for s in STACKS},
        "masked_share": [min(c["masked_share"] for c in cases),
                         max(c["masked_share"] for c in cases)],
        "kink_flips": {s: sum(c[s]["kink_flips"] for c in cases)
                       for s in STACKS}}))


if __name__ == "__main__":
    main()
