"""The readings that the limits of `correct` are set from: the program's
numbers on many seeds, the control's and the planted faults' on a few,
each at the cell's own size, in one process. The control is the program
one precision lower than its configuration states: its bfloat16 path
where the configuration allows TF32 convolutions, TF32 convolutions where
it states float32 ones. The benchmark's runs never call it.

    python3 port_bench/control.py --workload <name> --seeds 1,2,3 \\
        [--control 1,2,3] [--witness 1] [--faults half_batch:1,2,3] \\
        [--look 1,2] [--out FILE]

Prints one JSON line a reading: {"seed", "side", numbers...}; "side" is
"program", "control", "program_tf32_off" (the witness: the program with
TF32 off in cuDNN's convolutions), the fault's name, or "look" (a
training cell's first gradient leaf by leaf: the program, the witness and
the float32 reference each against a float64 reference).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


SIDES = ("program", "control", "program_tf32_off")
ADAM_EPS = 1e-8  # the program's Adam and the reference's


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def readings(workload, seed, side, device, cfg_overrides=None,
             traffic_overrides=None, leaves=False):
    import torch
    from port_bench.harness import Bench, Env
    bench = Bench(ROOT)
    cell = bench.workload(workload)
    cfg = dict(bench.config(cell["config"]), **(cfg_overrides or {}))
    traffic = dict(bench.traffic(cell["traffic"]),
                   **(traffic_overrides or {}))
    faults = () if side in SIDES else (side,)
    env = Env(torch.device(device), seed, cfg, traffic,
              bench.family(cfg["family"]), frozenset(faults))
    kind = bench.traffic_kind(traffic["kind"])
    # the control is the next precision below the configuration's: bfloat16
    # below TF32 convolutions, TF32 below float32 ones; the witness is the
    # program with TF32 off
    bf16_control = side == "control" and cfg["cudnn_tf32"]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = side != "program_tf32_off" and (
        cfg["cudnn_tf32"] or side == "control")
    if traffic["kind"] == "serve_volumes":
        state = kind.setup(env)
        out = kind.control_readings(state, side == "control")
        out = out["control"] if side == "control" else out["program"]
    else:
        state = kind.setup(env, bf16=bf16_control)
        got = state.readings
        state.trainer = state.readings = None
        r = kind.reference_readings(env, got)
        drop = ("left_out",) if leaves else ("left_out", "leaves")
        out = {k: v for k, v in r.items() if k not in drop}
        out["losses"] = got["losses"]
    torch.backends.cudnn.allow_tf32 = tf32
    del state
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return dict(seed=seed, side=side, **out)


def _agreement(x, ref) -> dict:
    """x against the float64 reference `ref`, one leaf: the relative gap
    of the whole leaf, the share of elements whose sign agrees (of those
    the reference does not leave at 0), and Adam's first move of the leaf
    |g| / (|g| + eps) in the mean over its elements, x's and ref's."""
    import torch
    x, ref, eps = x.double(), ref.double(), ADAM_EPS
    nz = ref != 0
    return {"gap": float(torch.linalg.vector_norm(x - ref)
                         / torch.linalg.vector_norm(ref).clamp_min(1e-300)),
            "sign": float((torch.sign(x) == torch.sign(ref))[nz]
                          .double().mean()) if nz.any() else 1.0,
            "move": float((x.abs() / (x.abs() + eps)).mean()),
            "move_ref": float((ref.abs() / (ref.abs() + eps)).mean())}


def look(workload, seed, device, cfg_overrides=None,
         traffic_overrides=None) -> dict:
    """A training cell's first gradient, leaf by leaf, on one seed: the
    program as its configuration states it, the program with TF32 off,
    and the float32 reference, each against the reference in float64 on
    the same weights, batch and noise (the synthesis in float32 in both;
    the family's `reference_grad`, slice by slice); with each leaf's size,
    its float64 norm, the median |g| and the share of its elements under
    10 eps."""
    import torch
    from port_bench.harness import Bench, Env
    from port_bench.kinds import train_steps
    from port_bench.kinds.serve_volumes import reference_nets
    from port_bench.reference import precision
    bench = Bench(ROOT)
    cell = bench.workload(workload)
    cfg = dict(bench.config(cell["config"]), **(cfg_overrides or {}))
    traffic = dict(bench.traffic(cell["traffic"]),
                   **(traffic_overrides or {}))
    env = Env(torch.device(device), seed, cfg, traffic,
              bench.family(cfg["family"]))
    grads = {}
    tf32 = torch.backends.cudnn.allow_tf32
    for side, allow in (("program", cfg["cudnn_tf32"]),
                        ("program_tf32_off", False)):
        torch.backends.cudnn.allow_tf32 = allow
        state = train_steps.setup(env)
        grads[side] = state.readings["first_grads"]
        del state
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = tf32
    batch = train_steps.replay(env)[0]
    for side, dtype in (("reference32", torch.float32),
                        ("reference64", torch.float64)):
        nets = {k: v.to(dtype) for k, v in reference_nets(env).items()}
        with precision.float32():
            first = env.family.reference_grad(cfg, nets, batch, env.device,
                                              env.seeds["noise"], dtype)
        grads[side] = {k: v.cpu() for k, v in first.items()}
        del nets, first
        gc.collect()
        torch.cuda.empty_cache()
    ref = grads.pop("reference64")
    leaves = {}
    for k, g in ref.items():
        a = g.double().abs()
        leaves[k] = {"n": g.numel(), "norm": float(torch.linalg.vector_norm(
            g.double())), "median_abs": float(a.median()),
            "under_10eps": float((a < 10 * ADAM_EPS).double().mean()),
            **{side: _agreement(grads[side][k], g) for side in grads}}
    return {"seed": seed, "side": "look", "leaves": leaves}


def _look_summary(r: dict) -> dict:
    """The TE encoders' leaves (`encoder.te.`) and the others apart, of
    those the change's rule keeps: the largest gap, the least sign
    agreement, Adam's first move, per side."""
    from port_bench.compare import moving_leaves
    out = {"seed": r["seed"], "side": "look"}
    moving = set(moving_leaves({k: v["norm"] for k, v in r["leaves"].items()}))
    for group, pick in (("te", lambda k: ".encoder.te." in k),
                        ("rest", lambda k: ".encoder.te." not in k)):
        ls = {k: v for k, v in r["leaves"].items() if pick(k) and k in moving}
        if not ls:
            continue
        sides = ("program", "program_tf32_off", "reference32")
        out[group] = {
            "leaves": len(ls),
            "under_10eps": max(v["under_10eps"] for v in ls.values()),
            "median_abs": [min(v["median_abs"] for v in ls.values()),
                           max(v["median_abs"] for v in ls.values())],
            **{s: {"gap": max(v[s]["gap"] for v in ls.values()),
                   "sign": min(v[s]["sign"] for v in ls.values()),
                   "move": [min(v[s]["move"] for v in ls.values()),
                            max(v[s]["move"] for v in ls.values())]}
               for s in sides}}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--witness", default="",
                    help="seeds of the program with TF32 off")
    ap.add_argument("--faults", default="", help="name:seeds;name:seeds")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--leaves", type=int, default=0,
                    help="1: also each leaf's first gradient and change")
    ap.add_argument("--look", default="",
                    help="seeds of the first gradient against float64")
    args = ap.parse_args(argv)
    plan = [(s, "program") for s in _seeds(args.seeds)]
    plan += [(s, "control") for s in _seeds(args.control)]
    plan += [(s, "program_tf32_off") for s in _seeds(args.witness)]
    for part in filter(None, args.faults.split(";")):
        name, seeds = part.split(":")
        plan += [(s, name) for s in _seeds(seeds)]
    plan += [(s, "look") for s in _seeds(args.look)]
    out = open(args.out, "a") if args.out else None
    for seed, side in plan:
        r = (look(args.workload, seed, args.device) if side == "look" else
             readings(args.workload, seed, side, args.device,
                      leaves=bool(args.leaves)))
        line = json.dumps(r)
        print(line if side != "look" else json.dumps(_look_summary(r)),
              flush=True)
        if out:
            out.write(line + "\n")
            out.flush()


if __name__ == "__main__":
    main()
