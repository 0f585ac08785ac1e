"""Device-time breakdown of a training step on the card.

    python -m ideal_gan_tpu_torch.cli.profile_train [--trainer unsup]
        [--data_size 384] [--batch_size 8] [--steps 3] [--n_G_filters 36]
        [--seed 0] [--UQ 1 --UQ_R2s 1 [--UQ_calib 1]]
    python -m ideal_gan_tpu_torch.cli.profile_train --trainer teaug
        [--data_size 384] [--batch_size 8] [--steps 3] [--n_G_filters 72]
        [--G_model VET-Net|U-Net|2U-Net|MDWF-Net]
    python -m ideal_gan_tpu_torch.cli.profile_train --trainer sup
        [--data_size 384] [--batch_size 8] [--steps 3] [--n_G_filters 72]
        [--G_model multi-decod|U-Net] [--out_vars WF|WFc|PM|WF-PM]
        [--TE1 0.0014 --dTE 0.0022]
    python -m ideal_gan_tpu_torch.cli.profile_train --trainer mag
        [--data_size 384] [--batch_size 8] [--steps 3] [--n_G_filters 36]
        [--training_mode supervised]
    python -m ideal_gan_tpu_torch.cli.profile_train --trainer single
        [--data_size 384] [--steps 3] [--n_G_filters 36]
        [--grad_mode bipolar]

Every trainer takes `--bf16 1` and `--remat 1`, teaug and sup also
`--microbatch N`, as their CLIs do; the JSON line names them.

`--trainer unsup` (the default) runs `--steps` AI-DEAL PM-mode step pairs
(the FM step, then the R2 step with g_fm frozen, as `cli.train_unsup` runs
them; with `--UQ 1 --UQ_R2s 1` the Bayesian heads and the heteroscedastic
loss), or with `--UQ_calib 1` `--steps` σ-calibration steps (both nets
frozen); `--trainer teaug` runs `--steps` generator steps of `--G_model` (as
`cli.train_teaug` runs them, at one sampled TE train; the 2U-Net's step is
G_A2B's step, then G_A2R2's); `--trainer mag` runs `--steps` magnitude R2*
steps (as `cli.train_mag` runs them, at the cohort's TE train);
`--trainer sup` runs `--steps` supervised steps (as `cli.train_sup` runs
them, at the cohort's TE train); `--trainer single` runs `--steps`
full-batch single-subject steps on 3 slices (as `cli.train_single` runs
them). Each runs on one synthetic batch under `torch.profiler`, after one warm-up step, and print
one JSON line: the card's name and power limit, the wall time per step, the
device time per step in each kernel category (the hand-written kernels,
the ConvLSTM backward's sweep by stage, cuDNN convolutions, cuDNN's RNN
kernels, matmuls, copies, the rest), the device time inside the physics
Functions' reference backward, the optimizer steps and the ConvLSTM
backward's state recompute (profiler ranges; the recompute's forward-kernel
launches are also counted in "convlstm_fwd kernel"), the device time of
every kernel the TEEncoders' LSTM operators launch (forward and backward),
the share of the window the card was idle, and the peak device memory.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.autograd import DeviceType

from ..ops.convlstm import RECOMPUTE_RANGE
from ..ops.ideal import BACKWARD_RANGE
from ..train import mag, single, sup, teaug, unsup
from ..train.common import STEP_RANGE
from .common import parse_flags, resolve_device, synthetic_dataset
from .profile_infer import category

CATEGORIES = (
    ("convlstm_fwd kernel", ("convlstm_echo",)),
    ("convlstm_bwd (a) gates", ("gates_mma", "gates_wg")),
    ("convlstm_bwd (b) dinp", ("dinp_mma",)),
    ("convlstm_bwd (c) dk", ("dk_mma",)),
    ("convlstm_bwd reduce", ("sum_slots",)),
    ("ideal_cycle kernel", ("cycle_kernel",)),
    ("ideal_forward kernel", ("synth_kernel",)),
    ("ideal_mag_fit kernel", ("mag_ls_kernel",)),
    ("ideal_fit kernel", ("fit_kernel",)),
    ("cuDNN RNN kernels", ("rnn", "lstm", "elemwise")),
    ("copies", ("memcpy", "memset")),
    ("convolutions", ("conv", "cudnn", "xmma", "implicit", "winograd",
                      "dgrad", "wgrad", "fprop")),
    ("matmuls", ("gemm", "matmul")),
)
RANGES = (BACKWARD_RANGE, STEP_RANGE, RECOMPUTE_RANGE)


def _is_lstm_op(name: str) -> bool:
    """The host-side operators of the TEEncoders' LSTMs, forward and
    backward, whose launched kernels (cuDNN's RNN kernels and the matmuls
    inside them) are the LSTMs' device time."""
    return name == "aten::lstm" or (
        name.startswith("autograd::engine::evaluate_function:")
        and "Rnn" in name)


def _unsup_step(argv):
    """(cfg, device, step): one AI-DEAL PM step pair on one synthetic batch,
    or with UQ_calib one calibration step."""
    cfg = parse_flags(dict(unsup.DEFAULTS, data_size=384, steps=3, seed=0,
                           device="cuda", out_vars="PM"), argv)
    dev = resolve_device(cfg["device"])
    bs, size = cfg["batch_size"], cfg["data_size"]
    acqs, _, te = synthetic_dataset(bs, h=size, w=size, ne=cfg["n_echoes"],
                                    field=cfg["field"])
    batch = (torch.from_numpy(acqs).to(dev), torch.from_numpy(te).to(dev))
    g_fm, g_r2 = unsup.build_models(cfg)
    step_fn, tx = unsup.make_train_step(cfg, g_fm, g_r2)
    r2_step_fn = unsup.make_r2_train_step(cfg, g_fm, g_r2, tx)
    calib_fn = unsup.make_calib_train_step(cfg, g_fm, g_r2)
    state = unsup.init_state(cfg, g_fm, g_r2, tx,
                             torch.Generator().manual_seed(cfg["seed"]), dev)

    def step():
        nonlocal state
        if cfg["UQ_calib"]:
            state, _ = calib_fn(state, batch)
            return
        state, _ = step_fn(state, batch)
        state, _ = r2_step_fn(state, batch)

    return cfg, dev, step


def _teaug_step(argv):
    """(cfg, device, step): one generator step (the 2U-Net: G_A2B's and
    G_A2R2's) on one synthetic batch."""
    cfg = parse_flags(dict(teaug.DEFAULTS, data_size=384, steps=3, seed=0,
                           device="cuda"), argv)
    dev = resolve_device(cfg["device"])
    bs, size = cfg["batch_size"], cfg["data_size"]
    _, maps, _ = synthetic_dataset(bs, h=size, w=size, ne=cfg["n_echoes"],
                                   field=cfg["field"])
    gen = torch.Generator().manual_seed(cfg["seed"])
    batch = (torch.from_numpy(maps).to(dev),
             teaug.sample_te(gen, cfg, bs).to(dev))
    model = teaug.build_model(cfg)
    r2_model = (teaug.build_r2_model(cfg) if cfg["G_model"] == "2U-Net"
                else None)
    step_fn, tx = teaug.make_train_step(cfg, model, r2_model)
    steps = [step_fn] if r2_model is None else [
        step_fn, teaug.make_r2_train_step(cfg, model, r2_model, tx)]
    state = teaug.init_state(cfg, model, tx, gen, dev, r2_model)
    noise_gen = torch.Generator(device=dev).manual_seed(cfg["seed"])

    def step():
        for fn in steps:
            fn(state, batch, noise_gen)

    return cfg, dev, step


def _sup_step(argv):
    """(cfg, device, step): one supervised step on one synthetic batch."""
    cfg = parse_flags(dict(sup.DEFAULTS, data_size=384, steps=3, seed=0,
                           device="cuda"), argv)
    dev = resolve_device(cfg["device"])
    bs, size = cfg["batch_size"], cfg["data_size"]
    data = synthetic_dataset(bs, h=size, w=size, ne=cfg["n_echoes"],
                             field=cfg["field"])
    batch = tuple(torch.from_numpy(x).to(dev) for x in data)
    model = sup.build_model(cfg)
    step_fn, tx = sup.make_train_step(cfg, model)
    state = sup.init_state(cfg, model, tx,
                           torch.Generator().manual_seed(cfg["seed"]), dev)
    noise_gen = torch.Generator(device=dev).manual_seed(cfg["seed"])

    def step():
        step_fn(state, batch, noise_gen)

    return cfg, dev, step


def _mag_step(argv):
    """(cfg, device, step): one magnitude R2* step on one synthetic batch."""
    cfg = parse_flags(dict(mag.DEFAULTS, data_size=384, steps=3, seed=0,
                           device="cuda"), argv)
    dev = resolve_device(cfg["device"])
    bs, size = cfg["batch_size"], cfg["data_size"]
    _, maps, te = synthetic_dataset(bs, h=size, w=size, ne=cfg["n_echoes"],
                                    field=cfg["field"])
    batch = (torch.from_numpy(maps).to(dev), torch.from_numpy(te).to(dev))
    model = mag.build_model(cfg)
    step_fn, tx = mag.make_train_step(cfg, model)
    state = mag.init_state(cfg, model, tx,
                           torch.Generator().manual_seed(cfg["seed"]), dev)

    def step():
        nonlocal state
        state, _ = step_fn(state, batch)

    return cfg, dev, step


def _single_step(argv):
    """(cfg, device, step): one single-subject step on 3 synthetic slices."""
    cfg = parse_flags(dict(single.DEFAULTS, data_size=384, steps=3, seed=0,
                           device="cuda", batch_size=3), argv)
    dev = resolve_device(cfg["device"])
    size = cfg["data_size"]
    data = synthetic_dataset(cfg["batch_size"], h=size, w=size,
                             ne=cfg["n_echoes"])
    batch = tuple(torch.from_numpy(x).to(dev) for x in data)
    g_mag, g_pha = single.build_models(cfg)
    step_fn, tx = single.make_train_step(cfg, g_mag, g_pha)
    state = single.init_state(cfg, g_mag, g_pha, tx,
                              torch.Generator().manual_seed(cfg["seed"]),
                              dev)

    def step():
        step_fn(state, batch)

    return cfg, dev, step


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--trainer", default="unsup",
                     choices=("unsup", "teaug", "mag", "sup", "single"))
    known, argv = pre.parse_known_args(argv)
    cfg, dev, step = {"unsup": _unsup_step, "teaug": _teaug_step,
                      "mag": _mag_step, "sup": _sup_step,
                      "single": _single_step}[known.trainer](argv)
    if dev.type != "cuda":
        raise SystemExit("profile_train measures the card: --device cuda")
    step()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(cfg["steps"]):
            step()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, spans = [], {r: [] for r in RANGES}
    lstm_ms = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            if _is_lstm_op(ev.name):
                lstm_ms += ev.device_time_total / 1e3
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
    bs = cfg["batch_size"]
    busy = sum(per_cat.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    unit = "step"
    if known.trainer == "unsup":
        unit = "calib_step" if cfg["UQ_calib"] else "step_pair"
    print(json.dumps({
        "card": smi, "trainer": known.trainer,
        "G_model": cfg.get("G_model"), "out_vars": cfg.get("out_vars"),
        "UQ": cfg.get("UQ"), "UQ_R2s": cfg.get("UQ_R2s"),
        "bf16": bool(cfg.get("bf16")), "remat": bool(cfg.get("remat")),
        "microbatch": cfg.get("microbatch"), "batch": bs,
        "size": cfg["data_size"], "F": cfg["n_G_filters"], f"{unit}s": n,
        f"wall_ms_per_{unit}": wall_ms / n,
        "slices_per_s": bs * n * 1e3 / wall_ms,
        f"device_ms_per_{unit}": {k: v / n
                                  for k, v in sorted(per_cat.items())},
        f"device_ms_in_ranges_per_{unit}": {k: v / n
                                            for k, v in in_range.items()},
        f"device_ms_in_te_encoder_lstms_per_{unit}": lstm_ms / n,
        f"device_busy_ms_per_{unit}": busy / n,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        f"top_kernels_ms_per_{unit}": [[k[:90], v / n] for k, v in top],
    }))


if __name__ == "__main__":
    main()
