"""CLI: single-subject self-supervised fitting on the card (port of
`ideal_gan_tpu/cli/train_single.py`).

    python -m ideal_gan_tpu_torch.cli.train_single --synthetic 12 \\
        --data_size 384 --data_idx 3 --epochs 20 --epoch_ckpt 10 \\
        --device cuda --output_base output

The whole dataset is the `data_idx`-th group of three slices of the
cohort, slices [3·data_idx, 3·data_idx + 3) (SystemExit where that range
is empty), of `--synthetic N` slices or else the HDF5 cohorts under
`--dataset_dir`. G_mag and G_pha (`train.single`) train from seeded
random weights (`--seed`) full-batch, one step an epoch. The run record,
as in the JAX CLI (kept by `train.common.RunRecord`): settings.yml, the `G_losses`
summaries every 50 epochs under summaries/train, checkpoints every
`--epoch_ckpt` epochs, at the end and on SIGTERM/SIGINT ("preempted:
checkpointed epoch N, exiting", exit 0) under
<output_base>/<dataset>/checkpoints/, with an `epoch N/M cycle=...` line
each, and a resume from the latest one ("resumed from epoch N").
`--device` defaults to `cuda` and raises without a card; `cpu` runs the
plain PyTorch versions of the kernels.

`--bf16 1` computes the nets in bfloat16 (the ConvLSTM kernels' bf16
storage mode; parameters and physics float32) and `--remat 1`
rematerializes their blocks in the backward.
"""

from __future__ import annotations

import time

import torch

from ..train import single
from ..train.common import RunRecord
from .common import load_cohorts, resolve_device, setup_experiment


def main(argv=None) -> dict:
    """Runs the training; returns {"state": SingleState, "epochs":
    [{"epoch", "seconds", "steps", metric: value, ...}]}, one entry per
    checkpoint (the metrics of its step, the steps and wall time since the
    previous entry, its checkpoint included, ending in a synchronisation),
    and "preempted": bool."""
    cfg = setup_experiment(single.DEFAULTS, argv)
    dev = resolve_device(cfg["device"])
    acqs, maps, te = load_cohorts(cfg)
    i0 = cfg["data_idx"] * 3
    acqs, maps, te = acqs[i0:i0 + 3], maps[i0:i0 + 3], te[i0:i0 + 3]
    if len(acqs) == 0:
        raise SystemExit("data_idx out of range for this cohort")

    g_mag, g_pha = single.build_models(cfg)
    step_fn, tx = single.make_train_step(cfg, g_mag, g_pha)
    state = single.init_state(cfg, g_mag, g_pha, tx,
                              torch.Generator().manual_seed(cfg["seed"]),
                              dev)
    record = RunRecord(cfg, state, 1, summary_every=50)
    batch = tuple(torch.from_numpy(x).to(dev) for x in (acqs, maps, te))
    epochs, stop = [], False
    t0, last = time.perf_counter(), record.start
    try:
        for ep in range(record.start, cfg["epochs"]):
            state, metrics = step_fn(state, batch)
            record.step(metrics)
            stop = record.end_epoch(ep, state)
            if (ep + 1) % cfg["epoch_ckpt"] == 0 or ep + 1 == cfg["epochs"] \
                    or stop:
                values = {k: float(v) for k, v in metrics.items()}  # syncs
                epochs.append(dict(epoch=ep + 1,
                                   seconds=time.perf_counter() - t0,
                                   steps=ep + 1 - last, **values))
                print(f"epoch {ep + 1}/{cfg['epochs']} "
                      f"cycle={values['A2B2A_cycle_loss']:.6f}")
                t0, last = time.perf_counter(), ep + 1
            if stop:
                break
    finally:
        record.close()
    return {"state": state, "epochs": epochs, "preempted": stop}


if __name__ == "__main__":
    main()
