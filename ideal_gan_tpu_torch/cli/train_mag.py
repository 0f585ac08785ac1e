"""CLI: magnitude R2*/PDFF training on the card (port of
`ideal_gan_tpu/cli/train_mag.py`).

    python -m ideal_gan_tpu_torch.cli.train_mag --synthetic 16 \\
        --data_size 384 --batch_size 8 --epochs 2 --device cuda \\
        --output_base output

Trains the magnitude UNet (`--n_G_filters 36`, self-attention; the TE
input in the default supervised mode) from seeded random weights
(`--seed`) on the ground-truth maps of the cohort and its TE trains
(`--synthetic N` slices, or else the HDF5 cohorts under `--dataset_dir`):
one step per shuffled batch (acquisitions synthesized from the maps, the
magnitude fit, the loss of `train.mag.make_loss_fn`). The run record, as
in the JAX CLI (kept by `train.common.RunRecord`): settings.yml, the `G_losses`
summaries every 20 steps under summaries/train, checkpoints every
`--epoch_ckpt` epochs, at the end and on SIGTERM/SIGINT ("preempted:
checkpointed epoch N, exiting", exit 0) under
<output_base>/<dataset>/checkpoints/, and a resume from the latest one
("resumed from epoch N"). Prints one `G_loss` line per epoch. `--device`
defaults to `cuda` and raises without a card; `cpu` runs the plain PyTorch
versions of the kernels.

`--bf16 1` computes the nets in bfloat16 (the ConvLSTM kernels' bf16
storage mode; parameters and physics float32) and `--remat 1`
rematerializes their blocks in the backward.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..train import mag
from ..train.common import RunRecord, batch_iterator
from .common import load_cohorts, resolve_device, setup_experiment


def main(argv=None) -> dict:
    """Runs the training; returns {"state": MagState, "epochs": [{"epoch",
    "seconds", "steps", metric: value, ...}]}, one entry per epoch run (the
    metrics of its last step, the wall time of the epoch ending in a
    synchronisation), and "preempted": bool."""
    cfg = setup_experiment(mag.DEFAULTS, argv)
    dev = resolve_device(cfg["device"])
    model = mag.build_model(cfg)
    _, maps, te = load_cohorts(cfg)
    n = len(maps)
    if n < cfg["batch_size"]:
        raise SystemExit(
            f"the cohort has {n} slices < batch_size {cfg['batch_size']}; "
            "reduce --batch_size (batches drop the remainder, so no step "
            "would run)")
    steps_per_epoch = n // cfg["batch_size"]

    step_fn, tx = mag.make_train_step(cfg, model)
    state = mag.init_state(cfg, model, tx,
                           torch.Generator().manual_seed(cfg["seed"]), dev)
    record = RunRecord(cfg, state, steps_per_epoch)
    rng = np.random.default_rng(0)
    epochs, stop = [], False
    try:
        for ep in range(record.start, cfg["epochs"]):
            t0 = time.perf_counter()
            for B, te_b in batch_iterator((maps, te), cfg["batch_size"], rng):
                state, metrics = step_fn(
                    state, (torch.from_numpy(B).to(dev),
                            torch.from_numpy(te_b).to(dev)))
                record.step(metrics)
            values = {k: float(v) for k, v in metrics.items()}  # syncs
            epochs.append(dict(epoch=ep + 1, seconds=time.perf_counter() - t0,
                               steps=steps_per_epoch, **values))
            stop = record.end_epoch(ep, state)
            if stop:
                break
            print(f"epoch {ep + 1}/{cfg['epochs']} "
                  f"G_loss={values['G_loss']:.6f}")
    finally:
        record.close()
    return {"state": state, "epochs": epochs, "preempted": stop}


if __name__ == "__main__":
    main()
