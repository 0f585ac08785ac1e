"""CLI: TE-augmentation training on the card (port of
`ideal_gan_tpu/cli/train_teaug.py`).

    python -m ideal_gan_tpu_torch.cli.train_teaug --synthetic 16 \\
        --data_size 384 --batch_size 8 --epochs 2 --device cuda \\
        --output_base output

Trains the generator of `--G_model` (VET-Net by default, `--n_G_filters
72`, TE input, FM self-attention; U-Net, 2U-Net or MDWF-Net; `--out_vars`
PM or WF) from seeded random weights (`--seed`) on the ground-truth maps
of the cohort
(`--synthetic N` slices, or else the HDF5 cohorts under `--dataset_dir`):
per batch `data_aug_p` geometric augmentation (with `--FM_aug`, a random
field-map scale), with `--bip_grad` a bipolar phase row, one TE train from
`train.teaug.sample_te`, then one generator step on acquisitions
synthesized at that TE train plus noise; with the 2U-Net, then one step
of its R2* net G_A2R2 on the same batch and noise with G_A2B frozen.
The run record, as in the JAX CLI (kept by `train.common.RunRecord`): settings.yml,
the `G_losses` summaries every 20 steps under summaries/train, checkpoints
(both nets with the 2U-Net) every `--epoch_ckpt` epochs, at the end and
on SIGTERM/SIGINT ("preempted: checkpointed epoch N, exiting", exit 0)
under <output_base>/<dataset>/checkpoints/, and a resume from the latest
one ("resumed from epoch N"). Prints one `PM_loss` line per epoch.
`--device` defaults to `cuda` and raises without a card; `cpu` runs the
plain PyTorch versions of the kernels.

`--bf16 1` computes the nets in bfloat16 (the ConvLSTM kernels' bf16
storage mode; parameters and physics float32), `--remat 1`
rematerializes their blocks in the backward, and `--microbatch N`
accumulates G_A2B's gradients over chunks of N slices, each with its own
noise (the batch must be a multiple of N).

On N cards: `python -m torch.distributed.run --standalone --nproc_per_node
N -m ideal_gan_tpu_torch.cli.train_teaug ...`. Every rank draws the same
global batches, TE trains and noise (the same seeds) and trains on its
rows (`parallel.data_mesh_for_batch(batch_size)`); rank 0 writes the run
record. With `--microbatch` the chunks are of the rank's rows. The JAX
CLI's warning about a TPU compiler crash has no counterpart on the card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data import bipolar_phase_row, random_fm_scale, random_geometric
from ..parallel import shard_batch
from ..train import teaug
from ..train.common import RunRecord, batch_iterator, metrics_to_host
from .common import (IDLE, load_cohorts, resolve_device, setup_experiment,
                     train_mesh)


def main(argv=None) -> dict:
    """Runs the training; returns {"state": TEAugState, "epochs": [{"epoch",
    "seconds", "steps", metric: value, ...}]}, one entry per epoch run (the
    metrics of its last step, the wall time of the epoch ending in a
    synchronisation), and "preempted": bool."""
    cfg = setup_experiment(teaug.DEFAULTS, argv)
    dev = resolve_device(cfg["device"])
    model = teaug.build_model(cfg)
    _, maps, _ = load_cohorts(cfg)
    n = len(maps)
    if n < cfg["batch_size"]:
        raise SystemExit(
            f"the cohort has {n} slices < batch_size {cfg['batch_size']}; "
            "reduce --batch_size (batches drop the remainder, so no step "
            "would run)")
    steps_per_epoch = n // cfg["batch_size"]
    cfg["total_steps"] = steps_per_epoch * cfg["epochs"]

    mesh = train_mesh(cfg["batch_size"], dev)
    if mesh is None:
        return dict(IDLE)
    r2_model = (teaug.build_r2_model(cfg) if cfg["G_model"] == "2U-Net"
                else None)
    step_fn, tx = teaug.make_train_step(cfg, model, r2_model, mesh)
    r2_step_fn = (teaug.make_r2_train_step(cfg, model, r2_model, tx, mesh)
                  if r2_model is not None else None)
    gen = torch.Generator().manual_seed(cfg["seed"])
    state = teaug.init_state(cfg, model, tx, gen, dev, r2_model)
    noise_gen = torch.Generator(device=dev).manual_seed(cfg["seed"])

    record = RunRecord(cfg, state, steps_per_epoch, mesh=mesh)
    rng = np.random.default_rng(0)
    epochs, stop = [], False
    try:
        for ep in range(record.start, cfg["epochs"]):
            t0 = time.perf_counter()
            for (B,) in batch_iterator((maps,), cfg["batch_size"], rng):
                B = torch.from_numpy(B)
                if rng.random() <= cfg["data_aug_p"]:
                    B = random_geometric(gen, B)
                    if cfg["FM_aug"]:
                        B = random_fm_scale(gen, B, mean=cfg["FM_mean"])
                if cfg["bip_grad"]:
                    B = bipolar_phase_row(gen, B)
                te = teaug.sample_te(gen, cfg, len(B))
                batch = shard_batch((B.contiguous(), te), mesh)
                if r2_step_fn is not None:
                    # 2U-Net: G_A2R2's step on the same batch and noise (the
                    # JAX CLI hands both steps one key), G_A2B frozen
                    replay = torch.Generator(device=dev)
                    replay.set_state(noise_gen.get_state())
                state, metrics = step_fn(state, batch, noise_gen)
                if r2_step_fn is not None:
                    state, r2m = r2_step_fn(state, batch, replay)
                    metrics.update(r2m)
                record.step(metrics)
            values = {k: float(v) for k, v in
                      metrics_to_host(metrics, mesh).items()}  # syncs
            epochs.append(dict(epoch=ep + 1, seconds=time.perf_counter() - t0,
                               steps=steps_per_epoch, **values))
            stop = record.end_epoch(ep, state)
            if stop:
                break
            record.log(f"epoch {ep + 1}/{cfg['epochs']} "
                       f"PM_loss={values['PM_loss']:.6f}")
    finally:
        record.close()
    return {"state": state, "epochs": epochs, "preempted": stop}


if __name__ == "__main__":
    main()
