"""CLI: PI-VAE/GAN training on the card (port of
`ideal_gan_tpu/cli/train_gan.py`).

    python -m ideal_gan_tpu_torch.cli.train_gan --synthetic 16 \\
        --data_size 192 --adv_train 1 --epochs 2 --device cuda \\
        --output_base output

Trains the encoder, the three decoders (and with `--VQ_encoder 1` the
codebook) from seeded random weights (`--seed`) at the JAX `DEFAULTS` (F=36,
4 levels, 2 residual blocks, latent 258, the VGG perceptual cycle) on the
cohort (`--synthetic N` slices, or else the HDF5 cohorts under
`--dataset_dir`), its maps taken to the mag/phase rows (`--unwrap`): one
g-step per shuffled batch, and with `--adv_train 1` then
`--critic_train_steps` d-steps of the spectral-norm PatchGAN (`--cGAN 1`
its conditional form) with R1 on the batch and the generated echoes
passed through the replay pool (`--pool_size`; none with `--rand_ne`).
`--rand_ne 1` cuts each batch to 3–6 echoes and `--rand_ph_offset 1` adds a
global phase offset to it, as the JAX CLI does. The run record, as in the
JAX CLI (`train.common.RunRecord`): settings.yml, the `G_losses` summaries
(G and D metrics) every 20 steps under summaries/train, checkpoints every
`--epoch_ckpt` epochs, at the end and on SIGTERM/SIGINT ("preempted:
checkpointed epoch N, exiting", exit 0), and a resume from the latest one
("resumed from epoch N"). Prints one `G_loss` line per epoch. `--device`
defaults to `cuda` and raises without a card; `cpu` runs the plain PyTorch
versions of the kernels. `--bf16 1` computes the encoder and the decoders
in bfloat16 (the ConvLSTM kernels' bf16 storage mode). The replay pool
draws from `--seed` (the JAX pool is unseeded).

Under `python -m torch.distributed.run --nproc_per_node N` the batch splits
over the largest rank count that divides it (`parallel.data_mesh_for_batch`:
the default batch 1 trains on one rank, with a warning; the others idle).
Every rank draws the same global batches; the generated echoes are
gathered from every rank (the JAX CLI pools the global fake batch on the
host), pass through one pool in the same state on every rank, and each
rank's d-step takes its rows of the pooled batch. Rank 0 writes the run
record.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data import (ItemPool, mag_phase_maps, maps_from_mebcrn,
                    random_echo_count, random_phase_offset)
from ..parallel import shard_batch
from ..parallel.mesh import all_gather_rows, rank_rows
from ..train import gan
from ..train.common import RunRecord, batch_iterator, metrics_to_host
from .common import (IDLE, load_cohorts, resolve_device, setup_experiment,
                     train_mesh)


def main(argv=None) -> dict:
    """Runs the training; returns {"state": GANState, "epochs": [{"epoch",
    "seconds", "steps", metric: value, ...}], "preempted": bool}, one entry
    per epoch run (the metrics of its last step, G and D, the wall time of
    the epoch ending in a synchronisation)."""
    cfg = setup_experiment(gan.DEFAULTS, argv)
    dev = resolve_device(cfg["device"])
    acqs, maps, te = load_cohorts(cfg)
    legacy = maps_from_mebcrn(torch.from_numpy(maps)).numpy()
    maps_mp = mag_phase_maps(legacy, unwrap=cfg["unwrap"])
    n = len(acqs)
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
    models = gan.build_models(cfg)
    seed = cfg["seed"]
    g_step, d_step, txs = gan.make_train_steps(
        cfg, models, generator=torch.Generator(device=dev).manual_seed(seed),
        mesh=mesh)
    state = gan.init_state(cfg, models, txs,
                           torch.Generator().manual_seed(seed), dev)
    pool = ItemPool(cfg["pool_size"] * (not cfg["rand_ne"]), seed=seed)
    record = RunRecord(cfg, state, steps_per_epoch, mesh=mesh)
    rng = np.random.default_rng(0)
    offsets = torch.Generator().manual_seed(seed + 1)
    epochs, stop = [], False
    try:
        for ep in range(record.start, cfg["epochs"]):
            t0 = time.perf_counter()
            for A, B, te_b in batch_iterator((acqs, maps_mp, te),
                                             cfg["batch_size"], rng):
                if cfg["rand_ne"]:
                    ne_sel = random_echo_count(rng)
                    A, te_b = A[:, :ne_sel], te_b[:, :ne_sel]
                A, B, te_b = (torch.from_numpy(np.ascontiguousarray(x))
                              for x in (A, B, te_b))
                if cfg["rand_ph_offset"]:
                    A, B = random_phase_offset(offsets, A, B,
                                               unwrapped=cfg["unwrap"])
                A, B, te_b = shard_batch((A, B, te_b), mesh)
                state, metrics, fake = g_step(state, (A, B, te_b))
                if cfg["adv_train"]:
                    pooled = fake if not pool.pool_size else rank_rows(
                        torch.from_numpy(pool(
                            all_gather_rows(fake, mesh).cpu().numpy())),
                        mesh).to(dev)
                    for _ in range(cfg["critic_train_steps"]):
                        state, d_metrics = d_step(state, A, pooled)
                    metrics.update(d_metrics)
                record.step(metrics)
            values = {k: float(v) for k, v in
                      metrics_to_host(metrics, mesh).items()}  # syncs
            epochs.append(dict(epoch=ep + 1, seconds=time.perf_counter() - t0,
                               steps=steps_per_epoch, **values))
            stop = record.end_epoch(ep, state)
            if stop:
                break
            record.log(f"epoch {ep + 1}/{cfg['epochs']} "
                       f"G_loss={values['G_loss']:.5f}")
    finally:
        record.close()
    return {"state": state, "epochs": epochs, "preempted": stop}


if __name__ == "__main__":
    main()
