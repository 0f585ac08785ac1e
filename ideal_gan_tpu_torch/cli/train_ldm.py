"""CLI: latent diffusion on the frozen PI-VAE latents (port of
`ideal_gan_tpu/cli/train_ldm.py`).

    python -m ideal_gan_tpu_torch.cli.train_ldm --experiment_dir \\
        output/WF-IDEAL --synthetic 16 --epochs 2 --device cuda

Reads the GAN run's settings (`<experiment_dir>/settings.yml`, backfilled
with the GAN `DEFAULTS`) and its newest checkpoint (the encoder, the
decoders and the codebook; a run without one starts from seeded random
weights, "restored PI-VAE checkpoint" otherwise), loads that run's cohort
(`--synthetic N` slices at its `data_size`, or the HDF5 cohorts of
`--dataset_dir`), computes the global latent std z_std of the frozen
encoder's posterior mean (the plain latent in VQ mode) in one pass, sets
`in_res` from the latent's side, and trains the denoiser at the LDM
`DEFAULTS` (T=200, linear β, F=64, dim_mults (1, 2, 4), batch 8, Adam 1e-4)
on the ε-MSE, with `--class_cond 1` on the labels of `--labels_file` (xlsx
through `eval.export.read_xlsx`, or CSV; first column, one grade a slice,
zeros where missing). Writes settings_ldm.yml and the `LDM` summaries
(summaries/train_ldm, every 20 steps) under `<output_base>/<dataset>`, and
`<experiment_dir>/checkpoints_ldm/` (the state and z_std) every
`--epoch_ckpt` epochs, at the end and on SIGTERM/SIGINT ("preempted:
checkpointed epoch N, exiting", exit 0); a rerun resumes from the newest
("resumed from epoch N"), z_std included. Prints "z_std = …" and one
`eps_mse` line per epoch. `--device` defaults to `cuda` and raises without
a card; `cpu` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..train import gan
from ..train import ldm
from ..train.common import RunRecord, batch_iterator
from .common import load_cohorts, load_settings, resolve_device, \
    setup_experiment


def read_labels(path: str, n: int) -> np.ndarray:
    """The first column of a label sheet (xlsx or CSV with a header row),
    cut or zero-padded to `n` int32 labels."""
    if path.endswith(".xlsx"):
        from ..eval.export import read_xlsx
        sheet = next(iter(read_xlsx(path).values()))
        vals = [r[0] for r in sheet[1:] if r and r[0] is not None]
    else:
        vals = np.loadtxt(path, delimiter=",", skiprows=1, usecols=0,
                          ndmin=1)
    labels = np.asarray(vals, np.int32)[:n]
    return np.pad(labels, (0, n - len(labels)))


def main(argv=None) -> dict:
    """Runs the training; returns {"state": LDMState, "z_std": float,
    "epochs": [{"epoch", "seconds", "steps", "loss"}], "preempted":
    bool}."""
    cfg = setup_experiment({**ldm.DEFAULTS, "dataset": "WF-IDEAL",
                            "labels_file": ""}, argv,
                           settings_name="settings_ldm.yml")
    dev = resolve_device(cfg["device"])
    gan_cfg = load_settings(cfg["experiment_dir"]).backfill(gan.DEFAULTS)
    acqs, _, _ = load_cohorts(gan_cfg.overlay(
        {"synthetic": cfg["synthetic"], "dataset_dir": cfg["dataset_dir"]}))
    bs = max(cfg["batch_size"], 1)
    if len(acqs) < bs:
        raise SystemExit(
            f"the cohort has {len(acqs)} slices < batch_size {bs}; reduce "
            "--batch_size (batches drop the remainder, so no step would run)")
    models = ldm.load_gan(gan_cfg, cfg["experiment_dir"], dev)
    encode = ldm.make_encode(models, gan_cfg["VQ_encoder"])

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    z_std = ldm.latent_std(encode, (on_card(acqs[i:i + bs])
                                     for i in range(0, len(acqs), bs)))
    print(f"z_std = {z_std:.5f}")
    z0 = encode(on_card(acqs[:1]))
    channels = z0.shape[-1]
    cfg["in_res"] = z0.shape[1]
    model = ldm.build_model(cfg, channels)
    sched = ldm.build_schedule(cfg)
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
    step_fn, tx = ldm.make_train_step(cfg, model, sched, gen)
    state = ldm.init_state(cfg, model, tx,
                           torch.Generator().manual_seed(cfg["seed"]), dev,
                           z_std)
    # the JAX CLI's layout: checkpoints beside the GAN run's, summaries
    # under this run's directory, its step count from 0 in every run
    record = RunRecord(cfg, state, 0,
                       ckpt_dir=f"{cfg['experiment_dir']}/checkpoints_ldm",
                       summary_dir=f"{cfg['output_dir']}/summaries/train_ldm",
                       summary_name="LDM")
    labels = read_labels(cfg["labels_file"], len(acqs)) \
        if cfg["labels_file"] else np.zeros((len(acqs),), np.int32)
    rng = np.random.default_rng(0)
    epochs, stop = [], False
    try:
        for ep in range(record.start, cfg["epochs"]):
            t0 = time.perf_counter()
            steps = 0
            for A, lab in batch_iterator((acqs, labels), bs, rng):
                z = encode(on_card(A)) / state.z_std
                state, metrics = step_fn(
                    state, (z, torch.from_numpy(lab).long().to(dev)))
                record.step(metrics)
                steps += 1
            loss = float(metrics["loss"])  # syncs
            epochs.append(dict(epoch=ep + 1, seconds=time.perf_counter() - t0,
                               steps=steps, loss=loss))
            stop = record.end_epoch(ep, state)
            if stop:
                break
            print(f"epoch {ep + 1}/{cfg['epochs']} eps_mse={loss:.5f}")
    finally:
        record.close()
    return {"state": state, "z_std": state.z_std, "epochs": epochs,
            "preempted": stop}


if __name__ == "__main__":
    main()
