"""CLI: AI-DEAL unsupervised training on the card (port of
`ideal_gan_tpu/cli/train_unsup.py`).

    python -m ideal_gan_tpu_torch.cli.train_unsup --synthetic 16 \\
        --data_size 384 --batch_size 8 --epochs 2 --out_vars PM \\
        --device cuda --output_base output

Trains g_fm on the cycle loss (and, with `--out_vars PM`, g_r2 in a second
step per batch with g_fm frozen) from seeded random weights (`--seed`) on
the cohort (`--synthetic N` slices; with `--train_data DICOM` or `NIFTI`
the scanner series of every subject folder under `--dataset_dir`; or else
the HDF5 cohorts there), with the k-fold split, `data_aug_p`, `remove_ech1` and
`rand_ne` of the JAX CLI. The run record, as in the JAX CLI
(kept by `train.common.RunRecord`): settings.yml, the `G_losses` summaries every 20
steps under summaries/train, checkpoints every `--epoch_ckpt` epochs, at
the end and on SIGTERM/SIGINT ("preempted: checkpointed epoch N,
exiting", exit 0, no calibration stage) under
<output_base>/<dataset>/checkpoints/, and a resume from the latest one
("resumed from epoch N"). Prints one `cycle_loss` line per epoch.
`--device` defaults to `cuda` and raises without a card; `cpu` runs the
plain PyTorch versions of the kernels.

Uncertainty: `--UQ 1` gives g_fm a Normal posterior head and trains it on
the heteroscedastic cycle loss, `--UQ_R2s 1` gives g_r2 a Rician head.
`--UQ_calib 1` (with `--UQ` or `--UQ_R2s`; SystemExit without) holds the
tail of the training fold out as a calibration split of
min(max(n // 5, batch), n − batch) slices (the stage is skipped with a
printed line where that is < 2); after training, with both nets frozen,
the per-echo calibration scale takes `--epochs` epochs of SGD steps on it,
the split's first quarter held out, and the run prints
`calibration: held-out NLL a → b, calib=[...]` and checkpoints at epoch
`epochs + 1`.

`--bf16 1` computes the nets in bfloat16 (the ConvLSTM kernels' bf16
storage mode; parameters and physics float32) and `--remat 1`
rematerializes their blocks in the backward.

On N cards, one process each:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m ideal_gan_tpu_torch.cli.train_unsup ...

Every rank draws the same global batches (the same seeds) and trains on
its rows of each (`parallel.data_mesh_for_batch(batch_size)`: a batch the
rank count does not divide leaves ranks idle, with a warning); rank 0
writes the run record. The calibration stage's batches are rounded down
to a multiple of the mesh size, or go whole to every rank where they are
smaller than it, as in the JAX CLI.

The sample grid PNGs are skipped with a printed note:
`eval.samples.save_sample_grid` is ported, but matplotlib is not a
dependency of the port.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data import random_echo_count, random_geometric
from ..parallel import replicate, shard_batch
from ..train import unsup
from ..train.common import RunRecord, batch_iterator, metrics_to_host
from .. import physics
from ..data import load_dicom_series, load_nifti_series
from .common import (IDLE, load_cohorts, resolve_device, setup_experiment,
                     train_mesh)

_SKIPPED = ("the sample grid PNGs (samples_training/iter-*.png) are skipped: "
            "matplotlib is not a dependency of the port")


def _load_series_folders(cfg):
    """The cohort from scanner folders (reference
    train-IDEAL-unsup.py:124-156): one MECSE DICOM series
    (`load_dicom_series`) or BIDS NIfTI set (`load_nifti_series`) per
    subject folder of `dataset_dir`, in sorted order, slices concatenated;
    the 1.5 T TE train for every slice and zero maps. Returns numpy (acqs,
    maps, te)."""
    loader = (load_dicom_series if cfg["train_data"] == "DICOM"
              else load_nifti_series)
    folders = sorted(os.path.join(cfg["dataset_dir"], d)
                     for d in os.listdir(cfg["dataset_dir"])
                     if os.path.isdir(os.path.join(cfg["dataset_dir"], d)))
    acqs = np.concatenate([loader(f) for f in folders])
    te = physics.te_train(acqs.shape[1], bs=len(acqs)).numpy()
    maps = np.zeros((len(acqs), 3) + acqs.shape[2:4] + (2,), np.float32)
    return acqs, maps, te


def main(argv=None) -> dict:
    """Runs the training; returns {"state": UnsupState, "epochs": [{"epoch",
    "seconds", "steps", metric: value, ...}]}, one entry per epoch run (the
    metrics of its last step, the wall time of the epoch ending in a
    synchronisation), "preempted": bool, "cohort": the numpy (acqs, te) of
    the training fold, and with the calibration stage "calibration":
    {"nll_before", "nll_after", "calib", "steps", "seconds"}."""
    cfg = setup_experiment({**unsup.DEFAULTS, "train_data": "HDF5",
                            "k_fold": 0, "k_folds_total": 5}, argv)
    dev = resolve_device(cfg["device"])
    if cfg["train_data"] in ("DICOM", "NIFTI"):
        acqs, _, te = _load_series_folders(cfg)
    else:
        acqs, _, te = load_cohorts(cfg)
    # k-fold split over the cohort: fold k held out for validation
    if cfg["k_fold"] > 0:
        k = cfg["k_fold"] - 1
        fold_sz = max(len(acqs) // cfg["k_folds_total"], 1)
        val_idx = np.arange(k * fold_sz, min((k + 1) * fold_sz, len(acqs)))
        train_idx = np.setdiff1d(np.arange(len(acqs)), val_idx)
        acqs, te = acqs[train_idx], te[train_idx]
    if cfg["UQ_calib"] and not (cfg["UQ"] or cfg["UQ_R2s"]):
        # without a Bayesian head the propagated variance is zero: var_mse
        # floors it and the scale's gradient through the floor is zero
        raise SystemExit("--UQ_calib requires --UQ (or --UQ_R2s): the "
                         "calibration stage trains a scale on the "
                         "propagated variance, which is zero without a "
                         "Bayesian head")
    calib_data = None
    if cfg["UQ_calib"]:
        # a calibration split from the tail of the training fold, leaving
        # at least one training batch and ≥ 2 calibration slices (the stage
        # holds one fraction out for the NLL report)
        n_cal = min(max(len(acqs) // 5, cfg["batch_size"]),
                    len(acqs) - cfg["batch_size"])
        if n_cal < 2:
            print("UQ_calib: cohort too small for a calibration split "
                  f"({len(acqs)} slices, batch {cfg['batch_size']}) — "
                  "skipping the calibration stage")
            cfg["UQ_calib"] = False
        else:
            calib_data = (acqs[-n_cal:], te[-n_cal:])
            acqs, te = acqs[:-n_cal], te[:-n_cal]
    n = len(acqs)
    if n < cfg["batch_size"]:
        raise SystemExit(
            f"training fold has {n} slices < batch_size "
            f"{cfg['batch_size']}; reduce --batch_size (batches drop the "
            "remainder, so no step would run)")
    steps_per_epoch = max(n // cfg["batch_size"], 1)
    cfg["total_steps"] = steps_per_epoch * cfg["epochs"]

    mesh = train_mesh(cfg["batch_size"], dev)
    if mesh is None:
        return dict(IDLE)
    g_fm, g_r2 = unsup.build_models(cfg)
    step_fn, tx = unsup.make_train_step(cfg, g_fm, g_r2, mesh)
    r2_step_fn = unsup.make_r2_train_step(cfg, g_fm, g_r2, tx, mesh)
    gen = torch.Generator().manual_seed(cfg["seed"])
    state = unsup.init_state(cfg, g_fm, g_r2, tx, gen, dev, mesh)

    record = RunRecord(cfg, state, steps_per_epoch, mesh=mesh)
    record.log(_SKIPPED)
    rng = np.random.default_rng(0)
    epochs, stop = [], False
    try:
        for ep in range(record.start, cfg["epochs"]):
            t0 = time.perf_counter()
            for (A, te_b) in batch_iterator((acqs, te), cfg["batch_size"],
                                            rng):
                A = torch.from_numpy(A)
                # host-side geometric aug + random echo truncation
                if rng.random() <= cfg["data_aug_p"]:
                    A = random_geometric(gen, A)
                if cfg["remove_ech1"]:
                    A, te_b = A[:, 1:], te_b[:, 1:]
                if cfg["rand_ne"]:
                    ne_sel = random_echo_count(rng)
                    A, te_b = A[:, :ne_sel], te_b[:, :ne_sel]
                batch = shard_batch((A.contiguous(),
                                     np.ascontiguousarray(te_b)), mesh)
                state, metrics = step_fn(state, batch)
                if cfg["out_vars"] == "PM":
                    state, r2m = r2_step_fn(state, batch)
                    metrics.update(r2m)
                record.step(metrics)
            values = {k: float(v) for k, v in
                      metrics_to_host(metrics, mesh).items()}  # syncs
            epochs.append(dict(epoch=ep + 1, seconds=time.perf_counter() - t0,
                               steps=steps_per_epoch, **values))
            stop = record.end_epoch(ep, state)
            if stop:
                break
            record.log(f"epoch {ep + 1}/{cfg['epochs']} cycle_loss="
                       f"{values['A2B2A_cycle_loss']:.6f}")
    finally:
        record.close()
    out = {"state": state, "epochs": epochs, "preempted": stop,
           "cohort": (acqs, te)}
    if calib_data is not None and not stop:
        out["calibration"] = _calibrate(cfg, g_fm, g_r2, state, calib_data,
                                        rng, mesh, record.log)
        record.save(cfg["epochs"] + 1, state)
    return out


def _calibrate(cfg, g_fm, g_r2, state, calib_data, rng, mesh,
               log=print) -> dict:
    """The σ-calibration stage: the first quarter of the split (at least
    one slice, leaving one) held out for the NLL report (on every rank),
    `epochs` epochs of calibration steps on the rest in batches of
    min(batch_size, its length), rounded down to a multiple of the mesh
    size and split over it, or where that is smaller than the mesh, whole
    on every rank (the JAX CLI's rule); prints and returns the held-out NLL
    before and after and the scale."""
    cal_acqs, cal_te = calib_data
    calib_step = unsup.make_calib_train_step(cfg, g_fm, g_r2)
    nll_fn = unsup.eval_calibrated_nll(cfg, g_fm, g_r2)
    n_hold = min(max(len(cal_acqs) // 4, 1), len(cal_acqs) - 1)
    hold = replicate(mesh)((cal_acqs[:n_hold], cal_te[:n_hold]))
    fit = (cal_acqs[n_hold:], cal_te[n_hold:])
    cal_bs = min(cfg["batch_size"], len(fit[0]))
    if cal_bs >= mesh.size:
        cal_bs = (cal_bs // mesh.size) * mesh.size
        place = lambda b: shard_batch(b, mesh)  # noqa: E731
    else:
        place = replicate(mesh)
    t0 = time.perf_counter()
    nll0 = float(nll_fn(state, *hold))
    steps = 0
    for _ in range(cfg["epochs"]):
        for A, te_b in batch_iterator(fit, cal_bs, rng):
            state, _ = calib_step(state, place((A, te_b)))
            steps += 1
    nll1 = float(nll_fn(state, *hold))
    calib = state.calib.detach().cpu().numpy()
    log(f"calibration: held-out NLL {nll0:.5f} → {nll1:.5f}, "
        f"calib={calib}")
    return dict(nll_before=nll0, nll_after=nll1, calib=calib.tolist(),
                steps=steps, seconds=time.perf_counter() - t0)


if __name__ == "__main__":
    main()
