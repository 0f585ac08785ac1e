"""CLI: AI-DEAL unsupervised training on the card (port of
`ideal_gan_tpu/cli/train_unsup.py`).

    python -m ideal_gan_tpu_torch.cli.train_unsup --synthetic 16 \\
        --data_size 384 --batch_size 8 --epochs 2 --out_vars PM \\
        --device cuda --output_base output

Trains g_fm on the cycle loss (and, with `--out_vars PM`, g_r2 in a second
step per batch with g_fm frozen) from seeded random weights (`--seed`) on
the cohort (`--synthetic N` slices, or else the HDF5 cohorts under
`--dataset_dir`), with the k-fold split, `data_aug_p`, `remove_ech1` and
`rand_ne` of the JAX CLI; checkpoints every `--epoch_ckpt` epochs and
at the end under <output_base>/<dataset>/checkpoints/, and resumes from
the latest one.
Prints one `cycle_loss` line per epoch. `--device` defaults to `cuda` and
raises without a card; `cpu` runs the plain PyTorch versions of the kernels.

Not ported yet (ROADMAP Queue 1 items 6 and 12): DICOM/NIfTI folders
(SystemExit), UQ and the calibration stage (NotImplementedError);
tensorboardX summaries, the sample PNGs and the preemption guard are
skipped with a printed note.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data import random_echo_count, random_geometric
from ..train import unsup
from ..train.common import batch_iterator
from ..utils import Checkpoint
from .common import load_cohorts, resolve_device, setup_experiment

_SKIPPED = ("summaries (tensorboardX), sample PNGs and the preemption guard "
            "are not ported yet (ROADMAP Queue 1 item 6): skipped")


def main(argv=None) -> dict:
    """Runs the training; returns {"state": UnsupState, "epochs": [{"epoch",
    "seconds", "steps", metric: value, ...}]}, one entry per epoch run (the
    metrics of its last step, the wall time of the epoch ending in a
    synchronisation)."""
    cfg = setup_experiment({**unsup.DEFAULTS, "train_data": "HDF5",
                            "k_fold": 0, "k_folds_total": 5}, argv)
    if cfg["train_data"] in ("DICOM", "NIFTI"):
        raise SystemExit("DICOM/NIfTI training folders are not ported yet "
                         "(ROADMAP Queue 1 item 12); use --synthetic N")
    dev = resolve_device(cfg["device"])
    acqs, _, te = load_cohorts(cfg)
    # k-fold split over the cohort: fold k held out for validation
    if cfg["k_fold"] > 0:
        k = cfg["k_fold"] - 1
        fold_sz = max(len(acqs) // cfg["k_folds_total"], 1)
        val_idx = np.arange(k * fold_sz, min((k + 1) * fold_sz, len(acqs)))
        train_idx = np.setdiff1d(np.arange(len(acqs)), val_idx)
        acqs, te = acqs[train_idx], te[train_idx]
    n = len(acqs)
    if n < cfg["batch_size"]:
        raise SystemExit(
            f"training fold has {n} slices < batch_size "
            f"{cfg['batch_size']}; reduce --batch_size (batches drop the "
            "remainder, so no step would run)")
    steps_per_epoch = max(n // cfg["batch_size"], 1)
    cfg["total_steps"] = steps_per_epoch * cfg["epochs"]

    g_fm, g_r2 = unsup.build_models(cfg)
    step_fn, tx = unsup.make_train_step(cfg, g_fm, g_r2)
    r2_step_fn = unsup.make_r2_train_step(cfg, g_fm, g_r2, tx)
    gen = torch.Generator().manual_seed(cfg["seed"])
    state = unsup.init_state(cfg, g_fm, g_r2, tx, gen, dev)

    ckpt = Checkpoint(f"{cfg['output_dir']}/checkpoints")
    start = ckpt.latest_step() or 0
    if start:
        state.load_state_dict(ckpt.restore(start))
        print(f"resumed from the epoch-{start} checkpoint")
    print(_SKIPPED)

    rng = np.random.default_rng(0)
    epochs = []
    for ep in range(start, cfg["epochs"]):
        t0 = time.perf_counter()
        for (A, te_b) in batch_iterator((acqs, te), cfg["batch_size"], rng):
            A = torch.from_numpy(A)
            # host-side geometric aug + random echo truncation
            if rng.random() <= cfg["data_aug_p"]:
                A = random_geometric(gen, A)
            if cfg["remove_ech1"]:
                A, te_b = A[:, 1:], te_b[:, 1:]
            if cfg["rand_ne"]:
                ne_sel = random_echo_count(rng)
                A, te_b = A[:, :ne_sel], te_b[:, :ne_sel]
            batch = (A.contiguous().to(dev),
                     torch.from_numpy(np.ascontiguousarray(te_b)).to(dev))
            state, metrics = step_fn(state, batch)
            if cfg["out_vars"] == "PM":
                state, r2m = r2_step_fn(state, batch)
                metrics.update(r2m)
        values = {k: float(v) for k, v in metrics.items()}  # synchronises
        epochs.append(dict(epoch=ep + 1, seconds=time.perf_counter() - t0,
                           steps=steps_per_epoch, **values))
        if (ep + 1) % cfg["epoch_ckpt"] == 0 or ep + 1 == cfg["epochs"]:
            ckpt.save(ep + 1, state.state_dict())
        print(f"epoch {ep + 1}/{cfg['epochs']} cycle_loss="
              f"{values['A2B2A_cycle_loss']:.6f}")
    return {"state": state, "epochs": epochs}


if __name__ == "__main__":
    main()
