"""CLI: supervised water–fat training on the card (port of
`ideal_gan_tpu/cli/train_sup.py`).

    python -m ideal_gan_tpu_torch.cli.train_sup --synthetic 16 \\
        --data_size 384 --batch_size 8 --epochs 2 [--G_model U-Net] \\
        [--out_vars PM] [--TE1 0.0014 --dTE 0.0022] --device cuda \\
        --output_base output

Trains the generator of `train.sup.build_model` (`--G_model` multi-decod
or U-Net, `--out_vars` WF, WFc, PM or WF-PM) from seeded random weights
(`--seed`) on (acquisitions, maps) pairs: `--synthetic N` slices, the HDF5
cohorts under `--dataset_dir`, or with `--DL_gen` the generated npz shards
`<DL_gen_dir>/<DL_filename>*.npz` (mag/phase maps, converted to complex
rows), with `--DL_partial_real` 2, 6 or 10 the first 64, 200 or 330 real
slices prepended. Holds out a validation split (a tenth of the slices, at
least a batch, where there are more than two batches) and evaluates its
first batch after every epoch. The run record, as in the JAX CLI
(kept by `train.common.RunRecord`): settings.yml, the `G_losses` summaries every 20
steps under summaries/train and the validation batch's under
summaries/validation, checkpoints every `--epoch_ckpt` epochs, at the end
and on SIGTERM/SIGINT ("preempted: checkpointed epoch N, exiting", exit
0) under <output_base>/<dataset>/checkpoints/, and a resume from the
latest one ("resumed from epoch N"). `--profile_dir` writes a
`torch.profiler` trace of the epochs there. Prints one `G_loss` line per
epoch. `--device` defaults to `cuda` and raises without a card; `cpu`
runs the plain PyTorch versions of the kernels.

`--bf16 1` computes the net in bfloat16 (parameters and physics float32),
`--remat 1` rematerializes its blocks in the backward, and `--microbatch
N` accumulates the gradients over chunks of N slices, each with its own
input noise (the batch must be a multiple of N).

The JAX CLI's warning about a TPU compiler crash has no counterpart on the
card; its data mesh (`data_mesh_for_batch`, `shard_batch`) is ROADMAP
Queue 1 item 8b.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import physics
from ..train import sup
from ..train.common import RunRecord, batch_iterator
from ..utils.timer import profile
from .common import load_cohorts, resolve_device, setup_experiment

# --DL_partial_real → the number of real slices prepended
_PARTIAL_REAL = {2: 64, 6: 200, 10: 330}


def load_generated(cfg):
    """The `--DL_gen` corpus as numpy (acqs, maps, te): the npz shards'
    acquisitions and mag/phase maps as complex MEBCRN rows, with
    `--DL_partial_real` real slices prepended, at the default TE train."""
    from ..data.layouts import mag_phase_to_complex_mebcrn
    from ..data.records import list_shards, mix_partial_real, read_shards
    shards = list_shards(cfg["DL_gen_dir"], prefix=cfg["DL_filename"])
    if not shards:
        raise FileNotFoundError(
            f"no generated shards '{cfg['DL_filename']}*.npz' in "
            f"{cfg['DL_gen_dir']}")
    acqs, maps = read_shards(shards)
    maps = mag_phase_to_complex_mebcrn(torch.from_numpy(maps)).numpy()
    if cfg["DL_partial_real"] > 0:
        r_acqs, r_maps, _ = load_cohorts(cfg)
        acqs, maps = mix_partial_real(
            acqs, maps, r_acqs, r_maps,
            _PARTIAL_REAL.get(cfg["DL_partial_real"], 0))
    te = physics.te_train(acqs.shape[1], bs=len(acqs)).numpy()
    return acqs, maps, te


def _to(dev, batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in batch)


def main(argv=None) -> dict:
    """Runs the training; returns {"state": SupState, "epochs": [{"epoch",
    "seconds", "steps", metric: value, ..., "val": {metric: value} or
    None}], "preempted": bool}, one entry per epoch run (the metrics of its
    last step, the wall time of the epoch's steps ending in a
    synchronisation)."""
    cfg = setup_experiment({**sup.DEFAULTS, "DL_gen_dir": ""}, argv)
    dev = resolve_device(cfg["device"])
    acqs, maps, te = (load_generated(cfg) if cfg["DL_gen"]
                      else load_cohorts(cfg))
    # the net takes the cohort's echoes, as the JAX package's takes its
    # input's
    model = sup.build_model(dict(cfg, n_echoes=acqs.shape[1]))
    # a validation split where there are more than two batches
    bs = cfg["batch_size"]
    n_val = max(len(acqs) // 10, bs) if len(acqs) > 2 * bs else 0
    val = (acqs[:n_val], maps[:n_val], te[:n_val]) if n_val else None
    acqs, maps, te = acqs[n_val:], maps[n_val:], te[n_val:]
    n = len(acqs)
    if n < bs:
        raise SystemExit(
            f"the training split has {n} slices < batch_size {bs}; reduce "
            "--batch_size (batches drop the remainder, so no step would "
            "run)")
    steps_per_epoch = n // bs
    cfg["total_steps"] = steps_per_epoch * cfg["epochs"]

    step_fn, tx = sup.make_train_step(cfg, model)
    eval_fn = sup.make_eval_step(cfg, model)
    gen = torch.Generator().manual_seed(cfg["seed"])
    state = sup.init_state(cfg, model, tx, gen, dev)
    noise_gen = torch.Generator(device=dev).manual_seed(cfg["seed"])

    record = RunRecord(cfg, state, steps_per_epoch, val=val is not None)
    rng = np.random.default_rng(0)
    epochs, stop = [], False
    try:
        with profile(cfg["profile_dir"] or None):
            for ep in range(record.start, cfg["epochs"]):
                t0 = time.perf_counter()
                for batch in batch_iterator((acqs, maps, te), bs, rng,
                                            shuffle=cfg["shuffle"]):
                    state, metrics = step_fn(state, _to(dev, batch),
                                             noise_gen)
                    record.step(metrics)
                values = {k: float(v) for k, v in metrics.items()}  # syncs
                seconds = time.perf_counter() - t0
                vals = None
                if val is not None:
                    vb = _to(dev, (v[:bs] for v in val))
                    vmetrics = eval_fn(state, vb, noise_gen)
                    record.validation(vmetrics)
                    vals = {k: float(v) for k, v in vmetrics.items()}
                epochs.append(dict(epoch=ep + 1, seconds=seconds,
                                   steps=steps_per_epoch, **values, val=vals))
                stop = record.end_epoch(ep, state)
                if stop:
                    break
                print(f"epoch {ep + 1}/{cfg['epochs']} "
                      f"G_loss={values['G_loss']:.5f}"
                      + (f" val_G_loss={vals['G_loss']:.5f}" if vals else ""))
    finally:
        record.close()
    return {"state": state, "epochs": epochs, "preempted": stop}


if __name__ == "__main__":
    main()
