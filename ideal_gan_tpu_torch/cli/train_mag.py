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
magnitude fit, the loss of `train.mag.make_loss_fn`). Checkpoints every
`--epoch_ckpt` epochs and at the end under
<output_base>/<dataset>/checkpoints/, and resumes from the latest one.
Prints one `G_loss` line per epoch. `--device` defaults to `cuda` and
raises without a card; `cpu` runs the plain PyTorch versions of the
kernels.

`--bf16 1` computes the nets in bfloat16 (the ConvLSTM kernels' bf16
storage mode; parameters and physics float32) and `--remat 1`
rematerializes their blocks in the backward.

Not ported yet (ROADMAP Queue 1 item 7b): tensorboardX summaries and the
preemption guard are skipped with a printed note.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..train import mag
from ..train.common import batch_iterator
from ..utils import Checkpoint
from .common import load_cohorts, resolve_device, setup_experiment

_SKIPPED = ("summaries (tensorboardX) and the preemption guard are not "
            "ported yet (ROADMAP Queue 1 item 7b): skipped")


def main(argv=None) -> dict:
    """Runs the training; returns {"state": MagState, "epochs": [{"epoch",
    "seconds", "steps", metric: value, ...}]}, one entry per epoch run (the
    metrics of its last step, the wall time of the epoch ending in a
    synchronisation)."""
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
        for B, te_b in batch_iterator((maps, te), cfg["batch_size"], rng):
            state, metrics = step_fn(state, (torch.from_numpy(B).to(dev),
                                             torch.from_numpy(te_b).to(dev)))
        values = {k: float(v) for k, v in metrics.items()}  # synchronises
        epochs.append(dict(epoch=ep + 1, seconds=time.perf_counter() - t0,
                           steps=steps_per_epoch, **values))
        if (ep + 1) % cfg["epoch_ckpt"] == 0 or ep + 1 == cfg["epochs"]:
            ckpt.save(ep + 1, state.state_dict())
        print(f"epoch {ep + 1}/{cfg['epochs']} "
              f"G_loss={values['G_loss']:.6f}")
    return {"state": state, "epochs": epochs}


if __name__ == "__main__":
    main()
