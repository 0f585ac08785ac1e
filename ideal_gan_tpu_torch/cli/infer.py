"""CLI: bulk inference on the card — cohort in, quantitative maps out (port of
`ideal_gan_tpu/cli/infer.py`, VET-Net, AI-DEAL, Mag and the supervised
nets, npz and PNG export).

    python -m ideal_gan_tpu_torch.cli.infer [--model_sel VET-Net] \\
        [--experiment_dir output/TEaug-300] [--synthetic 16] \\
        [--dataset_dir ../datasets/] --data_size 384 --infer_batch 8 \\
        --export npz --seed 0 --output_base output \\
        [--weights flax_params.npz] [--device cuda]

Runs the selected model family in fixed-shape chunks of `--infer_batch`
slices on `--device` (default `cuda`; `cpu` runs the plain PyTorch versions
of the kernels):
- `--model_sel VET-Net` (the default, as in the JAX package): the
  TE-conditioned net on the echoes and the TE vector, then the
  phase-constrained map fit;
- `--model_sel AI-DEAL`: the field-map generators and the map fit (with
  `--map PDFF-var`, the GLS fit of `physics.pdff_uncertainty` under the
  heads' posteriors, `--rem_R2` dropping R2*);
- `--model_sel Mag`: the magnitude R2* UNet and the magnitude fit;
- `--model_sel 2D-Net`: the supervised PM U-Net on the legacy echoes, its
  (R2*, (FM − 0.5)·2), then the map fit;
- `--model_sel U-Net` or `MDWF`: the supervised net's |W|, |F| (and with
  four channels R2*, FM) as maps, no fit.
Weights come from `--weights` (Flax parameters), or from the experiment a
port trainer wrote (`--experiment_dir`: its settings and newest
checkpoint), or else from a seeded random initialization (`--seed`, with a
printed line). The cohort is `--synthetic N` slices, or else the HDF5
cohorts under `--dataset_dir`. `--export` (comma list) writes, under
<output_base>/<dataset>/: `npz` maps_pred.npz (maps MEBCRN + pdff/r2s/field
planes), `dicom` out_dicom/Volunteer-NNN/{PDFF,R2s}/ (one single-slice
series per slice, `data.dicom.write_map_series`: PDFF and the normalized
R2* clipped to [0, 1], ×255 as uint16, PatientName
Volunteer^NNN^-`--method_prefix`), `png` panels.png (PDFF | R2* | field
rows for `--n_plot` slices; matplotlib, which the port does not depend
on). Prints the
steady-state throughput measured after a warm-up chunk, and the padding's
share of the slices it computed (the last chunk's repeated slices: choose
`--infer_batch` by both). `--map` PDFF, R2s
and Water serve the same maps; with PDFF-var the maps' ρ is the GLS estimate, and the
covariance `rho_var` is computed and discarded, as the JAX CLI discards it.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from ..data.dicom import write_map_series
from ..eval.roi import maps_to_display
from ..physics.constants import FM_SC, R2_SC
from .common import load_cohorts, resolve_device, setup_experiment
from .roi_analysis import SERVED, _per_slice, make_infer_run

EXPORT_FORMATS = ("npz", "dicom", "png")

DEFAULTS = dict(
    dataset="infer", experiment_dir="", model_sel="VET-Net", map="PDFF",
    n_echoes=6, field=1.5, infer_batch=8, export="npz", weights="",
    rem_R2=False, n_plot=4, method_prefix="m000",
)


def export_npz(out_dir: Path, maps: np.ndarray, slices_per_s: float):
    pdff, r2s, _ = maps_to_display(maps)
    path = out_dir / "maps_pred.npz"
    np.savez_compressed(
        path, maps=maps, pdff=pdff, r2s_hz=r2s * R2_SC,
        field_hz=maps[:, 2, ..., 0] * FM_SC,
        slices_per_s=np.float32(slices_per_s))
    return path


def export_dicom(out_dir: Path, cfg, maps: np.ndarray):
    """out_dicom/Volunteer-NNN/{PDFF,R2s}/: slice NNN's PDFF and R2*, the
    JAX CLI's convention."""
    pdff, r2s, _ = maps_to_display(maps)
    for j in range(len(pdff)):
        write_map_series(out_dir / "out_dicom" / f"Volunteer-{j:03d}",
                         j, pdff[j], r2s[j], cfg["method_prefix"])
    return out_dir / "out_dicom"


def export_png(out_dir: Path, cfg, maps: np.ndarray):
    """panels.png: PDFF, R2* (Hz) and field (Hz) rows of the first
    `n_plot` slices, as the JAX CLI draws them."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    pdff, r2s, _ = maps_to_display(maps)
    field = maps[:, 2, ..., 0]
    n = min(int(cfg["n_plot"]), len(pdff))
    fig, axes = plt.subplots(3, n, figsize=(3 * n, 9), squeeze=False)
    rows = [("PDFF", pdff, 0.0, 1.0, "viridis"),
            ("R2* (Hz)", r2s * R2_SC, 0.0, R2_SC, "magma"),
            ("field (Hz)", field * FM_SC, -FM_SC / 2, FM_SC / 2, "RdBu_r")]
    for r, (name, stack, vmin, vmax, cmap) in enumerate(rows):
        for c in range(n):
            ax = axes[r][c]
            im = ax.imshow(stack[c], vmin=vmin, vmax=vmax, cmap=cmap)
            ax.set_axis_off()
            if c == 0:
                ax.set_title(name, loc="left")
        fig.colorbar(im, ax=axes[r][-1], fraction=0.046)
    fig.tight_layout()
    path = out_dir / "panels.png"
    fig.savefig(path, dpi=100)
    plt.close(fig)
    return path


def main(argv=None):
    cfg = setup_experiment(DEFAULTS, argv, settings_name="infer.yml")
    out_dir = Path(cfg["output_dir"])
    exports = [e.strip() for e in str(cfg["export"]).split(",") if e.strip()]
    unknown = sorted(set(exports) - set(EXPORT_FORMATS))
    if unknown:
        raise SystemExit(f"unknown --export format(s) {unknown}; "
                         f"choose from {', '.join(EXPORT_FORMATS)}")
    dev = resolve_device(cfg["device"])
    acqs, _, te = load_cohorts(cfg)
    print(f"inference: {len(acqs)} slices, model {cfg['model_sel']}, "
          f"batch {cfg['infer_batch']}, device {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))

    # build the models once; the warm-up chunk pays the kernels' build and
    # first launches so the timed pass measures steady-state serving
    run = make_infer_run(cfg, acqs, dev)
    bs = max(int(cfg["infer_batch"]), 1)
    nw = min(bs, len(acqs))
    _per_slice(run, acqs[:nw], te[:nw], bs, dev)
    before = dataclasses.replace(SERVED)
    t0 = time.perf_counter()
    maps, _ = _per_slice(run, acqs, te, bs, dev)
    dt = time.perf_counter() - t0
    padded = (SERVED - before).padded_share
    slices_per_s = len(acqs) / max(dt, 1e-9)

    written = []
    if "npz" in exports:
        written.append(export_npz(out_dir, maps, slices_per_s))
    if "dicom" in exports:
        written.append(export_dicom(out_dir, cfg, maps))
    if "png" in exports:
        written.append(export_png(out_dir, cfg, maps))
    pdff, r2s, _ = maps_to_display(maps)
    print(f"throughput: {slices_per_s:.1f} slices/s steady-state "
          f"({dt * 1e3 / len(acqs):.1f} ms/slice; padding "
          f"{100 * padded:.1f} % of the computed slices)")
    print(f"PDFF mean {float(pdff.mean()):.4f}  "
          f"R2* mean {float(r2s.mean() * R2_SC):.2f} Hz")
    for p in written:
        print(f"wrote {p}")
    return maps


if __name__ == "__main__":
    main()
