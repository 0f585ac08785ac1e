"""CLI: multi-site phantom PDFF bias evaluation on the card, headless (port
of `ideal_gan_tpu/cli/roi_realphantom.py`).

    python -m ideal_gan_tpu_torch.cli.roi_realphantom [--synthetic 2] \\
        --model_sel GraphCuts --crops_file vials.npy [--map R2s] \\
        [--experiment_dir output/Unsup-v0] --output_base output

`--model_sel GraphCuts` (the default) fits ρ with the ground-truth (φ,
R2*) through the map fit kernel (`ops.fit_rho_fused`; the JAX CLI calls
`physics.fit_rho`); any other family serves its maps through
`roi_analysis.infer_maps`. The vial crops of `--crops_file` (ordered by
vial on each slice) are evaluated against the ground-truth fat fractions
`eval.roi.PHANTOM_GT_VALS`: per-vial bias lines (with `--map R2s` the mean
R2* per vial, no bias), the process time in total and per slice, and the
workbook `--out_xlsx` (a Phantom summary sheet and one sheet a slice)
under <output_base>/<dataset>/.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .. import ops, physics
from ..eval import roi as roi_mod
from .common import load_cohorts, resolve_device, setup_experiment

DEFAULTS = dict(
    dataset="phantom_1p5", model_sel="GraphCuts", map="PDFF", n_echoes=6,
    field=1.5, crops_file="", out_xlsx="ROI_phantom.xlsx",
    experiment_dir="", rem_R2=False, batch_size=1, weights="",
)


def fit_maps(cfg, acqs, gt_maps, te):
    """model_sel dispatch → (maps (n, ≥3, H, W, 2) numpy, process seconds).

    GraphCuts: the map fit kernel with the ground-truth (φ, R2*), the
    parity baseline. Anything else: the family's inference through
    `roi_analysis.infer_maps`."""
    t1 = time.process_time()
    if cfg["model_sel"] == "GraphCuts":
        dev = resolve_device(cfg.get("device", "cuda"))
        pm = gt_maps[:, 2:3]
        wf = ops.fit_rho_fused(
            *(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in (acqs, pm, te)), field=cfg["field"])
        maps = np.concatenate([wf.cpu().numpy(), pm], axis=1)
    else:
        from .roi_analysis import infer_maps
        maps, _ = infer_maps(cfg, acqs, te)
    return maps, time.process_time() - t1


def evaluate(cfg, acqs, gt_maps, te) -> dict:
    """The evaluation of `main` on a given cohort; returns {"maps",
    "per_vial" ({gt: [ROI medians]}), "bias" ({gt: mean − gt}),
    "per_slice", "xlsx"}."""
    maps, elapsed = fit_maps(cfg, acqs, gt_maps, te)
    print("Elapsed time during the whole program in seconds:", elapsed)
    print("Time per slice:", elapsed / max(len(acqs), 1))
    pdff, r2s, _ = roi_mod.maps_to_display(maps)
    crops_file = cfg["crops_file"] or str(
        Path("ROI_files") / f"{cfg['dataset']}_slices_crops.npy")
    if not Path(crops_file).exists():
        raise SystemExit(f"no crops file at {crops_file}")
    stack = r2s * physics.R2_SC if cfg["map"] == "R2s" else pdff
    per_vial, bias = roi_mod.phantom_bias(stack, crops_file)
    per_slice = roi_mod.phantom_per_slice(stack, crops_file)
    if cfg["map"] == "R2s":
        # the ground truth is fat fractions; for R2* they only name vials
        bias = {g: float("nan") for g in bias}
    for g in sorted(per_vial):
        if not per_vial[g]:
            continue
        if cfg["map"] == "R2s":
            print(f"vial id={g:.3f}: mean R2* "
                  f"{float(np.mean(per_vial[g])):.2f} 1/s "
                  f"({len(per_vial[g])} ROIs)")
        elif not np.isnan(bias[g]):
            print(f"vial GT={g:.3f}: bias {bias[g]:+.4f} "
                  f"({len(per_vial[g])} ROIs)")
    out = Path(cfg["output_dir"]) / cfg["out_xlsx"]
    roi_mod.export_phantom_xlsx(str(out), per_vial, bias,
                                per_slice=per_slice)
    print(f"wrote {out}")
    return dict(maps=maps, per_vial=per_vial, bias=bias, per_slice=per_slice,
                xlsx=out)


def main(argv=None) -> dict:
    cfg = setup_experiment(DEFAULTS, argv)
    if not cfg["experiment_dir"]:
        cfg["experiment_dir"] = f"output/{cfg['dataset']}"
    return evaluate(cfg, *load_cohorts(cfg))


if __name__ == "__main__":
    main()
