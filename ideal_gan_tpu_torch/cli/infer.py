"""CLI: bulk inference on the card — cohort in, quantitative maps out (port of
`ideal_gan_tpu/cli/infer.py`, AI-DEAL, npz export).

    python -m ideal_gan_tpu_torch.cli.infer --model_sel AI-DEAL \\
        --synthetic 16 --data_size 384 --infer_batch 8 --export npz \\
        --seed 0 --output_base output [--weights flax_params.npz] \\
        [--device cuda]

Runs the AI-DEAL generators and the map fit in fixed-shape chunks of
`--infer_batch` slices on `--device` (default `cuda`; `cpu` runs the plain
PyTorch versions of the kernels), writes <output_base>/<dataset>/
maps_pred.npz (maps MEBCRN + pdff/r2s/field planes) and prints the
steady-state throughput measured after a warm-up chunk. PNG and DICOM
export are not ported yet.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..physics.constants import FM_SC, R2_SC
from .common import load_cohorts, resolve_device, setup_experiment
from .roi_analysis import _per_slice, make_infer_run

EXPORT_FORMATS = ("npz",)

DEFAULTS = dict(
    dataset="infer", model_sel="AI-DEAL", map="PDFF",
    n_echoes=6, field=1.5, infer_batch=8, export="npz", weights="",
)


def maps_to_display(maps: np.ndarray):
    """MEBCRN maps (n, 3, H, W, 2) → (PDFF, R2*, |W|) stacks; PDFF =
    |F| / |W + F| (the JAX package's `eval.roi.maps_to_display`)."""
    w = maps[:, 0, ..., 0] + 1j * maps[:, 0, ..., 1]
    f = maps[:, 1, ..., 0] + 1j * maps[:, 1, ..., 1]
    f_abs = np.abs(f)
    tot = np.abs(w + f)
    pdff = np.divide(f_abs, tot, out=np.zeros_like(f_abs), where=tot != 0)
    return pdff, maps[:, 2, ..., 1], np.abs(w)


def export_npz(out_dir: Path, maps: np.ndarray, slices_per_s: float):
    pdff, r2s, _ = maps_to_display(maps)
    path = out_dir / "maps_pred.npz"
    np.savez_compressed(
        path, maps=maps, pdff=pdff, r2s_hz=r2s * R2_SC,
        field_hz=maps[:, 2, ..., 0] * FM_SC,
        slices_per_s=np.float32(slices_per_s))
    return path


def main(argv=None):
    cfg = setup_experiment(DEFAULTS, argv, settings_name="infer.json")
    out_dir = Path(cfg["output_dir"])
    exports = [e.strip() for e in str(cfg["export"]).split(",") if e.strip()]
    unknown = sorted(set(exports) - set(EXPORT_FORMATS))
    if unknown:
        raise SystemExit(f"--export {unknown} not available: the port "
                         f"writes {', '.join(EXPORT_FORMATS)} (PNG and DICOM "
                         "are not ported yet)")
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
    t0 = time.perf_counter()
    maps, _ = _per_slice(run, acqs, te, bs, dev)
    dt = time.perf_counter() - t0
    slices_per_s = len(acqs) / max(dt, 1e-9)

    written = []
    if "npz" in exports:
        written.append(export_npz(out_dir, maps, slices_per_s))
    pdff, r2s, _ = maps_to_display(maps)
    print(f"throughput: {slices_per_s:.1f} slices/s steady-state "
          f"({dt * 1e3 / len(acqs):.1f} ms/slice)")
    print(f"PDFF mean {float(pdff.mean()):.4f}  "
          f"R2* mean {float(r2s.mean() * R2_SC):.2f} Hz")
    for p in written:
        print(f"wrote {p}")
    return maps


if __name__ == "__main__":
    main()
