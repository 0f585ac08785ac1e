"""ROI bias evaluation pipelines (port of `ideal_gan_tpu/eval/roi.py`, the
rebuild of ROI-analysis.py / ROI-realPhantom.py, headless).

The reference's interactive matplotlib ROI picker persists crops as npy
stacks (utils.py); the committed `ROI_files/*.npy` crops make the bias
pipelines reproducible without interaction — the headless functions here
consume those files directly. ROI statistics follow the reference: PDFF is
the ROI *median*, R2*/Water the ROI *mean* (utils.py:5-15); crops are
(wdt+1)×(wdt+1) boxes anchored at (left_x, sup_y).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .export import XlsxWriter, load_crops

# Phantom ground-truth PDFF vials (ROI-realPhantom.py:321).
PHANTOM_GT_VALS = (0.0, 0.026, 0.053, 0.079, 0.105, 0.157, 0.209, 0.312,
                   0.413, 0.514, 1.0)


def roi_median(img: np.ndarray, left_x: int, sup_y: int, wdt: int = 8):
    """PDFF-style ROI statistic (reference PDFF_at_ROI, utils.py:5-9)."""
    return float(np.median(img[sup_y:sup_y + wdt + 1,
                               left_x:left_x + wdt + 1]))


def roi_mean(img: np.ndarray, left_x: int, sup_y: int, wdt: int = 8):
    """R2*-style ROI statistic (reference R2_at_ROI, utils.py:11-15)."""
    return float(np.mean(img[sup_y:sup_y + wdt + 1,
                             left_x:left_x + wdt + 1]))


def maps_to_display(maps: np.ndarray, magnitude_disc: bool = False):
    """MEBCRN maps (n, ns+1, H, W, 2) → (PDFF, R2*, |W|) display stacks.

    PDFF = |F| / |W+F| with the reference's magnitude-discrimination swap
    (when |F|>|W| the voxel fat fraction is taken as 1−PDFF_w;
    ROI-analysis.py:347-348 swap rule is approximated by the dominant-
    species rule).
    """
    w = maps[:, 0, ..., 0] + 1j * maps[:, 0, ..., 1]
    f = maps[:, 1, ..., 0] + 1j * maps[:, 1, ..., 1]
    w_abs = np.abs(w)
    f_abs = np.abs(f)
    tot = np.abs(w + f)
    pdff = np.divide(f_abs, tot, out=np.zeros_like(f_abs), where=tot != 0)
    if magnitude_disc:
        pdff_m = np.divide(f_abs, w_abs + f_abs,
                           out=np.zeros_like(f_abs),
                           where=(w_abs + f_abs) != 0)
        pdff = np.where(f_abs > w_abs, pdff_m, pdff)
    r2s = maps[:, 2, ..., 1]
    return pdff, r2s, w_abs


@dataclasses.dataclass
class ROIResult:
    slices: list
    values_1: list   # right hepatic lobe / vial ROI values
    values_2: list   # left hepatic lobe ROI values (may be empty)


def roi_stats(stack: np.ndarray, crops_file: str, stat: str = "median",
              wdt: int = 8) -> ROIResult:
    """Evaluate ROI statistics of a (n, H, W) map stack at the committed
    crops (frms, crops_1, crops_2)."""
    frms, crops_1, crops_2 = load_crops(crops_file)
    fn = roi_median if stat == "median" else roi_mean
    res = ROIResult([], [], [])
    for i, k in enumerate(frms):
        res.slices.append(int(k))
        res.values_1.append(fn(stack[int(k)], int(crops_1[i][0]),
                               int(crops_1[i][1]), wdt))
        # crops_2 is parallel to crops_1 with a (-1, -1) sentinel for
        # 1-ROI slices (eval.tracker.NO_ROI); negative corners are skipped.
        if len(crops_2) > i and int(crops_2[i][0]) >= 0 \
                and int(crops_2[i][1]) >= 0:
            res.values_2.append(fn(stack[int(k)], int(crops_2[i][0]),
                                   int(crops_2[i][1]), wdt))
    return res


def phantom_bias(pdff_stack: np.ndarray, crops_file: str,
                 gt_vals: Sequence[float] = PHANTOM_GT_VALS, wdt: int = 8):
    """Per-vial PDFF bias vs the known phantom ground truth
    (ROI-realPhantom.py:321-360): ROIs of each slice are ordered by vial;
    returns {vial_gt: [measured...]}, and the per-vial mean bias."""
    frms, crops_1, _ = load_crops(crops_file)
    per_vial: dict[float, list[float]] = {g: [] for g in gt_vals}
    n_slices = int(frms.max()) + 1 if len(frms) else 0
    for k in range(n_slices):
        idxs = [i for i, x in enumerate(frms) if x == k]
        for vial_pos, i in enumerate(idxs):
            if vial_pos >= len(gt_vals):
                break
            lx, sy = int(crops_1[i][0]), int(crops_1[i][1])
            val = roi_median(pdff_stack[k], lx, sy, wdt)
            per_vial[gt_vals[vial_pos]].append(val)
    bias = {g: (float(np.mean(v) - g) if v else np.nan)
            for g, v in per_vial.items()}
    return per_vial, bias


def phantom_per_slice(pdff_stack: np.ndarray, crops_file: str,
                      gt_vals: Sequence[float] = PHANTOM_GT_VALS,
                      wdt: int = 8) -> dict:
    """Per-slice (GT, measured) pairs for the per-slice worksheet export."""
    frms, crops_1, _ = load_crops(crops_file)
    out: dict[int, list] = {}
    n_slices = int(frms.max()) + 1 if len(frms) else 0
    for k in range(n_slices):
        idxs = [i for i, x in enumerate(frms) if x == k]
        pairs = []
        for vial_pos, i in enumerate(idxs):
            if vial_pos >= len(gt_vals):
                break
            lx, sy = int(crops_1[i][0]), int(crops_1[i][1])
            pairs.append((gt_vals[vial_pos],
                          roi_median(pdff_stack[k], lx, sy, wdt)))
        if pairs:
            out[k] = pairs
    return out


def export_roi_xlsx(path: str, res_model: ROIResult, res_ref: ROIResult,
                    map_name: str = "PDFF") -> None:
    """Two-sheet (RHL/LHL) workbook matching the reference's layout
    (ROI-analysis.py:419-567): per-slice reference vs model values."""
    wb = XlsxWriter(path)
    for sheet, vals_m, vals_r in (
            ("RHL", res_model.values_1, res_ref.values_1),
            ("LHL", res_model.values_2, res_ref.values_2)):
        ws = wb.add_worksheet(sheet)
        ws.write_row(0, ["Slice", f"Reference {map_name}",
                         f"Model {map_name}", "Bias"])
        for i, (m, r) in enumerate(zip(vals_m, vals_r)):
            sl = res_model.slices[i] if i < len(res_model.slices) else i
            ws.write_row(i + 1, [sl, r, m, m - r])
    wb.close()


def export_phantom_xlsx(path: str, per_vial: dict, bias: dict,
                        per_slice: dict | None = None) -> None:
    """Phantom workbook: a summary sheet (GT/mean/bias per vial) plus
    optional per-slice sheets matching the reference layout
    (ROI-realPhantom.py:344-360: Slice_<k> sheets with
    Ground-truth / Reference / Model-result columns)."""
    wb = XlsxWriter(path)
    ws = wb.add_worksheet("Phantom")
    ws.write_row(0, ["Ground-truth", "Mean measured", "Bias", "N"])
    for i, (g, vals) in enumerate(sorted(per_vial.items())):
        mean_v = float(np.mean(vals)) if vals else float("nan")
        ws.write_row(i + 1, [g, mean_v, bias[g], len(vals)])
    if per_slice:
        for k in sorted(per_slice):
            ws_k = wb.add_worksheet(f"Slice_{k}")
            ws_k.write_row(0, ["Ground-truth", "Model res."])
            for i, (g, v) in enumerate(per_slice[k]):
                ws_k.write_row(i + 1, [g, v])
    wb.close()


def bias_histogram(values_model: Sequence[float],
                   values_ref: Sequence[float], envelope: float):
    """Error histogram within the reference's display envelope
    (±3 % PDFF / ±10 s⁻¹ R2*, ROI-analysis.py:482-514): returns
    (errors, fraction_within)."""
    err = np.asarray(values_model, float) - np.asarray(values_ref, float)
    within = float(np.mean(np.abs(err) <= envelope)) if err.size else 0.0
    return err, within
