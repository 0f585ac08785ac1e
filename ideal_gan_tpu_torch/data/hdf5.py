"""HDF5 dataset loading with the reference's slicing semantics (the port's
own copy of `ideal_gan_tpu/data/hdf5.py`, numpy only; h5py is imported
when a file is opened, so the package imports without it).

Rebuild of the reference loader (data.py:52-176): datasets store
`Acquisitions` (n, H, W, 2·ne interleaved re/im), `OutMaps`
(n, H, W, 6 = [Wr, Wi, Fr, Fi, R2*, FM]) and optionally `TEs` (n, ne).
Selection supports start/end ranges, explicit index lists, and per-patient
slice counts with the 4-non-central-slice drop; zero slices (all-zero first
map channel) are filtered; outputs can be converted to the MEBCRN layout,
optionally re-parameterized to (FF, PD, phase) magnitude/phase rows with
optional 2-D phase unwrapping.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from .unwrap import unwrap_slices


@dataclasses.dataclass
class Hdf5Data:
    acqs: np.ndarray | None
    maps: np.ndarray
    tes: np.ndarray | None


def _h5py():
    try:
        import h5py
    except ImportError as e:  # pragma: no cover
        raise ImportError("h5py is required for HDF5 dataset loading") from e
    return h5py


def _central_slice_idxs(num_slice_list: Sequence[int]) -> list[int]:
    """Drop the 4 first slices of each patient block (reference
    data.py:63-78 semantics: per-patient num_slice boundaries, keep only
    indices more than 4 past each patient start)."""
    ini_end = np.cumsum(np.asarray(num_slice_list))
    idxs = []
    bounds = list(ini_end)
    for k in range(bounds[0], bounds[-1]):
        k_diff = k - bounds[0]
        if abs(k_diff) > 4:
            idxs.append(k)
        elif k_diff >= 4:
            bounds.pop(0)
    return idxs


def mag_phase_maps(out_maps: np.ndarray, unwrap: bool = False) -> np.ndarray:
    """Legacy 6-channel maps → MEBCRN mag/phase rows
    [(FF, 0), (PD, R2*), (WF-phase/kφ, FM)] (data.py:99-115)."""
    w_mag = np.sqrt(np.sum(out_maps[..., :2] ** 2, axis=-1, keepdims=True))
    f_mag = np.sqrt(np.sum(out_maps[..., 2:4] ** 2, axis=-1, keepdims=True))
    tot = w_mag + f_mag
    ff = np.divide(f_mag, tot, out=np.zeros_like(f_mag), where=tot != 0)
    row_ff = np.concatenate([ff, np.zeros_like(ff)], -1)[:, None]
    row_mag = np.concatenate([tot, out_maps[..., 4:5]], -1)[:, None]
    w_pha = np.where(w_mag > 0,
                     np.arctan2(out_maps[..., 1:2], out_maps[..., 0:1]), 0.0)
    f_pha = np.where(f_mag > 0,
                     np.arctan2(out_maps[..., 3:4], out_maps[..., 2:3]), 0.0)
    wf_pha = np.divide(w_mag * w_pha + f_mag * f_pha, tot,
                       out=np.zeros_like(w_pha), where=tot != 0)
    if unwrap:
        wf_pha = unwrap_slices(np.squeeze(wf_pha, -1))
        k_phase = 4 * np.pi
    else:
        k_phase = np.pi
    row_pha = np.concatenate([wf_pha / k_phase, out_maps[..., 5:]], -1)[:, None]
    return np.concatenate([row_ff, row_mag, row_pha], axis=1).astype(np.float32)


def complex_maps_mebcrn(out_maps: np.ndarray) -> np.ndarray:
    """Legacy 6-channel maps → MEBCRN rows [water, fat, (FM, R2*)]
    (data.py:117-123)."""
    w = out_maps[..., :2][:, None]
    f = out_maps[..., 2:4][:, None]
    xi = np.concatenate([out_maps[..., 5:], out_maps[..., 4:5]], -1)[:, None]
    return np.concatenate([w, f, xi], axis=1).astype(np.float32)


def acqs_mebcrn(acqs: np.ndarray) -> np.ndarray:
    """Interleaved (n, H, W, 2·ne) → MEBCRN (n, ne, H, W, 2)."""
    re = np.transpose(acqs[..., 0::2], (0, 3, 1, 2))
    im = np.transpose(acqs[..., 1::2], (0, 3, 1, 2))
    return np.stack([re, im], axis=-1).astype(np.float32)


def load_hdf5(path: str, ech_idx: int = 12, start: int = 0, end: int = 2000,
              custom_list: Sequence[int] | None = None,
              num_slice_list: Sequence[int] | None = None,
              acqs_data: bool = True, te_data: bool = False,
              complex_data: bool = False, remove_zeros: bool = True,
              mebcrn: bool = False, mag_and_phase: bool = False,
              unwrap: bool = False) -> Hdf5Data:
    """Load an HDF5 cohort with the reference's selection and layout
    semantics (data.py:52-153). `ech_idx` counts interleaved channels
    (2·n_echoes)."""
    with _h5py().File(path, "r") as f:
        if custom_list is not None:
            sel = list(custom_list)
        elif num_slice_list is not None:
            sel = _central_slice_idxs(num_slice_list)
        else:
            sel = list(range(start, min(end, len(f["OutMaps"]))))
        maps = f["OutMaps"][sel]
        acqs = f["Acquisitions"][sel] if acqs_data else None
        tes = f["TEs"][sel][..., None] if te_data else None

    if remove_zeros:
        keep = [i for i in range(len(maps)) if np.sum(maps[i, :, :, 0]) != 0.0]
    else:
        keep = list(range(len(maps)))
    maps = maps[keep]

    if mebcrn:
        if mag_and_phase:
            maps = mag_phase_maps(maps, unwrap=unwrap)
        else:
            maps = complex_maps_mebcrn(maps)

    if acqs is not None:
        acqs = acqs[keep, :, :, :ech_idx]
        if complex_data:
            acqs = acqs[..., 0::2] + 1j * acqs[..., 1::2]
        elif mebcrn:
            acqs = acqs_mebcrn(acqs)
    if tes is not None:
        n_te = ech_idx if complex_data else ech_idx // 2
        tes = tes[keep, :n_te]
    return Hdf5Data(acqs=acqs, maps=maps, tes=tes)


def group_tes(acqs: np.ndarray, maps: np.ndarray, tes: np.ndarray,
              te1: float, dte: float, te1_orig: float = 0.0013,
              dte_orig: float = 0.0021):
    """Group a multi-TE dataset by acquisition protocol (reference
    `group_TEs`, data.py:179-259): for each patient (identified by runs of
    the original-protocol slices), select the slices matching the target
    (TE1, ΔTE); patients lacking the target protocol contribute their
    original slices zeroed out. Works on MEBCRN or legacy layouts."""
    te1 = np.float32(te1)
    dte = np.float32(dte)
    te1_orig = np.float32(te1_orig)
    dte_orig = np.float32(dte_orig)
    n = len(acqs)

    num_pat = 0
    all_null, all_sel = [], []
    orig_slices, sel_slices = [], []
    flag_orig = flag_sel = False
    flag_no_te = True

    for idx in range(n + 1):
        if idx < n:
            te1_i = np.round(tes[idx, 0, 0], 4)
            dte_i = np.round(np.mean(np.diff(tes[idx, :, 0])), 4)
        else:
            te1_i, dte_i = te1_orig, dte_orig

        if te1_i == te1_orig and dte_i == dte_orig:
            if not flag_orig:
                flag_orig = True
                if num_pat > 0:
                    if flag_no_te:
                        all_null.extend(orig_slices)
                        all_sel.extend(orig_slices)
                    else:
                        flag_no_te = True
                        all_sel.extend(sel_slices)
                        sel_slices = []
                num_pat += 1
                orig_slices = []
            orig_slices.append(idx)
        else:
            flag_orig = False

        if te1_i == te1 and dte_i == dte:
            if not flag_sel:
                flag_sel = True
                flag_no_te = False
            sel_slices.append(idx)
        else:
            flag_sel = False

    acqs = acqs.copy()
    maps = maps.copy()
    acqs[all_null] = 0.0
    maps[all_null] = 0.0
    return acqs[all_sel], maps[all_sel], tes[all_sel]


def iterate_hdf5(paths: Sequence[str], ech_idx: int,
                 lims_list: Sequence[tuple[int, int]],
                 remove_zeros: bool = True) -> Iterator[tuple]:
    """Streaming generator over several HDF5 files with wrap-around index
    ranges (reference `gen_hdf5`, data.py:156-176)."""
    h5py = _h5py()
    for path, lims in zip(paths, lims_list):
        with h5py.File(path, "r") as f:
            n = len(f["OutMaps"])
            if lims[1] >= lims[0]:
                idx_list = np.arange(lims[0], lims[1])
            else:
                idx_list = np.concatenate(
                    [np.arange(0, lims[1]), np.arange(lims[0], n)])
            for i in idx_list:
                out = f["OutMaps"][i]
                if remove_zeros and np.sum(out) == 0.0:
                    continue
                im = f["Acquisitions"][i, :, :, :ech_idx]
                yield im, out
