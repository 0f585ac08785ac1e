"""Minimal NIfTI-1 (.nii / .nii.gz) reader and writer and the BIDS
multi-echo series loader (the port's own copy of
`ideal_gan_tpu/data/nifti.py`: `struct`, `gzip` and numpy, no nibabel).

Reader: single-file little-endian NIfTI-1 with the common data types,
enough for the magnitude and phase echo volumes of the reference. The
series loader reproduces data.py:501-586 `load_nifti_series`: `_e{n}`
magnitude and `_e{n}_ph` phase pairs (files naming `imaginary`, `real` or
`Eq` are passed over), the echo count from the first file's JSON sidecar
(`EchoTrainLength`), the scale from the first echo's largest magnitude,
the mean-magnitude mask at 0.05, the transpose and flip to (n_slices, ne,
H, W, 2), and the reference's every-second-echo subsampling behind
`half_echoes=True` (the data.py:586 quirk).
"""

from __future__ import annotations

import gzip
import json
import os
import struct

import numpy as np

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32,
}


def _open(path: str, mode: str, compresslevel: int = 9):
    if path.endswith(".gz"):
        return gzip.open(path, mode, compresslevel=compresslevel)
    return open(path, mode)


def read_nifti(path: str) -> np.ndarray:
    """A NIfTI-1 volume's data as float32 in the file's (Fortran-order)
    dimensions, with `scl_slope` / `scl_inter` applied where they are not
    the identity."""
    with _open(path, "rb") as f:
        hdr = f.read(348)
        if struct.unpack("<i", hdr[:4])[0] != 348:
            raise ValueError(f"not a little-endian NIfTI-1 file: {path}")
        dim = struct.unpack("<8h", hdr[40:56])
        datatype = struct.unpack("<h", hdr[70:72])[0]
        vox_offset = int(struct.unpack("<f", hdr[108:112])[0])
        scl_slope = struct.unpack("<f", hdr[112:116])[0]
        scl_inter = struct.unpack("<f", hdr[116:120])[0]
        shape = dim[1:1 + dim[0]]
        dtype = _NIFTI_DTYPES.get(datatype)
        if dtype is None:
            raise ValueError(f"unsupported NIfTI datatype {datatype}")
        f.seek(vox_offset)
        count = int(np.prod(shape))
        data = np.frombuffer(f.read(count * np.dtype(dtype).itemsize),
                             dtype=dtype, count=count)
    arr = data.reshape(shape[::-1]).T.astype(np.float32)  # Fortran order
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        arr = arr * slope + scl_inter
    return arr


def write_nifti(path: str, data: np.ndarray, compresslevel: int = 9) -> None:
    """Write a float32 NIfTI-1 volume (vox_offset 352, unit pixdims and
    slope). `compresslevel` is gzip's for a `.gz` path (9, gzip's default,
    as the JAX package writes)."""
    data = np.asarray(data, np.float32)
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, 16)       # float32
    struct.pack_into("<h", hdr, 72, 32)       # bitpix
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<8f", hdr, 76, *([1.0] * 8))
    hdr[344:348] = b"n+1\x00"
    with _open(path, "wb", compresslevel) as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(np.asfortranarray(data).T.tobytes())


def load_nifti_series(folder_path: str,
                      half_echoes: bool = True) -> np.ndarray:
    """The BIDS multi-echo CSE set of a folder (reference data.py:501-586)
    as float32 (n_slices, ne, H, W, 2), every second echo with
    `half_echoes`. The file filter and the `_e` split read the file names
    only (JAX's read the whole path, so a folder whose path holds `_e`,
    `real` or `Eq` fails there)."""
    avoid = ("imaginary", "real", "Eq")
    names = sorted(f for f in os.listdir(folder_path)
                   if f.endswith(".nii.gz") and not any(a in f for a in avoid))
    first = os.path.join(folder_path, names[0])
    fn_no_ech = os.path.join(folder_path, names[0].split("_e")[0])
    with open(first.replace(".nii.gz", ".json")) as f:
        ne = json.load(f)["EchoTrainLength"]

    x, y, z = read_nifti(first).shape[:3]
    v = np.zeros((x, y, ne, z, 2), np.float32)
    v_mag_all = np.zeros((x, y, ne, z), np.float32)
    v_sc = 1.0
    for ech in range(ne):
        v_mag = read_nifti(f"{fn_no_ech}_e{ech + 1}.nii.gz")
        if ech == 0:
            v_sc = float(np.max(v_mag)) or 1.0
        v_pha = read_nifti(f"{fn_no_ech}_e{ech + 1}_ph.nii.gz")
        v_ech = v_mag * np.exp(1j * v_pha) / v_sc
        v[:, :, ech, :, 0] = v_ech.real
        v[:, :, ech, :, 1] = v_ech.imag
        v_mag_all[:, :, ech, :] = np.abs(v_ech)

    mean_mag = np.mean(v_mag_all, axis=2, keepdims=True)
    mean_mag = np.repeat(mean_mag, ne, axis=2)[..., None]
    mean_mag = np.repeat(mean_mag, 2, axis=-1)
    v = np.where(mean_mag >= 0.05, v, 0.0)

    v = np.transpose(v, (3, 2, 1, 0, 4))  # (n_slices, ne, H, W, 2)
    v = np.flip(v, axis=2)
    if half_echoes:
        return v[:, ::2]  # the reference's every-second-echo quirk
    return v
