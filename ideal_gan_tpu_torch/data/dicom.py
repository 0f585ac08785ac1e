"""Minimal DICOM reader and writer in plain Python (the port's own copy of
`ideal_gan_tpu/data/dicom.py`: `struct` and numpy, no pydicom).

Writer: explicit-VR little-endian MR image files with the tag set of the
reference's synthetic-dataset writer (data.py:353-414 `gen_ds` /
`write_dicom`): patient and series identity, 16-bit monochrome pixels,
RescaleSlope 0.4 (PDFF) or 0.78 (R2*), instance numbering. Values are
written ×255 as uint16 by truncation, with `Columns = shape[0]`.

Reader: explicit- and implicit-VR little-endian files, enough for the
reference's Philips multi-echo CSE loader (data.py:417-480
`load_dicom_series`): magnitude or phase from the private (2005,1011)
tag, the echo number (0018,0086), the echo train length (0018,0091), the
slice position (0020,0032) and the private rescale (2005,100D/E),
combined as magnitude·e^{i·phase} per slice and echo. `pixel_array` keeps
the reference's `reshape(cols, rows)`.

`load_dicom_series(backend=...)` walks the files in Python (`"python"`),
with the C++ parser of `native/dicom_parser.cc` (`"native"`, built by
`data.dicom_native`), or with the parser where it builds and the Python
walk elsewhere (`"auto"`, the JAX package's behaviour); `LAST_BACKEND`
names the walk the last call took.
"""

from __future__ import annotations

import os
import struct
import time
from pathlib import Path

import numpy as np

_MAGIC_OFFSET = 132
_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN"}
_PADDED_TEXT_VRS = (b"UI", b"SH", b"LO", b"PN", b"CS", b"DS", b"IS")
MR_SOP_CLASS = "1.2.840.10008.5.1.4.1.1.4"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
_UID_ROOT = "1.2.826.0.1.3680043.8.498"  # generic test root
BACKENDS = ("auto", "python", "native")

# the walk the last `load_dicom_series` call took: "python" or "native"
LAST_BACKEND: str | None = None


def generate_uid(entropy: int | None = None) -> str:
    """A UID under the test root; from the clock unless `entropy` is
    given, so two files never share one."""
    entropy = entropy if entropy is not None else time.time_ns()
    return f"{_UID_ROOT}.{entropy % 10 ** 30}"


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _elem(group: int, elem: int, vr: bytes, value: bytes) -> bytes:
    """One explicit-VR little-endian element, padded to an even length
    (a space for text VRs, a zero byte otherwise)."""
    if len(value) % 2:
        value += b" " if vr in _PADDED_TEXT_VRS else b"\x00"
    head = struct.pack("<HH", group, elem)
    if vr in _EXPLICIT_LONG_VRS:
        return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
    return head + vr + struct.pack("<H", len(value)) + value


def _str_elem(group, elem, vr, s):
    return _elem(group, elem, vr, str(s).encode("ascii"))


class DicomDataset(dict):
    """{(group, elem): (vr, value)} with the attribute API the reference's
    writer uses (`ds.PatientName = ...`, `ds.save_as(path)`). Tags outside
    `_ATTRS` (the Philips private ones) are set by item:
    `ds[(0x2005, 0x1011)] = ("LO", "M")`."""

    _ATTRS = {
        "SOPClassUID": (0x0008, 0x0016, "UI"),
        "SOPInstanceUID": (0x0008, 0x0018, "UI"),
        "Modality": (0x0008, 0x0060, "CS"),
        "PatientName": (0x0010, 0x0010, "PN"),
        "PatientID": (0x0010, 0x0020, "LO"),
        "StudyInstanceUID": (0x0020, 0x000D, "UI"),
        "SeriesInstanceUID": (0x0020, 0x000E, "UI"),
        "FrameOfReferenceUID": (0x0020, 0x0052, "UI"),
        "InstanceNumber": (0x0020, 0x0013, "IS"),
        "ImagePositionPatient": (0x0020, 0x0032, "DS"),
        "ImageOrientationPatient": (0x0020, 0x0037, "DS"),
        "ImageType": (0x0008, 0x0008, "CS"),
        "ImagesInAcquisition": (0x0020, 0x1002, "IS"),
        "EchoNumbers": (0x0018, 0x0086, "IS"),
        "EchoTrainLength": (0x0018, 0x0091, "IS"),
        "EchoTime": (0x0018, 0x0081, "DS"),
        "SamplesPerPixel": (0x0028, 0x0002, "US"),
        "PhotometricInterpretation": (0x0028, 0x0004, "CS"),
        "Rows": (0x0028, 0x0010, "US"),
        "Columns": (0x0028, 0x0011, "US"),
        "PixelSpacing": (0x0028, 0x0030, "DS"),
        "BitsAllocated": (0x0028, 0x0100, "US"),
        "BitsStored": (0x0028, 0x0101, "US"),
        "HighBit": (0x0028, 0x0102, "US"),
        "PixelRepresentation": (0x0028, 0x0103, "US"),
        "RescaleIntercept": (0x0028, 0x1052, "DS"),
        "RescaleSlope": (0x0028, 0x1053, "DS"),
    }

    def __init__(self):
        super().__init__()
        self.PixelData: bytes = b""

    def __setattr__(self, name, value):
        if name in self._ATTRS:
            g, e, vr = self._ATTRS[name]
            self[(g, e)] = (vr, value)
        else:
            super().__setattr__(name, value)

    def __getattr__(self, name):
        if name in self._ATTRS:
            g, e, _ = self._ATTRS[name]
            try:
                return self[(g, e)][1]
            except KeyError as exc:
                raise AttributeError(name) from exc
        raise AttributeError(name)

    def save_as(self, path, write_like_original: bool = True) -> None:
        """Write the preamble, the file meta group (explicit VR little
        endian) and the elements in tag order, PixelData (OW) last."""
        del write_like_original
        body = []
        for (g, e) in sorted(self.keys()):
            vr, value = self[(g, e)]
            raw = (struct.pack("<H", int(value)) if vr == "US"
                   else str(value).encode("ascii"))
            body.append(_elem(g, e, vr.encode(), raw))
        body.append(_elem(0x7FE0, 0x0010, b"OW", self.PixelData))

        sop_uid = self.get((0x0008, 0x0018), ("UI", generate_uid()))[1]
        meta = (_elem(0x0002, 0x0001, b"OB", b"\x00\x01")
                + _str_elem(0x0002, 0x0002, b"UI", MR_SOP_CLASS)
                + _str_elem(0x0002, 0x0003, b"UI", sop_uid)
                + _str_elem(0x0002, 0x0010, b"UI", EXPLICIT_VR_LE))
        group_len = _elem(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta)))
        with open(path, "wb") as f:
            f.write(b"\x00" * 128 + b"DICM")
            f.write(group_len + meta)
            f.write(b"".join(body))


def gen_ds(idx: int, method_prefix: str = "m000",
           r2s: bool = False) -> DicomDataset:
    """The synthetic MR skeleton of the reference (gen_ds, data.py:353-394):
    fresh UIDs, 16-bit monochrome, RescaleSlope "0.78" for R2* and "0.4"
    otherwise."""
    ds = DicomDataset()
    ds.SOPClassUID = MR_SOP_CLASS
    ds.SOPInstanceUID = generate_uid()
    ds.PatientName = f"Volunteer^{str(idx).zfill(3)}^-{method_prefix}"
    ds.PatientID = str(idx).zfill(6)
    ds.Modality = "MR"
    ds.SeriesInstanceUID = generate_uid()
    ds.StudyInstanceUID = generate_uid()
    ds.FrameOfReferenceUID = generate_uid()
    ds.BitsStored = 16
    ds.BitsAllocated = 16
    ds.SamplesPerPixel = 1
    ds.HighBit = 15
    ds.ImagePositionPatient = r"0\0\1"
    ds.ImageOrientationPatient = r"1\0\0\0\-1\0"
    ds.ImageType = r"ORIGINAL\PRIMARY\AXIAL"
    ds.RescaleIntercept = "0"
    ds.RescaleSlope = "0.78" if r2s else "0.4"
    ds.PixelSpacing = r"1\1"
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.PixelRepresentation = 1
    return ds


def write_map_series(vdir, vol_idx: int, pdff_slice, r2s_slice,
                     method_prefix: str = "m000") -> None:
    """One volume's PDFF and R2* as single-slice series under
    <vdir>/{PDFF,R2s}/, each clipped to [0, 1]: the export convention of
    `cli.infer` and `cli.gen_ldm_dataset`."""
    vdir = Path(vdir)
    write_dicom(gen_ds(vol_idx, method_prefix),
                np.clip(pdff_slice, 0, 1), str(vdir / "PDFF"),
                "PDFF", level=0, slices=1)
    write_dicom(gen_ds(vol_idx, method_prefix, r2s=True),
                np.clip(r2s_slice, 0, 1), str(vdir / "R2s"),
                "R2s", level=0, slices=1)


def write_dicom(ds: DicomDataset, pixel_array, path, filename, level,
                slices) -> None:
    """Write one slice as <path>/<filename>_sLL.dcm (reference write_dicom,
    data.py:397-414): values ×255 to uint16 by truncation, Columns the
    first axis and Rows the second."""
    image2d = (np.squeeze(np.asarray(pixel_array)) * 255).astype(np.uint16)
    suffix = "_s" + str(level).zfill(2) + ".dcm"
    ds.ImagesInAcquisition = str(slices)
    ds.InstanceNumber = level
    ds.Columns = image2d.shape[0]
    ds.Rows = image2d.shape[1]
    ds.PixelData = image2d.tobytes()
    Path(path).mkdir(parents=True, exist_ok=True)
    ds.save_as(os.path.join(path, filename + suffix))


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def read_dicom(path: str) -> dict:
    """Parse a little-endian DICOM file into {(group, elem): value}: pixel
    data (7FE0,0010) as raw bytes, US values (and 2-byte values of group
    0028 without a VR) as ints, other values as stripped ASCII text where
    they decode, else raw bytes. Stops at an undefined-length sequence."""
    with open(path, "rb") as f:
        data = f.read()
    pos = _MAGIC_OFFSET if data[_MAGIC_OFFSET - 4:_MAGIC_OFFSET] == b"DICM" \
        else 0
    out: dict = {}
    n = len(data)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", data, pos)
        pos += 4
        vr = data[pos:pos + 2]
        if group != 0xFFFE and vr.isalpha() and vr.isupper():
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from("<I", data, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", data, pos + 2)[0]
                pos += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", data, pos)[0]
            pos += 4
        if length == 0xFFFFFFFF:
            break  # sequences of undefined length: out of scope
        value = data[pos:pos + length]
        pos += length
        if (group, elem) == (0x7FE0, 0x0010):
            out[(group, elem)] = value
        elif vr == b"US" or (vr == b"UN" and length == 2
                             and group == 0x0028):
            out[(group, elem)] = struct.unpack("<H", value[:2])[0]
        else:
            try:
                out[(group, elem)] = value.decode("ascii").strip("\x00 ")
            except UnicodeDecodeError:
                out[(group, elem)] = value
    return out


def pixel_array(tags: dict) -> np.ndarray:
    """The uint16 pixels of `read_dicom`'s tags as (cols, rows), the
    reference's reshape."""
    rows = int(tags.get((0x0028, 0x0010), 0))
    cols = int(tags.get((0x0028, 0x0011), 0))
    raw = tags[(0x7FE0, 0x0010)]
    return np.frombuffer(raw, dtype=np.uint16,
                         count=rows * cols).reshape(cols, rows)


def _python_records(files):
    """(component, echo, echo train length, slice position, rescaled image)
    per file by the Python walk: a missing echo train length keeps the
    previous file's (1 before the first), a missing or empty private
    intercept or slope reads 1."""
    echo_all = 1
    for f in files:
        tags = read_dicom(f)
        img = pixel_array(tags).astype(np.float32)
        comp = str(tags.get((0x2005, 0x1011), "M"))
        echo_num = int(float(tags.get((0x0018, 0x0086), 1)))
        echo_all = int(float(tags.get((0x0018, 0x0091), echo_all)))
        pos = str(tags.get((0x0020, 0x0032), "0\\0\\0"))
        sl_pos = round(float(pos.split("\\")[-1]), 1)
        intercept = float(tags.get((0x2005, 0x100D), 1.0) or 1.0)
        slope = float(tags.get((0x2005, 0x100E), 1.0) or 1.0)
        yield comp, echo_num, echo_all, sl_pos, (img - intercept) / slope


def combine_series(records) -> np.ndarray:
    """The series from per-file records (component, echo number, echo train
    length, slice position, rescaled image): files grouped by slice
    position and echo, the slices holding every echo of the last file's
    train length kept in first-seen order, magnitude·e^{i·phase} where a
    phase image exists, one normalisation by the largest magnitude.
    Returns float32 (n_slices, ne, H, W, 2)."""
    sl_mag: dict = {}
    sl_pha: dict = {}
    echo_all, shape = 1, None
    for comp, echo_num, echo_all, sl_pos, img in records:
        shape = img.shape
        target = sl_pha if comp == "P" else sl_mag
        target.setdefault(sl_pos, {})[echo_num] = img
    complete = [sl for sl in sl_mag if len(sl_mag[sl]) == echo_all]
    x = np.zeros((len(complete), echo_all) + shape, np.complex64)
    for i, sl in enumerate(complete):
        for j, ech in enumerate(sorted(sl_mag[sl])):
            val = sl_mag[sl][ech].astype(np.complex64)
            if sl in sl_pha and ech in sl_pha[sl]:
                val = val * np.exp(1j * sl_pha[sl][ech])
            x[i, j] = val
    denom = np.abs(x).max()
    if denom > 0:
        x = x / denom
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def series_files(folder_path: str) -> list[str]:
    """The `.dcm` files of a folder, sorted by path."""
    return sorted(os.path.join(folder_path, f)
                  for f in os.listdir(folder_path) if f.endswith(".dcm"))


def load_dicom_series(folder_path: str,
                      backend: str = "auto") -> np.ndarray:
    """The Philips multi-echo CSE series of a folder (reference
    load_dicom_series, data.py:417-480) as (n_slices, ne, H, W, 2): files
    grouped by slice position (the last coordinate of ImagePositionPatient
    rounded to 0.1) and echo number, rescaled by the private intercept and
    slope, magnitude·e^{i·phase}, normalised once over the series.

    backend: "python" walks the files here; "native" uses the C++ parser
    (`data.dicom_native`) and raises if it cannot be built or loaded;
    "auto" uses the parser where it builds and reads every file, and the
    Python walk elsewhere.
    `LAST_BACKEND` names the walk taken."""
    global LAST_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if backend != "python":
        from . import dicom_native
        if backend == "native" or dicom_native.native_available():
            try:
                out = dicom_native.load_dicom_series_native(folder_path)
            except dicom_native.UnreadableFile:
                if backend == "native":
                    raise
            else:
                LAST_BACKEND = "native"
                return out
    out = combine_series(_python_records(series_files(folder_path)))
    LAST_BACKEND = "python"
    return out
