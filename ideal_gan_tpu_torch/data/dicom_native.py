"""ctypes binding of the native DICOM parser (`native/dicom_parser.cc`,
C++17, no dependencies), the port's counterpart of
`ideal_gan_tpu/data/dicom_native.py`.

The source is read where it stands and compiled on first use with
`g++ -O3 -fPIC -shared -std=c++17` into `ideal_gan_tpu_torch/_build/`,
under a name that carries a hash of the source and the flags (as
`ops/_build.py` names the CUDA builds): an edited source is rebuilt, and
nothing is written beside the source. `native_available()` says whether
the parser builds and loads; `load_dicom_series_native` raises with the
compiler's message where it does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from .dicom import combine_series, series_files

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dicom_parser.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


class UnreadableFile(RuntimeError):
    """A file of the series that the parser cannot read."""


class _DicomInfo(ctypes.Structure):
    """`struct DicomInfo` of dicom_parser.cc, field for field (ctypes pads
    after `component` as the C++ compiler does)."""
    _fields_ = [
        ("rows", ctypes.c_int32),
        ("cols", ctypes.c_int32),
        ("echo_num", ctypes.c_int32),
        ("echo_train", ctypes.c_int32),
        ("slice_pos", ctypes.c_double),
        ("rescale_i", ctypes.c_double),
        ("rescale_s", ctypes.c_double),
        ("component", ctypes.c_char),
        ("pixels", ctypes.POINTER(ctypes.c_uint16)),
        ("n_pixels", ctypes.c_int64),
    ]


def lib_path() -> Path:
    """The library's path: a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdicom_parser.{h.hexdigest()[:12]}.so"


def _build() -> Path:
    """Compile the parser unless this source's build exists (to a
    temporary name, renamed into place once complete)."""
    out = lib_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native DICOM parser needs a "
                           "C++17 compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed for {SOURCE.name} (rc "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_lib() -> ctypes.CDLL:
    """The loaded parser, built on first use; raises with the build's or
    the loader's message where that fails (and again on every later
    call)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
                lib.dicom_parse.restype = ctypes.c_void_p
                lib.dicom_parse.argtypes = [ctypes.c_char_p,
                                            ctypes.POINTER(_DicomInfo)]
                lib.dicom_free.argtypes = [ctypes.c_void_p]
                _lib = lib
            except (OSError, RuntimeError) as e:
                _error = str(e)
        if _lib is None:
            raise RuntimeError(f"the native DICOM parser is unavailable: "
                               f"{_error}")
        return _lib


def native_available() -> bool:
    try:
        load_lib()
    except RuntimeError:
        return False
    return True


def parse_dicom_native(path: str):
    """One file → (meta dict, uint16 pixels (n,)), or None where the
    parser cannot read it."""
    lib = load_lib()
    info = _DicomInfo()
    handle = lib.dicom_parse(str(path).encode(), ctypes.byref(info))
    if not handle:
        return None
    try:
        n = int(info.n_pixels)
        px = np.ctypeslib.as_array(info.pixels, shape=(n,)).copy() \
            if n else np.zeros((0,), np.uint16)
        meta = {
            "rows": int(info.rows),
            "cols": int(info.cols),
            "echo_num": int(info.echo_num),
            "echo_train": int(info.echo_train),
            "slice_pos": float(info.slice_pos),
            "rescale_i": float(info.rescale_i),
            "rescale_s": float(info.rescale_s),
            "component": info.component.decode(),
        }
    finally:
        lib.dicom_free(handle)
    return meta, px


def _native_records(files):
    """`dicom._python_records` by the parser, with its conventions: a
    missing echo train length reads 1, a missing intercept 0 and a missing
    or zero slope 1; a file whose pixel count is not rows·cols is
    skipped; a file the parser cannot read raises `UnreadableFile`."""
    echo_all = 1
    for f in files:
        parsed = parse_dicom_native(f)
        if parsed is None:
            raise UnreadableFile(f"the native DICOM parser cannot read {f}")
        meta, px = parsed
        if meta["rows"] * meta["cols"] != px.size:
            continue
        img = px.reshape(meta["cols"], meta["rows"]).astype(np.float32)
        echo_all = meta["echo_train"] or echo_all
        resc = (img - meta["rescale_i"]) / meta["rescale_s"]
        yield (meta["component"], meta["echo_num"], echo_all,
               round(meta["slice_pos"], 1), resc)


def load_dicom_series_native(folder_path: str) -> np.ndarray:
    """`data.dicom.load_dicom_series` by the native parser: the same
    (n_slices, ne, H, W, 2)."""
    load_lib()
    return combine_series(_native_records(series_files(folder_path)))
