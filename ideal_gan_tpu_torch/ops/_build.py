"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with `nvcc` for Hopper (`sm_90a`) into `ideal_gan_tpu_torch/_build/`, then
loaded with `ctypes`. The library file name carries a hash of the source
and flags, so an edited source is rebuilt and a stale build is never
loaded. `build_all()` starts one `nvcc` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "ideal_gan_tpu_torch need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:12]}.so"


def _start(name: str):
    """Start `nvcc` for one source; returns (final path, process or None)."""
    out = _lib_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    proc.log = log
    proc.tmp = tmp
    return out, proc


def _finish(name: str, out: Path, proc) -> None:
    if proc is None:
        return
    rc = proc.wait()
    proc.log.close()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {rc}):\n"
            + out.with_suffix(".log").read_text())
    os.replace(proc.tmp, out)


def build_all(names=("ideal_fit", "convlstm_fwd")) -> dict[str, str]:
    """Compile every named kernel source in parallel (no-op for sources
    already built). Returns {name: ptxas report}."""
    with _lock:
        started = [(n, *_start(n)) for n in names]
        for name, out, proc in started:
            _finish(name, out, proc)
    return {n: out.with_suffix(".log").read_text()
            if out.with_suffix(".log").exists() else ""
            for n, out, _ in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out, proc = _start(name)
            _finish(name, out, proc)
            lib = ctypes.CDLL(str(out))
            _loaded[name] = lib
    return lib


class Kernel:
    """A hand-written CUDA kernel: its library, loaded on first launch, and
    `launches`, the number of times a wrapper has launched it."""

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.source = f"ideal_gan_tpu_torch/csrc/{name}.cu"
        self.launches = 0
        self._signatures = signatures
        self._lib = None

    def fn(self, symbol: str):
        """The C entry `symbol`, with its argtypes and restype set."""
        if self._lib is None:
            lib = load(self.name)
            for sym, (restype, argtypes) in self._signatures.items():
                getattr(lib, sym).restype = restype
                getattr(lib, sym).argtypes = argtypes
            self._lib = lib
        return getattr(self._lib, symbol)


def check_launch(kernel: Kernel, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: CUDA kernel launch failed with "
                           f"error code {rc}")
