"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with `nvcc` for Hopper (`sm_90a`) into `ideal_gan_tpu_torch/_build/`, then
loaded with `ctypes`. The library file name carries a hash of the source
and flags, so an edited source is rebuilt and a stale build is never
loaded. Sources may include the shared headers `csrc/*.cuh`, which the
hash covers too. `build_all()` starts one `nvcc` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..utils.nans import check_kernel_outputs

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


def sources() -> tuple[str, ...]:
    """The name of every kernel source, `csrc/<name>.cu`."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _lib_path(name: str) -> Path:
    """The library path: a hash of the source, every shared header of
    `csrc/` (a header edit rebuilds every source) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:12]}.so"


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


def build_all(names=None) -> dict[str, str]:
    """Compile the named kernel sources (default: every `csrc/*.cu`) in
    parallel; a no-op for sources already built. Returns {name: ptxas
    report}."""
    names = sources() if names is None else names
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
    """A hand-written CUDA kernel: its library `csrc/<lib>.cu`, loaded on
    first launch, and `launches`, the number of times a wrapper has
    launched it. `name` (default `lib`) tells apart kernels that share a
    library, as the ConvLSTM kernels' bf16 modes do."""

    def __init__(self, lib: str, signatures: dict, name: str | None = None):
        self.lib = lib
        self.name = name or lib
        self.source = f"ideal_gan_tpu_torch/csrc/{lib}.cu"
        self.launches = 0
        self._signatures = signatures
        self._lib = None

    def fn(self, symbol: str):
        """The C entry `symbol`, with its argtypes and restype set."""
        if self._lib is None:
            lib = load(self.lib)
            for sym, (restype, argtypes) in self._signatures.items():
                getattr(lib, sym).restype = restype
                getattr(lib, sym).argtypes = argtypes
            self._lib = lib
        return getattr(self._lib, symbol)


def check_launch(kernel: Kernel, rc: int, *outputs) -> None:
    """Raise where the launch failed; under `--debug_nans`
    (`utils.nans`), also where one of the `outputs` the kernel wrote
    holds a NaN."""
    if rc != 0:
        raise RuntimeError(f"{kernel.name}: CUDA kernel launch failed with "
                           f"error code {rc}")
    check_kernel_outputs(kernel.name, *outputs)
