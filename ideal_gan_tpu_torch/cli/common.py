"""Shared CLI machinery of the port: flag parsing (argparse, settings written
as JSON), device resolution and the synthetic cohort.

Counterpart of `ideal_gan_tpu/cli/common.py`. HDF5 cohorts are not ported
yet: `load_cohorts` serves `--synthetic N` only.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .. import physics


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {v!r}")


def parse_flags(defaults: dict, argv=None) -> dict:
    """Every default becomes a typed --flag (bools accept true/false/1/0)."""
    parser = argparse.ArgumentParser()
    for key, val in defaults.items():
        if isinstance(val, bool):
            parser.add_argument(f"--{key}", type=_parse_bool, default=val)
        elif val is None:
            parser.add_argument(f"--{key}", type=str, default=None)
        else:
            parser.add_argument(f"--{key}", type=type(val), default=val)
    return dict(vars(parser.parse_args(argv)))


def setup_experiment(defaults: dict, argv=None,
                     settings_name: str = "settings.json") -> dict:
    """Parse flags over the shared base settings, create
    <output_base>/<dataset>/ and write the settings there as JSON."""
    base = {"data_size": 192, "synthetic": 0, "output_base": "output",
            "device": "cuda", "seed": 0}
    cfg = parse_flags({**base, **defaults}, argv)
    out_dir = Path(cfg["output_base"]) / cfg["dataset"]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / settings_name).write_text(json.dumps(cfg, indent=1))
    cfg["output_dir"] = str(out_dir)
    return cfg


def resolve_device(device) -> torch.device:
    """`device` as a torch.device. Asking for CUDA where there is none
    raises: nothing quietly runs on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available "
                "(pass device='cpu' for the plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def synthetic_dataset(n: int, h: int = 192, w: int = 192, ne: int = 6,
                      seed: int = 0, field: float = 1.5):
    """Physics-consistent synthetic cohort: smooth water/fat/field maps →
    forward model → acquisitions, the JAX package's recipe. Returns (acqs,
    maps, te) numpy arrays in MEBCRN layout; the forward model runs on the
    CPU."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)

    def smooth(lo, hi, s=8):
        x = rng.normal(size=(n, h, w))
        x = np.stack([gaussian_filter(xi, s) for xi in x])
        x = (x - x.min()) / (np.ptp(x) + 1e-9)
        return (lo + (hi - lo) * x).astype(np.float32)

    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - h / 2) / (0.45 * h)) ** 2
            + ((xx - w / 2) / (0.45 * w)) ** 2) < 1.0
    water = smooth(0.2, 0.8) * mask
    fat = smooth(0.0, 0.5) * mask
    phi = smooth(-0.3, 0.3) * mask
    r2s = smooth(0.02, 0.5) * mask
    pha = smooth(-0.3, 0.3)
    w_c = water * np.exp(1j * pha)
    f_c = fat * np.exp(1j * pha)
    maps = np.stack([
        np.stack([w_c.real, w_c.imag], -1),
        np.stack([f_c.real, f_c.imag], -1),
        np.stack([phi, r2s], -1)], axis=1).astype(np.float32)
    te = physics.te_train_for_field(ne, bs=n, field=field)
    # the forward model at its default field, as the JAX recipe calls it
    acqs = physics.synthesize(torch.from_numpy(maps), te)
    return acqs.numpy(), maps, te.numpy()


def load_cohorts(cfg):
    """The cohort for `cfg`: `--synthetic N` slices of `--data_size`²."""
    if not cfg.get("synthetic", 0):
        raise SystemExit("HDF5 cohorts are not ported yet (ROADMAP Queue 1); "
                         "use --synthetic N")
    return synthetic_dataset(int(cfg["synthetic"]),
                             h=cfg.get("data_size", 192),
                             w=cfg.get("data_size", 192),
                             ne=cfg.get("n_echoes", 6),
                             field=cfg.get("field", 1.5))
