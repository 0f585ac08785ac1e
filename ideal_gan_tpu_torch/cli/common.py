"""Shared CLI machinery of the port: flag parsing with a settings.yml round
trip (`utils.config`), device resolution, and the cohorts: the HDF5 files of
`--dataset_dir` or `--synthetic N` slices (`cli.train_unsup` also reads
DICOM and NIfTI folders).

Counterpart of `ideal_gan_tpu/cli/common.py`. Its `compile_cache` flag is
XLA's and has no counterpart; `debug_nans` is not ported yet (ROADMAP
Queue 1 item 7b).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .. import physics
from ..utils import Config, parse_flags


def setup_experiment(defaults: dict, argv=None,
                     settings_name: str = "settings.yml") -> Config:
    """Parse flags over the shared base settings, create
    <output_base>/<dataset>/ and write the settings there as YAML
    (downstream tools name their own file so they never clobber the
    training run's `settings.yml`)."""
    base = {"data_size": 192, "synthetic": 0, "dataset_dir": "../datasets/",
            "output_base": "output", "profile_dir": "", "device": "cuda",
            "seed": 0}
    cfg = parse_flags({**base, **defaults}, argv)
    out_dir = Path(cfg["output_base"]) / cfg["dataset"]
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg.save(out_dir / settings_name)
    cfg["output_dir"] = str(out_dir)
    return cfg


def load_settings(experiment_dir, overlay: dict | None = None) -> Config:
    """The settings a past run wrote into `experiment_dir` (`settings.yml`),
    with `overlay`'s entries winning; FileNotFoundError where there are
    none."""
    cfg = Config.load(Path(experiment_dir) / "settings.yml")
    return cfg.overlay(overlay) if overlay else cfg


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


COHORTS = ("INTArest", "Volunteers", "Attilio")


def load_cohorts(cfg, mebcrn: bool = True, mag_and_phase: bool = False):
    """The cohort for `cfg` as numpy (acqs, maps, te): `--synthetic N`
    slices of `--data_size`², or else the HDF5 cohorts
    `<dataset_dir>/<name>_GC_<data_size>_complex_2D.hdf5` that exist, in
    the order of `COHORTS`, concatenated (FileNotFoundError if none does).
    Every HDF5 slice gets the 1.5 T TE train, as the JAX package gives it
    whatever `--field` says."""
    if cfg.get("synthetic", 0):
        return synthetic_dataset(int(cfg["synthetic"]),
                                 h=cfg.get("data_size", 192),
                                 w=cfg.get("data_size", 192),
                                 ne=cfg.get("n_echoes", 6),
                                 field=cfg.get("field", 1.5))
    from ..data import load_hdf5
    ne = cfg.get("n_echoes", 6)
    acqs_list, maps_list = [], []
    for name in COHORTS:
        path = os.path.join(cfg["dataset_dir"],
                            f"{name}_GC_{cfg.get('data_size', 192)}"
                            "_complex_2D.hdf5")
        if not os.path.exists(path):
            continue
        d = load_hdf5(path, ech_idx=2 * ne, mebcrn=mebcrn,
                      mag_and_phase=mag_and_phase)
        acqs_list.append(d.acqs)
        maps_list.append(d.maps)
    if not acqs_list:
        raise FileNotFoundError(
            f"no cohorts found under {cfg['dataset_dir']}; use --synthetic N")
    acqs = np.concatenate(acqs_list)
    te = physics.te_train(ne, bs=len(acqs)).numpy()
    return acqs, np.concatenate(maps_list), te
