"""CLI: a synthetic dataset from a trained PI-LDM (port of
`ideal_gan_tpu/cli/gen_ldm_dataset.py`).

    python -m ideal_gan_tpu_torch.cli.gen_ldm_dataset --experiment_dir \\
        output/WF-IDEAL --n_samples 32 --sample_batch 8 --device cuda

Restores the GAN run of `--experiment_dir` (its settings and newest
checkpoint: the encoder is built but not run, the decoders and the
codebook are) and its LDM (`checkpoints_ldm/`: the denoiser and z_std;
seeded random weights and z_std 1 where there is none), then draws
`--n_samples` latents in batches of `--sample_batch` by the reverse chain
(`--method ddpm`, T steps, or `ddim` with `--infer_steps` and
`--infer_sigma`), decodes them (through the codebook in VQ mode) and
synthesizes `--n_echoes` echoes at the default TE train. Each batch is one
npz shard `<output_base>/<dataset>/generated/<out_name>_NNNN.npz` of
`acqs` (n, ne, H, W, 2) and `out_maps` (n, 3, H, W, 2), the layout
`train_sup --DL_gen` reads (`data.records`). `--write_dicom 1` also writes
each sample as a volume under `generated/out_dicom/Volunteer-NNN/`: its
PDFF and R2* (`data.dicom.write_map_series`) and the first echo's
magnitude clipped to [0, 1] as `MultiEcho/ME_s00.dcm`, ×255 as uint16.
`--device` defaults to `cuda` and raises without a card.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..data.dicom import gen_ds, write_dicom, write_map_series
from ..data.records import write_shard
from ..eval.roi import maps_to_display
from ..train import gan
from ..train import ldm
from .common import load_settings, resolve_device, setup_experiment

DEFAULTS = dict(
    dataset="WF-IDEAL", experiment_dir="output/WF-IDEAL", n_samples=32,
    sample_batch=8, n_timesteps=200, infer_steps=200, infer_sigma=0.0,
    method="ddpm", scheduler="linear", n_ldm_filters=64, class_cond=False,
    n_classes=4, in_res=16, dim_mults=(1, 2, 4), out_name="LDM_ds",
    seed=0, n_echoes=6, lr=1e-4, beta_1=0.9, beta_2=0.999,
    epochs=1, write_dicom=False, method_prefix="m000",
)


def write_volumes(dicom_dir: Path, first: int, acqs: np.ndarray,
                  maps: np.ndarray, method_prefix: str) -> None:
    """Volunteer-NNN/{PDFF,R2s,MultiEcho}/ for samples first, first + 1,
    ...: the JAX CLI's per-volume DICOM export."""
    pdff, r2s, _ = maps_to_display(maps)
    for j in range(len(acqs)):
        vol = first + j
        vdir = dicom_dir / f"Volunteer-{vol:03d}"
        write_map_series(vdir, vol, pdff[j], r2s[j], method_prefix)
        mag0 = np.hypot(acqs[j, 0, :, :, 0], acqs[j, 0, :, :, 1])
        write_dicom(gen_ds(vol, method_prefix), np.clip(mag0, 0, 1),
                    str(vdir / "MultiEcho"), "ME", level=0, slices=1)


def main(argv=None) -> dict:
    """Writes the shards; returns {"shards": [paths], "z_std": float,
    "seconds": [per batch, each ending in a synchronisation]}."""
    cfg = setup_experiment(DEFAULTS, argv, settings_name="settings_gen.yml")
    dev = resolve_device(cfg["device"])
    gan_cfg = load_settings(cfg["experiment_dir"]).backfill(gan.DEFAULTS)
    models = ldm.load_gan(gan_cfg, cfg["experiment_dir"], dev)
    size = gan_cfg.get("data_size", 192)
    latent_hw = (size // 2 ** gan_cfg["n_downsamplings"],) * 2
    cfg["in_res"] = latent_hw[0]
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])
    state = ldm.restore_ldm(cfg, cfg["experiment_dir"],
                            gan_cfg["encoded_size"], dev,
                            torch.Generator().manual_seed(cfg["seed"]))
    sched = ldm.build_schedule(cfg)
    out_dir = Path(cfg["output_dir"]) / "generated"
    shards, seconds = [], []
    n_written = 0
    while n_written < cfg["n_samples"]:
        nb = min(cfg["sample_batch"], cfg["n_samples"] - n_written)
        t0 = time.perf_counter()
        acqs, maps = ldm.generate_dataset(
            cfg, gan_cfg, models, state.model, sched, nb, latent_hw,
            state.z_std, ne=cfg["n_echoes"], method=cfg["method"],
            generator=gen)
        acqs, maps = acqs.cpu().numpy(), maps.cpu().numpy()
        seconds.append(time.perf_counter() - t0)
        shards.append(write_shard(
            str(out_dir / f"{cfg['out_name']}_{len(shards):04d}"), acqs,
            maps))
        if cfg["write_dicom"]:
            write_volumes(out_dir / "out_dicom", n_written, acqs, maps,
                          cfg["method_prefix"])
        n_written += nb
        print(f"wrote shard {len(shards)} ({n_written}/{cfg['n_samples']})")
    return {"shards": shards, "z_std": state.z_std, "seconds": seconds}


if __name__ == "__main__":
    main()
