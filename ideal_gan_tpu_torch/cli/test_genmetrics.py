"""CLI: generative-quality metrics (port of
`ideal_gan_tpu/cli/test_genmetrics.py`).

    python -m ideal_gan_tpu_torch.cli.test_genmetrics --experiment_dir \\
        output/WF-IDEAL --synthetic 16 --use_ldm 1 --device cuda

Restores the GAN run of `--experiment_dir` (and with `--use_ldm 1` its
LDM, `checkpoints_ldm/`), loads that run's cohort as the real samples, and
draws `--n_samples` latents in batches of `--sample_batch`: N(0, 1) prior
latents, or LDM latents by the reverse chain (`--method ddim` with
`--infer_steps` 50 by default, or `ddpm`). Each batch is decoded (no
codebook, as in the JAX CLI), synthesized at the default TE train, and its
echoes and the real batch's go through the VGG19 trunk: the spatial means
of its five feature maps are the "inception-like" FID embedding
(`eval.metrics.init_vgg19`: converted ImageNet weights where
`weights/vgg19.npz` exists, else the fixed-seed random init, which makes
FID relative only). Prints and returns FID, `features` ("imagenet" or
"random-init", the provenance), the linear MMD between the real and the
generated magnitudes, the mean SSIM of pairs of generated first-echo
magnitudes, and their MS-SSIM where the images are ≥ 176 px. `--device`
defaults to `cuda` and raises without a card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import physics
from ..eval import (FIDAccumulator, echoes_to_vgg_input, feature_source,
                    init_vgg19, mmd_linear, ms_ssim, ssim)
from ..train import gan
from ..train import ldm
from .common import load_cohorts, load_settings, resolve_device, \
    setup_experiment

DEFAULTS = dict(
    dataset="WF-IDEAL", experiment_dir="output/WF-IDEAL", n_samples=16,
    sample_batch=8, use_ldm=False, n_timesteps=200, infer_steps=50,
    infer_sigma=0.0, scheduler="linear", n_ldm_filters=64, class_cond=False,
    n_classes=4, in_res=16, dim_mults=(1, 2, 4), method="ddim", seed=0,
    n_echoes=6, lr=1e-4, beta_1=0.9, beta_2=0.999, epochs=1,
)


def main(argv=None) -> dict:
    cfg = setup_experiment(DEFAULTS, argv,
                           settings_name="settings_genmetrics.yml")
    dev = resolve_device(cfg["device"])
    gan_cfg = load_settings(cfg["experiment_dir"]).backfill(gan.DEFAULTS)
    acqs, _, _ = load_cohorts(gan_cfg.overlay(
        {"synthetic": cfg["synthetic"], "dataset_dir": cfg["dataset_dir"]}))
    models = ldm.load_gan(gan_cfg, cfg["experiment_dir"], dev)
    size = acqs.shape[2]
    latent_hw = (size // 2 ** gan_cfg["n_downsamplings"],) * 2
    cfg["in_res"] = latent_hw[0]
    channels = gan_cfg["encoded_size"]
    gen = torch.Generator(device=dev).manual_seed(cfg["seed"])

    if cfg["use_ldm"]:
        state = ldm.restore_ldm(cfg, cfg["experiment_dir"], channels, dev,
                                torch.Generator().manual_seed(cfg["seed"]))
        sched = ldm.build_schedule(cfg)

        def draw(n):
            return ldm.sample_latents(cfg, state.model, sched, n, latent_hw,
                                      channels, state.z_std,
                                      method=cfg["method"], generator=gen)
    else:
        def draw(n):
            return torch.randn((n, *latent_hw, channels), generator=gen,
                               device=dev)

    vgg = init_vgg19().to(dev)

    @torch.no_grad()
    def feats(a):
        """echoes → the spatial means of the VGG19 feature maps,
        concatenated: (nb·ne, Σ channels)."""
        return torch.cat([f.mean(dim=(2, 3))
                          for f in vgg(echoes_to_vgg_input(a))], dim=-1)

    fid = FIDAccumulator()
    samples = []
    n_drawn = 0
    while n_drawn < cfg["n_samples"]:
        nb = min(cfg["sample_batch"], cfg["n_samples"] - n_drawn)
        with torch.no_grad():
            maps = gan.decode_maps(models, draw(nb))
            a_gen = physics.synthesize_mag(maps, physics.te_train(
                cfg["n_echoes"], bs=nb, device=dev))
        samples.append(a_gen)
        real = torch.from_numpy(np.ascontiguousarray(
            acqs[n_drawn:n_drawn + nb])).to(dev)
        fid.update(feats(real), feats(a_gen))
        n_drawn += nb
    gen_a = torch.cat(samples)
    real_a = torch.from_numpy(np.ascontiguousarray(acqs[:len(gen_a)])).to(dev)
    real_mag = torch.hypot(real_a[..., 0], real_a[..., 1])
    gen_mag = torch.hypot(gen_a[..., 0], gen_a[..., 1])
    pairs = len(gen_a) // 2
    first, second = (gen_mag[sl, 0, :, :, None] for sl in (
        slice(0, pairs), slice(pairs, 2 * pairs)))
    results = {
        "FID": fid.result(),
        # provenance: a "random-init" FID is relative only, never
        # comparable with an ImageNet-feature FID
        "features": feature_source("vgg19"),
        "MMD": float(mmd_linear(real_mag, gen_mag)),
        "SSIM_pairs": float(torch.mean(ssim(first, second))),
    }
    if gen_mag.shape[2] >= 176:
        results["MS_SSIM_pairs"] = float(torch.mean(ms_ssim(first, second)))
    for k, v in results.items():
        print(f"{k}: {v:.5f}" if isinstance(v, float) else f"{k}: {v}")
    return results


if __name__ == "__main__":
    main()
