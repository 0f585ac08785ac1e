"""Evaluation of the port: ROI bias pipelines, exporters, sample grids, the
ROI picker, the statistics, the GAN trainer's perceptual loss and the
generative metrics (port of `ideal_gan_tpu/eval/`'s roi, export, samples,
tracker, stats and metrics modules; `eval/inception.py`, which no CLI
calls, is ROADMAP Queue 1 item 12b)."""

from .metrics import (
    FIDAccumulator,
    VGG19Features,
    covariance_map,
    echoes_to_vgg_input,
    feature_source,
    frechet_distance,
    init_vgg19,
    load_vgg19_npz,
    mmd_linear,
    ms_ssim,
    perceptual_cosine_loss,
    ssim,
)
from .samples import save_sample_grid

__all__ = [
    "VGG19Features", "init_vgg19", "load_vgg19_npz", "echoes_to_vgg_input",
    "feature_source", "perceptual_cosine_loss", "frechet_distance",
    "FIDAccumulator", "mmd_linear", "covariance_map", "ssim", "ms_ssim",
    "save_sample_grid",
]
