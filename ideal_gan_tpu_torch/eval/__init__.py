"""Evaluation of the port: ROI bias pipelines, exporters, sample grids, the
ROI picker, the statistics and the GAN trainer's perceptual loss (port of
`ideal_gan_tpu/eval/`'s roi, export, samples, tracker and stats modules and
of the VGG and covariance parts of metrics; FID, MMD and SSIM are ROADMAP
Queue 1 item 11)."""

from .samples import save_sample_grid

__all__ = ["save_sample_grid"]
