"""Evaluation of the port: ROI bias pipelines, exporters, sample grids, the
ROI picker and the statistics (port of `ideal_gan_tpu/eval/`'s roi,
export, samples, tracker and stats modules; the generative metrics are
ROADMAP Queue 1 item 10)."""

from .samples import save_sample_grid

__all__ = ["save_sample_grid"]
