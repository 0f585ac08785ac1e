"""Training sample-grid PNGs (port of `ideal_gan_tpu/eval/samples.py`), the
reference's visual-regression artifact: every trainer dumps
samples_training/iter-*.png comparing echoes, predicted maps, and GT maps
(e.g. train-IDEAL-unsup.py:536-669). matplotlib is imported by the
functions only."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .roi import maps_to_display


def save_sample_grid(path: str, acqs: np.ndarray,
                     maps_pred: np.ndarray, maps_gt: np.ndarray | None = None,
                     r2_sc: float = 200.0, fm_sc: float = 300.0) -> None:
    """Write a grid: first row echo magnitudes, second row predicted
    (|W|, |F|, PDFF, R2*, FM), optional third row ground truth."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    acqs = np.asarray(acqs)
    maps_pred = np.asarray(maps_pred)
    ne = min(acqs.shape[1], 6)
    n_rows = 2 + (maps_gt is not None)
    n_cols = max(ne, 5)
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(2.2 * n_cols, 2.4 * n_rows))
    axes = np.atleast_2d(axes)

    for e in range(n_cols):
        ax = axes[0, e]
        if e < ne:
            mag = np.hypot(acqs[0, e, :, :, 0], acqs[0, e, :, :, 1])
            ax.imshow(mag, cmap="gray")
            ax.set_title(f"echo {e + 1}", fontsize=8)
        ax.axis("off")

    def draw_maps(row, maps):
        pdff, r2s, w_abs = maps_to_display(maps[:1])
        f_abs = np.abs(maps[0, 1, ..., 0] + 1j * maps[0, 1, ..., 1])
        fm = maps[0, 2, ..., 0]
        panels = [(w_abs[0], "|W|", "bone", (0, 1.2)),
                  (f_abs, "|F|", "pink", (0, 1.2)),
                  (pdff[0], "PDFF", "jet", (0, 1)),
                  (r2s[0] * r2_sc, "R2* (1/s)", "copper", (0, r2_sc)),
                  (fm * fm_sc, "FM (Hz)", "twilight", (-fm_sc, fm_sc))]
        for c, (img, title, cmap, lim) in enumerate(panels):
            ax = axes[row, c]
            ax.imshow(img, cmap=cmap, vmin=lim[0], vmax=lim[1])
            ax.set_title(title, fontsize=8)
            ax.axis("off")
        for c in range(len(panels), n_cols):
            axes[row, c].axis("off")

    draw_maps(1, maps_pred)
    if maps_gt is not None:
        draw_maps(2, np.asarray(maps_gt))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)


def make_space_above(axes, topmargin: float = 1.0) -> None:
    """Increase figure top margin (reference tl.make_space_above,
    tf2lib/utils/utils.py:68-77)."""
    fig = axes.flatten()[0].figure
    s = fig.subplotpars
    w, h = fig.get_size_inches()
    figh = h - (1 - s.top) * h + topmargin
    fig.subplots_adjust(bottom=s.bottom * h / figh, top=1 - topmargin / figh)
    fig.set_figheight(figh)
