"""Interactive ROI picker (port of `ideal_gan_tpu/eval/tracker.py`, the
rebuild of the reference's matplotlib IndexTracker, utils.py:17-126 and
its phantom variant). matplotlib is imported by the display code only.

Scroll to navigate slices, click to drop an ROI anchor (up to two per
slice — right/left hepatic lobes), 's' saves the slice's crops, 'e' erases
them. Crops persist in the reference's stacked-npy format
(frms / crops_1 / crops_2) consumed by the headless pipelines in
`eval.roi`. The event-handler API is framework-agnostic (plain methods fed
matplotlib events), so the logic is unit-testable without a display.
"""

from __future__ import annotations

from .export import load_crops, save_crops

# Sentinel for "this slice has no second ROI" — keeps crops_2 parallel to
# crops_1 in the stacked-npy format. Negative coordinates are impossible
# for real crops (they're top-left corners), so consumers skip them.
NO_ROI = (-1, -1)


class IndexTracker:
    """ROI tracker over a (H, W, n_slices) map stack."""

    def __init__(self, fig, ax, stack, lims=(0, 1), wdt: int = 8,
                 npy_file: str = "slices_crops.npy",
                 max_rois_per_slice: int = 2):
        self.fig = fig
        self.ax = ax
        self.stack = stack
        self.slices = stack.shape[2]
        self.ind = 0
        self.wdt = wdt
        self.npy_file = npy_file
        self.max_rois = max_rois_per_slice
        try:
            frms, crops_1, crops_2 = load_crops(npy_file)
            self.frms = [int(f) for f in frms]
            self.crops_1 = [tuple(c) for c in crops_1]
            self.crops_2 = [tuple(c) for c in crops_2]
            # legacy files may have a shorter crops_2 (pre-sentinel
            # format): pad to parallel so indices line up
            self.crops_2 += [NO_ROI] * (len(self.crops_1)
                                        - len(self.crops_2))
        except (FileNotFoundError, ValueError):
            self.frms, self.crops_1, self.crops_2 = [], [], []
        self._pending: list[tuple[int, int]] = []
        if ax is not None:
            vmin, vmax = lims
            self.im = ax.imshow(stack[:, :, self.ind], vmin=vmin, vmax=vmax)
            self.fig.colorbar(self.im, ax=self.ax)
            self._update()

    # -- event handlers (wired to mpl_connect by the caller) --------------
    def onscroll(self, event):
        if event.button == "up":
            self.ind = (self.ind + 1) % self.slices
        else:
            self.ind = (self.ind - 1) % self.slices
        self._pending = []
        self._update()

    def button_press(self, event):
        if event.xdata is None or event.ydata is None:
            return
        left_x = int(event.xdata) - self.wdt // 2
        sup_y = int(event.ydata) - self.wdt // 2
        if len(self._pending) < self.max_rois:
            self._pending.append((left_x, sup_y))
        self._update()

    def key_press(self, event):
        if event.key == "s" and self._pending:
            self.frms.append(self.ind)
            self.crops_1.append(self._pending[0])
            # crops_2 stays STRICTLY parallel to crops_1 (the reference
            # keeps parallel lists, utils.py:100-109); slices with a
            # single ROI store the (-1, -1) sentinel so later erases on
            # interleaved 1-ROI/2-ROI slices can't desynchronize indices.
            self.crops_2.append(self._pending[1]
                                if len(self._pending) > 1 else NO_ROI)
            self._pending = []
            self.save()
        elif event.key == "e":
            keep = [i for i, f in enumerate(self.frms) if f != self.ind]
            self.frms = [self.frms[i] for i in keep]
            self.crops_1 = [self.crops_1[i] for i in keep]
            self.crops_2 = [self.crops_2[i] for i in keep]
            self._pending = []
            self.save()
        self._update()

    def save(self):
        save_crops(self.npy_file, self.frms, self.crops_1, self.crops_2)

    def _update(self):
        if self.ax is None:
            return
        import matplotlib.patches as patches
        self.im.set_data(self.stack[:, :, self.ind])
        for p in list(self.ax.patches):
            p.remove()
        for i, f in enumerate(self.frms):
            if f != self.ind:
                continue
            for crops in (self.crops_1, self.crops_2):
                if i < len(crops) and tuple(crops[i]) != NO_ROI:
                    lx, sy = crops[i]
                    self.ax.add_patch(patches.Rectangle(
                        (lx, sy), self.wdt, self.wdt, linewidth=1.2,
                        edgecolor="r", facecolor="none"))
        for lx, sy in self._pending:
            self.ax.add_patch(patches.Rectangle(
                (lx, sy), self.wdt, self.wdt, linewidth=1.2,
                edgecolor="y", facecolor="none"))
        self.ax.set_ylabel(f"slice {self.ind + 1}/{self.slices}")
        self.im.axes.figure.canvas.draw_idle()


def run_interactive(stack, lims=(0, 1), wdt: int = 8,
                    npy_file: str = "slices_crops.npy"):
    """Open the picker window (requires a display); returns the tracker
    after the window closes (crops already saved)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, 1)
    tracker = IndexTracker(fig, ax, stack, lims, wdt, npy_file)
    fig.canvas.mpl_connect("scroll_event", tracker.onscroll)
    fig.canvas.mpl_connect("button_press_event", tracker.button_press)
    fig.canvas.mpl_connect("key_press_event", tracker.key_press)
    plt.show()
    tracker.save()
    return tracker
