"""Multi-device serving of the map fit (port of
`ideal_gan_tpu/parallel/serving.py`).

The fit is voxel-parallel with no communication between voxels, so it
splits over devices with no collective: each device fits its shard of
slices (or of the image rows of one large volume) with one launch of the
fit kernel, and the shards are gathered on the first device. Launches on
different cards run at once (each is asynchronous); a device list may name
one card more than once, which runs the shards one after the other there
and exercises the split on one card.

Two layouts:

- slice split (default): the leading (nb) axis of the planar buffers and
  of the per-slice `te`, the batch-serving path;
- H split (`voxel_axis=True`): axis 2 of the planar buffers and axis 1 of
  the maps, `te` on every device, for one volume whose slices do not fill
  the devices or one device's memory.
"""

from __future__ import annotations

import contextlib

import torch

from .. import ops as kops


def device_context(dev: torch.device):
    """`torch.cuda.device(dev)` for a card, else nothing."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def make_sharded_fit(devices, voxel_axis: bool = False, **fit_kw):
    """`fit_rho_planar` split over `devices`.

    Returns fn(s_re, s_im, phi, r2s, te) -> (rho_re, rho_im) with the shapes
    and semantics of `ops.fit_rho_planar`, on the first device. With the
    slice split nb must divide by the device count and `te` is per slice
    (split alongside); with the H split H must divide and `te` goes whole
    to every device. An axis that does not divide raises ValueError.
    `fit_kw` goes to every `fit_rho_planar` call (`uniform_te=True` for the
    phasor recurrence)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    ax = 2 if voxel_axis else 0

    def run(s_re, s_im, phi, r2s, te):
        if s_re.shape[ax] % n:
            raise ValueError(
                f"axis {ax} ({s_re.shape[ax]}) must divide the "
                f"{n}-device 'data' mesh")
        per = s_re.shape[ax] // n
        outs = []
        for i, dev in enumerate(devices):
            rows = slice(i * per, (i + 1) * per)
            if voxel_axis:
                args = (s_re[:, :, rows], s_im[:, :, rows], phi[:, rows],
                        r2s[:, rows], te)
            else:
                args = (s_re[rows], s_im[rows], phi[rows], r2s[rows],
                        te[rows])
            with device_context(dev):
                args = [a.to(dev).contiguous() for a in args]
                outs.append(kops.fit_rho_planar(*args, **fit_kw))
        first = devices[0]
        return tuple(torch.cat([o[k].to(first) for o in outs], dim=ax)
                     for k in range(2))

    return run
