"""Synthetic cohorts made on the device from a seed: physics-consistent
slices as the JAX package's `--synthetic` recipe makes them (smooth
water, fat, field, R2* and phase fields inside an elliptical support,
each a Gaussian-filtered normal field (sigma 8) rescaled over the cohort
to its range), then the 7-peak forward model at the slices' TE train.

Everything is drawn by one `torch.Generator` on the device, filtered by
two 1-D convolutions, and copied to the host once, as numpy, the way a
loaded cohort sits in host memory.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .reference import physics

# (lo, hi, masked) of each field, the recipe's ranges
FIELDS = {"water": (0.2, 0.8, True), "fat": (0.0, 0.5, True),
          "phi": (-0.3, 0.3, True), "r2s": (0.02, 0.5, True),
          "pha": (-0.3, 0.3, False)}


def _smooth(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian filter (truncated at 4 sigma, reflected edges) over the
    last two axes of (k, n, H, W)."""
    r = int(4 * sigma + 0.5)
    t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
    g = torch.exp(-0.5 * (t / sigma) ** 2)
    g = g / g.sum()
    k, n, h, w = x.shape
    y = x.reshape(k * n, 1, h, w)
    y = F.conv2d(F.pad(y, (0, 0, r, r), mode="reflect"), g.view(1, 1, -1, 1))
    y = F.conv2d(F.pad(y, (r, r, 0, 0), mode="reflect"), g.view(1, 1, 1, -1))
    return y.reshape(k, n, h, w)


def maps(gen: torch.Generator, n: int, size: int, device,
         sigma: float = 8.0) -> torch.Tensor:
    """(n, 3, size, size, 2) ground-truth maps [water, fat, (phi, R2*)] on
    `device` (sigma at most an eighth of the size, for small test sizes)."""
    raw = _smooth(torch.randn((len(FIELDS), n, size, size), generator=gen,
                              device=device), min(sigma, size / 8))
    lo = raw.amin(dim=(1, 2, 3), keepdim=True)
    hi = raw.amax(dim=(1, 2, 3), keepdim=True)
    unit = (raw - lo) / (hi - lo + 1e-9)
    yy, xx = torch.meshgrid(torch.arange(size, device=device),
                            torch.arange(size, device=device), indexing="ij")
    c = size / 2
    mask = ((((yy - c) / (0.45 * size)) ** 2
             + ((xx - c) / (0.45 * size)) ** 2) < 1.0).float()
    f = {}
    for i, (name, (a, b, masked)) in enumerate(FIELDS.items()):
        f[name] = (a + (b - a) * unit[i]) * (mask if masked else 1.0)
    w = torch.polar(f["water"], f["pha"])
    fat = torch.polar(f["fat"], f["pha"])
    rows = [torch.stack([w.real, w.imag], -1),
            torch.stack([fat.real, fat.imag], -1),
            torch.stack([f["phi"], f["r2s"]], -1)]
    return torch.stack(rows, dim=1).contiguous()


def te_train(n_echoes: int, te1: float, dte: float, device) -> torch.Tensor:
    """A uniform TE train (1, ne, 1)."""
    t = te1 + dte * torch.arange(n_echoes, dtype=torch.float32)
    return t.to(device)[None, :, None]


def sampled_te(gen: torch.Generator, n_echoes: int, te1, dte, jitter,
               device) -> torch.Tensor:
    """A TE train (1, ne, 1) as the TE-augmentation sampler draws one:
    TE1 ~ U(te1), a common spacing ~ U(dte), each spacing ~ N(common,
    jitter^2)."""
    u = torch.rand(2, generator=gen, device=device, dtype=torch.float64)
    t1 = te1[0] + u[0] * (te1[1] - te1[0])
    d = dte[0] + u[1] * (dte[1] - dte[0])
    d = d + jitter * torch.randn(n_echoes - 1, generator=gen, device=device,
                                 dtype=torch.float64)
    zero = torch.zeros(1, dtype=torch.float64, device=device)
    return (t1 + torch.cat([zero, torch.cumsum(d, 0)])).float()[None, :, None]


def acquisitions(m: torch.Tensor, te: torch.Tensor, field: float,
                 chunk: int = 16) -> torch.Tensor:
    """The forward model of maps `m` at `te` ((1, ne, 1) or one a slice),
    in chunks of slices."""
    out = []
    for i in range(0, len(m), chunk):
        mm = m[i:i + chunk]
        t = te.expand(len(mm), -1, -1) if te.shape[0] == 1 \
            else te[i:i + chunk]
        out.append(physics.synthesize(mm, t.contiguous(), field))
    return torch.cat(out)


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()

