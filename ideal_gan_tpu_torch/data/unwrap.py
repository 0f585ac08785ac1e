"""2-D phase unwrapping (the port's own copy of
`ideal_gan_tpu/data/unwrap.py`, numpy and scipy only).

Weighted least-squares unwrapping via the DCT Poisson solver
(Ghiglia & Romero, JOSA A 1994): solve ∇²φ = ρ where ρ is built from the
wrapped phase differences. Exact for consistent (residue-free) phase
fields, smooth least-squares estimate otherwise — appropriate for the
liver common-phase maps the reference unwraps (data.py:109-111).
"""

from __future__ import annotations

import numpy as np
from scipy.fft import dctn, idctn


def _wrap(x: np.ndarray) -> np.ndarray:
    return np.mod(x + np.pi, 2 * np.pi) - np.pi


def unwrap_phase_2d(psi: np.ndarray) -> np.ndarray:
    """Least-squares unwrap of a single wrapped 2-D phase image (radians)."""
    psi = np.asarray(psi, np.float64)
    h, w = psi.shape
    dx = _wrap(np.diff(psi, axis=1))
    dy = _wrap(np.diff(psi, axis=0))
    rho = np.zeros_like(psi)
    rho[:, :-1] += dx
    rho[:, 1:] -= dx
    rho[:-1, :] += dy
    rho[1:, :] -= dy

    dct_rho = dctn(rho, norm="ortho")
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    denom = 2.0 * (np.cos(np.pi * xx / w) + np.cos(np.pi * yy / h) - 2.0)
    denom[0, 0] = 1.0
    phi = dct_rho / denom
    phi[0, 0] = dct_rho[0, 0]
    out = idctn(phi, norm="ortho")
    # Preserve the mean of the input (the solver fixes the DC term freely).
    out += psi.mean() - out.mean()
    return out.astype(psi.dtype)


def unwrap_slices(x: np.ndarray) -> np.ndarray:
    """Unwrap each slice of (n, H, W); returns (n, H, W, 1) as the reference
    helper does (data.py:45-49)."""
    y = np.zeros_like(x)
    for i in range(x.shape[0]):
        y[i] = unwrap_phase_2d(x[i])
    return y[..., None]
