"""Modeling matrices for the IDEAL signal model (port of
`ideal_gan_tpu/physics/matrix.py`).

The matrices are tiny (n_echoes ≤ 12 × n_species ≤ 5) and shared across all
voxels of a batch row, so pseudo-inverses come from Hermitian normal
equations with closed-form 2×2 / 3×3 inverses, not QR. All functions are
batched over the leading axis and run on the device of their input.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import SpeciesModel, WATER_FAT_7PEAK


def _inv_2x2(a: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 2×2 matrices (..., 2, 2), any dtype."""
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv = torch.stack([
        torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
        torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
    ], dim=-2)
    return inv / det[..., None, None]


def _inv_3x3(a: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched 3×3 matrices."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def small_inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse of batched small square matrices: closed forms for 1×1,
    2×2 and 3×3, `torch.linalg.inv` above."""
    n = a.shape[-1]
    if n == 1:
        return 1.0 / a
    if n == 2:
        return _inv_2x2(a)
    if n == 3:
        return _inv_3x3(a)
    return torch.linalg.inv(a)


def pinv_normal(m: torch.Tensor) -> torch.Tensor:
    """Left pseudo-inverse via normal equations: (MᴴM)⁻¹Mᴴ.
    m: (..., ne, ns) → (..., ns, ne)."""
    mh = m.transpose(-1, -2).conj()
    return small_inv(mh @ m) @ mh


def model_matrix(te: torch.Tensor, field: float = 1.5,
                 species: SpeciesModel = WATER_FAT_7PEAK) -> torch.Tensor:
    """Chemical-shift modeling matrix M, shape (nb, ne, ns) complex64.

    M[e, s] = Σ_p exp(2πi·te_e·(f_p + i·d_p/2π)) · A[p, s].
    te: (nb, ne, 1) or (nb, ne) float, seconds.
    """
    if te.ndim == 3:
        te = te[..., 0]
    dev = te.device
    te_c = te.to(torch.complex64)[..., None]  # (nb, ne, 1)
    freqs = torch.as_tensor(species.freqs_hz(field).astype(np.complex64),
                            device=dev)
    decay = species.r2_peak_vec()
    if decay is not None:
        freqs = freqs + 1j * torch.as_tensor(
            decay.astype(np.float32), device=dev) / (2.0 * np.pi)
    phase = 2j * np.pi * te_c * freqs[None, None, :]  # (nb, ne, np)
    amps = torch.as_tensor(species.amps_matrix().astype(np.complex64),
                           device=dev)
    return torch.exp(phase) @ amps
