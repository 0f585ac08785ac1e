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
    m: (..., ne, ns) → (..., ns, ne). More than 3 species (the fatty-acid
    model's 5, whose MᴴM has condition ~1e3 at 12 echoes) are solved in
    double precision and rounded back to m's dtype: in float32 the normal
    equations put the fit ~4e-4 of its scale from the exact solution, and
    the card's float32 ρ as far from the CPU's (the JAX package solves
    them in float32)."""
    if m.shape[-1] > 3 and m.dtype in (torch.float32, torch.complex64):
        wide = torch.complex128 if m.is_complex() else torch.float64
        return pinv_normal(m.to(wide)).to(m.dtype)
    mh = m.transpose(-1, -2).conj()
    return small_inv(mh @ m) @ mh


def null_projector(m: torch.Tensor, m_pinv: torch.Tensor) -> torch.Tensor:
    """P0 = I − M·M⁺, the projector onto the orthogonal complement of
    span(M), Hermitian-symmetrized. m (nb, ne, ns), m_pinv (nb, ns, ne) →
    (nb, ne, ne) in m's dtype."""
    ne = m.shape[-2]
    p0 = torch.eye(ne, dtype=m.dtype, device=m.device) - m @ m_pinv
    return 0.5 * (p0 + p0.transpose(-1, -2).conj())


def phase_constraint_matrix(m: torch.Tensor,
                            m_pinv: torch.Tensor) -> torch.Tensor:
    """H⁺ = inv(sym(Re(M⁺M))), used by the shared-phase constraint of the
    map fit. For full-rank M this is numerically ≈ identity; computed
    exactly for parity. m (nb, ne, ns), m_pinv (nb, ns, ne) → (nb, ns, ns)
    in m's complex dtype."""
    h = (m_pinv @ m).real
    return small_inv(0.5 * (h + h.transpose(-1, -2))).to(m.dtype)


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


def mag_columns(m: torch.Tensor) -> torch.Tensor:
    """A = [|M_w|, Re(M_f), |M_f|²], the columns of |S|² ≈ A·(a, b, c):
    m (nb, ne, 2) complex → (nb, ne, 3) float32."""
    m_abs = m.abs()
    return torch.cat([m_abs[..., :1], m.real[..., 1:],
                      m_abs[..., 1:].square()], dim=-1).float()


def mag_design_matrix(m: torch.Tensor, gen_ata_pinv: bool = False):
    """Design matrix of the magnitude-only fit (`mag_columns`): m (nb, ne,
    2) complex → (A (nb, ne, 3), A⁺ = (AᵀA)⁻¹Aᵀ (nb, 3, ne)), float32, and
    with `gen_ata_pinv` also (AᵀA)⁻¹ (nb, 3, 3)."""
    a = mag_columns(m)
    at = a.transpose(-1, -2)
    gram_inv = small_inv(at @ a)
    if gen_ata_pinv:
        return a, gram_inv @ at, gram_inv
    return a, gram_inv @ at


def eigenvals_2x2(x: torch.Tensor, eps: float = 1e-12):
    """Closed-form eigensolve of the per-voxel symmetric 2×2 matrices
    [[a, b/2], [b/2, c]] packed as (..., 3) = (a, b, c): the rank-1
    (water, fat) magnitude estimate √λmax·v_max (..., 2) and the rank-1
    ratio λmin/λmax (..., 1), both 0 where λmax ≤ 0."""
    a, b, c = x[..., :1], x[..., 1:2], x[..., 2:]
    adiff_half = 0.5 * (a - c)
    b_half = 0.5 * b
    delta = torch.sqrt(adiff_half * adiff_half + b_half * b_half + eps)
    lam_max = 0.5 * (a + c) + delta
    lam_min = 0.5 * (a + c) - delta
    lam_max_pos = torch.clamp(lam_max, min=0.0)
    lam_min_pos = torch.clamp(lam_min, min=0.0)
    vx, vy = b_half, lam_max - a
    norm = torch.sqrt(vx * vx + vy * vy + eps)
    zero = torch.zeros_like(norm)
    vx = torch.where(norm > 0, vx / norm, zero)
    vy = torch.where(norm > 0, vy / norm, zero)
    # the double where keeps sqrt'(0) = inf out of the gradient where
    # λmax ≤ 0 (every background voxel of the synthetic cohort)
    pos = lam_max_pos > 0
    lam_safe = torch.where(pos, lam_max_pos, torch.ones_like(lam_max_pos))
    scale = torch.where(pos, torch.sqrt(lam_safe), zero)
    ratio = torch.where(pos, lam_min_pos / lam_safe, zero)
    return scale * torch.cat([vx, vy], dim=-1), ratio
