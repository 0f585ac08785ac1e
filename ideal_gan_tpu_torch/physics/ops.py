"""IDEAL signal-model operators: forward synthesis and map fitting (port of
`ideal_gan_tpu/physics/ops.py`).

Layouts follow the JAX package: acquisitions MEBCRN (nb, ne, H, W, 2[re,im])
and parameter maps (nb, n_maps, H, W, 2). The per-voxel linear algebra is
batched complex64 matmuls (nb, ns, ne) × (nb, ne, nv). These functions are
the plain PyTorch versions: `fit_rho` is what the fit kernel of
`ops/ideal.py` is held against.

Normalization: field maps are stored as φ/fm_sc, R2* as r2s/r2_sc,
water/fat as ρ/rho_sc.

Not ported yet: the bipolar readout phase, the shared-phase constraint and
the demodulated-echo output of `fit_rho`, and the cycle / magnitude
operators.
"""

from __future__ import annotations

import numpy as np
import torch

from . import matrix as mx
from .constants import FM_SC, R2_SC, RHO_SC, SpeciesModel, WATER_FAT_7PEAK

_2PI = 2.0 * np.pi


def _to_complex(acqs: torch.Tensor) -> torch.Tensor:
    """MEBCRN (nb, k, H, W, 2) → complex64 (nb, k, H, W)."""
    return torch.complex(acqs[..., 0].float(), acqs[..., 1].float())


def _from_complex(s: torch.Tensor) -> torch.Tensor:
    """complex (nb, k, H, W) → MEBCRN (nb, k, H, W, 2) float32."""
    return torch.stack([s.real, s.imag], dim=-1).float()


def _xi(phi: torch.Tensor, r2s: torch.Tensor) -> torch.Tensor:
    """ξ = φ + i·R2*/2π, flattened to (nb, 1, nv) complex64."""
    nb = phi.shape[0]
    return torch.complex(phi.float(), (r2s / _2PI).float()).reshape(nb, 1, -1)


def _phasor(te: torch.Tensor, xi: torch.Tensor, sign: float) -> torch.Tensor:
    """W^± = exp(±2πi·te·ξ) over (nb, ne, nv); te (nb, ne, 1)."""
    return torch.exp(sign * 2j * np.pi * te.to(torch.complex64) * xi)


def synthesize(out_maps: torch.Tensor, te: torch.Tensor, field: float = 1.5,
               r2_sc: float = R2_SC, fm_sc: float = FM_SC,
               rho_sc: float = RHO_SC,
               species: SpeciesModel = WATER_FAT_7PEAK) -> torch.Tensor:
    """Forward model S_e = exp(2πi·te_e·ξ) · Σ_s M[e,s]·ρ_s with
    ξ = φ + i·relu(R2*)/2π.

    out_maps: (nb, 3, H, W, 2) rows [water(re,im), fat(re,im), (φ, R2*)].
    te: (nb, ne, 1). Returns acquisitions (nb, ne, H, W, 2).
    """
    nb, nm, hgt, wdt, _ = out_maps.shape
    ne = te.shape[1]
    ns = species.n_species
    if nm > ns + 1:
        raise NotImplementedError(
            "synthesize: the bipolar-phase map row is not ported yet "
            "(ROADMAP Queue 1)")
    m = mx.model_matrix(te, field, species)  # (nb, ne, ns)
    rho = _to_complex(out_maps[:, :ns]) * rho_sc
    rho_mtx = rho.reshape(nb, ns, -1)
    r2s = torch.clamp(out_maps[:, ns, ..., 1], min=0.0) * r2_sc
    phi = out_maps[:, ns, ..., 0] * fm_sc
    wp = _phasor(te, _xi(phi, r2s), +1.0)
    smtx = wp * (m @ rho_mtx)
    return _from_complex(smtx.reshape(nb, ne, hgt, wdt))


def fit_rho(acqs: torch.Tensor, param_maps: torch.Tensor, te: torch.Tensor,
            field: float = 1.5, r2_sc: float = R2_SC, fm_sc: float = FM_SC,
            rho_sc: float = RHO_SC, phase_constraint: bool = False,
            acq_demod: bool = False,
            species: SpeciesModel = WATER_FAT_7PEAK) -> torch.Tensor:
    """Least-squares water/fat inversion ρ̂ = M⁺ W⁻ S / rho_sc.

    acqs (nb, ne, H, W, 2); param_maps (nb, ≥1, H, W, 2) with row 0 =
    (φ, R2*); te (nb, ne, 1). Returns ρ maps (nb, ns, H, W, 2) float32.
    The plain version of the fit kernel (`ops.ideal`).
    """
    if phase_constraint or acq_demod or param_maps.shape[1] > 3:
        raise NotImplementedError(
            "fit_rho: the phase-constraint, acq_demod and bipolar branches "
            "are not ported yet (ROADMAP Queue 1)")
    nb, ne, hgt, wdt, _ = acqs.shape
    ns = species.n_species
    m_pinv = mx.pinv_normal(mx.model_matrix(te, field, species))
    smtx = _to_complex(acqs).reshape(nb, ne, -1)
    phi = param_maps[:, 0, ..., 0] * fm_sc
    r2s = param_maps[:, 0, ..., 1] * r2_sc
    wm = _phasor(te, _xi(phi, r2s), -1.0)
    mwms = m_pinv @ (wm * smtx)  # (nb, ns, nv)
    return _from_complex(mwms.reshape(nb, ns, hgt, wdt) / rho_sc)
