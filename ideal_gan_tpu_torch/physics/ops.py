"""IDEAL signal-model operators: forward synthesis and map fitting (port of
`ideal_gan_tpu/physics/ops.py`).

Layouts follow the JAX package: acquisitions MEBCRN (nb, ne, H, W, 2[re,im])
and parameter maps (nb, n_maps, H, W, 2). The per-voxel linear algebra is
batched complex64 matmuls (nb, ns, ne) × (nb, ne, nv). These functions are
the plain PyTorch versions, differentiable by autograd: `fit_rho` is what
the fit kernel of `ops/ideal.py` is held against, `cycle_full` the cycle
kernel, and both give the kernels' backwards.

Normalization: field maps are stored as φ/fm_sc, R2* as r2s/r2_sc,
water/fat as ρ/rho_sc.

`cse_mag_fit` is the magnitude-domain fit, the plain version of the
magnitude fit kernel (`ops.ideal.cse_mag_fused`) and its backward.

`synthesize_mag` and `synthesize_mag_phase` are the forward models of the
(FF, PD, phase) and the separate magnitude/phase parameterizations; the
latter carries the bipolar readout phase (`_bipolar_phase`, scaled by 4π),
as do `synthesize`'s optional last map row and `fit_rho`'s (scaled by π).
The two take their bipolar rows under JAX's own conditions, which differ:
`synthesize` when the maps have more than ns + 1 rows, `fit_rho` when
param_maps has more than 3.
"""

from __future__ import annotations

from typing import NamedTuple

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


def _phasor(te: torch.Tensor, xi: torch.Tensor, sign: float,
            extra: torch.Tensor | None = None) -> torch.Tensor:
    """W^± = exp(±2πi·te·ξ [+ extra]) over (nb, ne, nv); te (nb, ne, 1),
    `extra` a complex exponent broadcast against (nb, ne, nv)."""
    expo = sign * 2j * np.pi * te.to(torch.complex64) * xi
    if extra is not None:
        expo = expo + extra
    return torch.exp(expo)


def _bipolar_phase(pha_bip: torch.Tensor, ne: int,
                   scale: float) -> torch.Tensor:
    """The alternating-readout (bipolar) phase exponent i·(−1)ⁿ·scale·φ_bip
    for echoes n = 1..ne: pha_bip (nb, H, W) → complex64 (nb, ne, nv)."""
    nb = pha_bip.shape[0]
    signs = torch.tensor((-1.0) ** np.arange(1, ne + 1), dtype=torch.float32,
                         device=pha_bip.device)
    pha = pha_bip.reshape(nb, 1, -1).float() * scale * signs[None, :, None]
    return torch.complex(torch.zeros_like(pha), pha)


def synthesize(out_maps: torch.Tensor, te: torch.Tensor, field: float = 1.5,
               r2_sc: float = R2_SC, fm_sc: float = FM_SC,
               rho_sc: float = RHO_SC,
               species: SpeciesModel = WATER_FAT_7PEAK) -> torch.Tensor:
    """Forward model S_e = exp(2πi·te_e·ξ) · Σ_s M[e,s]·ρ_s with
    ξ = φ + i·relu(R2*)/2π.

    out_maps: (nb, ns + 1, H, W, 2) rows [water(re,im), fat(re,im), (φ,
    R2*)], and with a further row its channel 0 is the bipolar phase
    φ_bip: e^{i(−1)ⁿπ·φ_bip} multiplies echo n = 1..ne. te: (nb, ne, 1).
    Returns acquisitions (nb, ne, H, W, 2).
    """
    nb, nm, hgt, wdt, _ = out_maps.shape
    ne = te.shape[1]
    ns = species.n_species
    m = mx.model_matrix(te, field, species)  # (nb, ne, ns)
    rho = _to_complex(out_maps[:, :ns]) * rho_sc
    rho_mtx = rho.reshape(nb, ns, -1)
    r2s = torch.clamp(out_maps[:, ns, ..., 1], min=0.0) * r2_sc
    phi = out_maps[:, ns, ..., 0] * fm_sc
    extra = None
    if nm > ns + 1:
        extra = _bipolar_phase(out_maps[:, -1, ..., 0], ne, np.pi)
    wp = _phasor(te, _xi(phi, r2s), +1.0, extra)
    smtx = wp * (m @ rho_mtx)
    return _from_complex(smtx.reshape(nb, ne, hgt, wdt))


def synthesize_mag(out_maps: torch.Tensor, te: torch.Tensor,
                   field: float = 1.5, r2_sc: float = R2_SC,
                   fm_sc: float = FM_SC, rho_sc: float = RHO_SC,
                   species: SpeciesModel = WATER_FAT_7PEAK) -> torch.Tensor:
    """The (FF, PD, common phase) forward model: out_maps rows [(FF, ·),
    (PD, R2*), (WF phase, φ)], the common water/fat phase 4π·(row 2, ch
    0). Returns acquisitions (nb, ne, H, W, 2)."""
    nb, _, hgt, wdt, _ = out_maps.shape
    ne = te.shape[1]
    m = mx.model_matrix(te, field, species)
    ff = out_maps[:, 0, ..., 0]
    pd = out_maps[:, 1, ..., 0]
    r2s = out_maps[:, 1, ..., 1] * r2_sc
    pha_rho = out_maps[:, 2, ..., 0] * np.pi * 4.0
    phi = out_maps[:, 2, ..., 1] * fm_sc
    common = torch.polar(torch.ones_like(pha_rho), pha_rho)
    rho_w = ((1.0 - ff) * pd * rho_sc) * common
    rho_f = (ff * pd * rho_sc) * common
    rho_mtx = torch.stack([rho_w, rho_f], dim=1).reshape(nb, 2, -1)
    wp = _phasor(te, _xi(phi, r2s), +1.0)
    smtx = wp * (m @ rho_mtx)
    return _from_complex(smtx.reshape(nb, ne, hgt, wdt))


def synthesize_mag_phase(out_maps: torch.Tensor, te: torch.Tensor,
                         field: float = 1.5, r2_sc: float = R2_SC,
                         fm_sc: float = FM_SC, rho_sc: float = RHO_SC,
                         species: SpeciesModel = WATER_FAT_7PEAK
                         ) -> torch.Tensor:
    """The separate magnitude/phase forward model: out_maps (nb, 2, H, W,
    4) rows [(|W|, |F|, R2*, ·), (φ_W, φ_F, φ, φ_bip)], the phases scaled
    by 4π, the bipolar term alternating per echo. Returns acquisitions
    (nb, ne, H, W, 2)."""
    nb, _, hgt, wdt, _ = out_maps.shape
    ne = te.shape[1]
    m = mx.model_matrix(te, field, species)
    mag_rho = out_maps[:, 0, ..., :2] * rho_sc  # (nb, H, W, 2)
    pha_rho = out_maps[:, 1, ..., :2] * (4.0 * np.pi)
    rho = torch.polar(mag_rho, pha_rho).permute(0, 3, 1, 2)  # (nb, 2, H, W)
    rho_mtx = rho.reshape(nb, 2, -1)
    r2s = out_maps[:, 0, ..., 2] * r2_sc
    phi = out_maps[:, 1, ..., 2] * fm_sc
    extra = _bipolar_phase(out_maps[:, 1, ..., 3], ne, 4.0 * np.pi)
    wp = _phasor(te, _xi(phi, r2s), +1.0, extra)
    smtx = wp * (m @ rho_mtx)
    return _from_complex(smtx.reshape(nb, ne, hgt, wdt))


def fit_rho(acqs: torch.Tensor, param_maps: torch.Tensor, te: torch.Tensor,
            field: float = 1.5, r2_sc: float = R2_SC, fm_sc: float = FM_SC,
            rho_sc: float = RHO_SC, phase_constraint: bool = False,
            acq_demod: bool = False,
            species: SpeciesModel = WATER_FAT_7PEAK) -> torch.Tensor:
    """Least-squares water/fat inversion ρ̂ = M⁺ W⁻ S / rho_sc.

    acqs (nb, ne, H, W, 2); param_maps (nb, ≥1, H, W, 2) with row 0 =
    (φ, R2*); with more than 3 rows, channel 0 of the last is the bipolar
    phase, demodulated as e^{−i(−1)ⁿπ·φ_bip} (JAX's condition, not
    `synthesize`'s). te (nb, ne, 1). Returns ρ maps (nb, ns, H, W, 2)
    float32, and with `acq_demod` also the demodulated echoes W⁻S (nb, ne,
    H, W, 2). With `phase_constraint`, water and fat share one phase,
    estimated from the LS solution as ½·angle(Σ_s ρ_s·(H⁺ρ)_s) (no
    conjugate, as the reference has it), and their magnitudes are
    |H⁺|·Re(ρ·e^{−iφ}). The plain version of the fit kernel (`ops.ideal`),
    which has no phase constraint, bipolar row or demodulated output.
    """
    nb, ne, hgt, wdt, _ = acqs.shape
    ns = species.n_species
    m = mx.model_matrix(te, field, species)
    m_pinv = mx.pinv_normal(m)
    smtx = _to_complex(acqs).reshape(nb, ne, -1)
    phi = param_maps[:, 0, ..., 0] * fm_sc
    r2s = param_maps[:, 0, ..., 1] * r2_sc
    extra = None
    if param_maps.shape[1] > 3:
        extra = -_bipolar_phase(param_maps[:, -1, ..., 0], ne, np.pi)
    wms = _phasor(te, _xi(phi, r2s), -1.0, extra) * smtx
    mwms = m_pinv @ wms  # (nb, ns, nv)
    if phase_constraint:
        h_pinv = mx.phase_constraint_matrix(m, m_pinv)  # (nb, ns, ns)
        mhmwms = torch.sum(mwms * (h_pinv @ mwms), dim=1, keepdim=True)
        rho_pha = 0.5 * torch.angle(mhmwms)  # (nb, 1, nv)
        phasor = torch.polar(torch.ones_like(rho_pha), rho_pha)
        rho_mag = h_pinv.abs() @ (mwms * phasor.conj()).real
        mwms = rho_mag * phasor
    rho = _from_complex(mwms.reshape(nb, ns, hgt, wdt) / rho_sc)
    if acq_demod:
        return rho, _from_complex(wms.reshape(nb, ne, hgt, wdt))
    return rho


def _field_maps(param_maps: torch.Tensor, fm_sc: float, r2_sc: float):
    """(φ, R2*) in physical units from row 0 of `param_maps`; a 1-channel
    row holds R2* only (φ = 0)."""
    if param_maps.shape[-1] > 1:
        return (param_maps[:, 0, ..., 0] * fm_sc,
                param_maps[:, 0, ..., 1] * r2_sc)
    r2s = param_maps[:, 0, ..., 0] * r2_sc
    return torch.zeros_like(r2s), r2s


def cycle_full(acqs: torch.Tensor, param_maps: torch.Tensor,
               te: torch.Tensor, field: float = 1.5, r2_sc: float = R2_SC,
               fm_sc: float = FM_SC, rho_sc: float = RHO_SC,
               species: SpeciesModel = WATER_FAT_7PEAK):
    """IDEAL cycle returning the LS water/fat maps and the reprojected
    acquisitions, the (A2B_WF, A2B2A) pair of the unsupervised loss:
    ρ = M⁺W⁻A / rho_sc and Â = W⁺MM⁺W⁻A.

    acqs (nb, ne, H, W, 2); param_maps (nb, 1, H, W, 2) with channels
    (φ, R2*), or (nb, 1, H, W, 1) holding R2* only; te (nb, ne, 1).
    Returns (ρ (nb, ns, H, W, 2), Â (nb, ne, H, W, 2)) float32. The plain
    version of the cycle kernel (`ops.ideal.cycle_full_fused`).
    """
    nb, ne, hgt, wdt, _ = acqs.shape
    ns = species.n_species
    m = mx.model_matrix(te, field, species)
    m_pinv = mx.pinv_normal(m)
    smtx = _to_complex(acqs).reshape(nb, ne, -1)
    phi, r2s = _field_maps(param_maps, fm_sc, r2_sc)
    xi = _xi(phi, r2s)
    wm = _phasor(te, xi, -1.0)
    wp = _phasor(te, xi, +1.0)
    mwms = m_pinv @ (wm * smtx)  # (nb, ns, nv) LS coefficients
    smtx_hat = wp * (m @ mwms)
    rho = _from_complex(mwms.reshape(nb, ns, hgt, wdt) / rho_sc)
    recon = _from_complex(smtx_hat.reshape(nb, ne, hgt, wdt))
    return rho, recon


def cycle(acqs: torch.Tensor, param_maps: torch.Tensor, te: torch.Tensor,
          field: float = 1.5, r2_sc: float = R2_SC, fm_sc: float = FM_SC,
          species: SpeciesModel = WATER_FAT_7PEAK) -> torch.Tensor:
    """IDEAL cycle Â = W⁺MM⁺W⁻A: demodulate by the candidate (φ, R2*)
    phasor, project onto span(M), remodulate. ‖A − Â‖² is the unsupervised
    physics loss. Layouts as `cycle_full`; returns Â."""
    return cycle_full(acqs, param_maps, te, field, r2_sc, fm_sc, RHO_SC,
                      species)[1]


class CSEMagResult(NamedTuple):
    """Outputs of the magnitude-domain LS fit."""
    rho: torch.Tensor          # (nb, ns, H, W, 1) |W|, |F| / rho_sc
    recon: torch.Tensor        # (nb, ne, H, W, 1) reconstructed |S|
    demod: torch.Tensor        # (nb, ne, H, W, 1) demodulated squared signal
    ls_coeffs: torch.Tensor    # (nb, 3, H, W, 1) LS (a, b, c) / rho_sc²
    uncertainty: torch.Tensor  # (nb, 1, H, W, 1) rank-1 ratio λmin/λmax


def _demod(smtx: torch.Tensor, maps: torch.Tensor, te: torch.Tensor,
           r2_sc: float) -> torch.Tensor:
    """(e^{te·R2*}·|S|)² over (nb, ne, nv): |S| flattened (nb, ne, nv), R2*
    from channel 0 of row 0 of `maps` (nb, ≥1, H, W, ≥1)."""
    r2s = (maps[:, 0, ..., 0] * r2_sc).reshape(maps.shape[0], 1, -1)
    return torch.square(torch.exp(te.float() * r2s) * smtx)


def mag_demod(acqs: torch.Tensor, maps: torch.Tensor, te: torch.Tensor,
              r2_sc: float = R2_SC) -> torch.Tensor:
    """The `demod` output of `cse_mag_fit`: (e^{te·R2*}·|S|)², (nb, ne, H,
    W, 1), with R2* channel 0 of `maps` (the fitted R2*, or the Rician ν)."""
    nb, ne, hgt, wdt, _ = acqs.shape
    smtx = acqs[..., 0].reshape(nb, ne, -1)
    return _demod(smtx, maps, te, r2_sc).reshape(nb, ne, hgt, wdt, 1)


def cse_mag_fit(acqs: torch.Tensor, out_maps: torch.Tensor, te: torch.Tensor,
                field: float = 1.5, r2_sc: float = R2_SC,
                rho_sc: float = RHO_SC, r2s_nu: torch.Tensor | None = None,
                species: SpeciesModel = WATER_FAT_7PEAK) -> CSEMagResult:
    """Magnitude-only water/fat LS fit: demodulate |S|² by e^{2·te·R2*},
    fit the quadratic model |S|² ≈ A·(a, b, c) per voxel through A⁺,
    recover rank-1 (|W|, |F|) with the closed-form 2×2 eigensolve, and
    reproject |Ŝ|.

    acqs: magnitude echoes (nb, ne, H, W, 1); out_maps (nb, 1, H, W, ≥1)
    with channel 0 = normalized R2*; te (nb, ne, 1). `r2s_nu` (the Rician
    ν, normalized, as out_maps) replaces R2* in the `demod` output only.
    The plain version of the magnitude fit kernel (`ops.ideal`)."""
    nb, ne, hgt, wdt, _ = acqs.shape
    ns = species.n_species
    a, a_pinv = mx.mag_design_matrix(mx.model_matrix(te, field, species))
    smtx = acqs[..., 0].reshape(nb, ne, -1)
    wms = _demod(smtx, out_maps, te, r2_sc)
    awms = a_pinv @ wms  # (nb, 3, nv)
    aawms = a @ awms     # (nb, ne, nv)
    # the double where keeps sqrt'(0) = inf out of the gradient where the
    # fitted |S|² ≤ 1e-6 (every background voxel of the synthetic cohort)
    pos = aawms > 1e-6
    aawms_safe = torch.where(pos, aawms, torch.ones_like(aawms))
    r2s = (out_maps[:, 0, ..., 0] * r2_sc).reshape(nb, 1, -1)
    wp = torch.exp(-te.float() * r2s)
    smtx_hat = wp * torch.where(pos, torch.sqrt(aawms_safe),
                                torch.zeros_like(aawms))
    demod = wms if r2s_nu is None else _demod(smtx, r2s_nu, te, r2_sc)
    rho_hat, rho_unc = mx.eigenvals_2x2(awms.transpose(-1, -2))

    def img(x, k):  # (nb, k, nv) → (nb, k, H, W, 1)
        return x.reshape(nb, k, hgt, wdt, 1)

    return CSEMagResult(
        rho=img(rho_hat.transpose(-1, -2), ns) / rho_sc,
        recon=img(smtx_hat, ne), demod=img(demod, ne),
        ls_coeffs=img(awms, 3) / (rho_sc ** 2),
        uncertainty=img(rho_unc.transpose(-1, -2), 1))


def mag_cycle(acqs: torch.Tensor, out_maps: torch.Tensor, te: torch.Tensor,
              **kw) -> torch.Tensor:
    """Magnitude-domain cycle: |S| → LS fit → reconstructed |Ŝ|."""
    return cse_mag_fit(acqs, out_maps, te, **kw).recon
