"""First-order uncertainty propagation through the IDEAL model (port of
`ideal_gan_tpu/physics/uncertainty.py`).

Posteriors are plain (mean, variance) tensors in normalized units, the
(μ, σ) of the Bayesian network heads. The per-voxel GLS normal matrix
MᴴΣ⁻¹M is one complex64 einsum over the echo axis and its 2×2 inverse is
closed-form (`matrix.small_inv`): no per-voxel diagonal covariance is
built. Plain PyTorch, differentiable by autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import matrix as mx
from .constants import FM_SC, R2_SC, RHO_SC, SpeciesModel, WATER_FAT_7PEAK
from .ops import _from_complex, _phasor, _to_complex, _xi


class Posterior(NamedTuple):
    """A (mean, variance) posterior over a map, in normalized units."""
    mean: torch.Tensor
    variance: torch.Tensor


def _rav(x: torch.Tensor, nb: int) -> torch.Tensor:
    return x.reshape(nb, 1, -1)


def pdff_uncertainty(acqs: torch.Tensor, phi: Posterior, r2s: Posterior,
                     te: torch.Tensor, field: float = 1.5,
                     r2_sc: float = R2_SC, fm_sc: float = FM_SC,
                     rho_sc: float = RHO_SC, rem_r2: bool = False,
                     species: SpeciesModel = WATER_FAT_7PEAK):
    """Water/fat GLS estimate and covariance under (φ, R2*) posteriors.

    Per voxel, a heteroscedastic per-echo variance Σ_y from the first-order
    variance of the demodulation phasor, then the generalized LS problem
    ρ_cov = (MᴴΣ⁻¹M)⁻¹, ρ̂ = ρ_cov·MᴴΣ⁻¹·(W⁻S).

    acqs (nb, ne, H, W, 2); the posteriors' fields (nb, H, W), normalized;
    te (nb, ne, 1). Returns (ρ (nb, ns, H, W, 2), rho_var (nb, ns², H, W,
    1)), rho_var the |entries| of the flattened covariance.
    """
    nb, ne, hgt, wdt, _ = acqs.shape
    ns = species.n_species
    m = mx.model_matrix(te, field, species)  # (nb, ne, ns)
    p0 = mx.null_projector(m, mx.pinv_normal(m))
    smtx = _to_complex(acqs).reshape(nb, ne, -1)

    phi_mean = phi.mean * fm_sc
    phi_var = phi.variance * (fm_sc ** 2)
    if rem_r2:
        r2s_mean = torch.zeros_like(phi_mean)
        r2s_var = torch.zeros_like(phi_var)
    else:
        r2s_mean = r2s.mean * r2_sc
        r2s_var = r2s.variance * (r2_sc ** 2)

    xi = _xi(phi_mean, r2s_mean)
    wm = _phasor(te, xi, -1.0)
    wp = _phasor(te, xi, +1.0)

    te_r = te.float()  # (nb, ne, 1)
    wm_var = 1.0 - torch.exp(-torch.square(2.0 * np.pi * te_r)
                             * _rav(phi_var, nb))
    if not rem_r2:
        wm_var = wm_var + torch.exp(te_r * _rav(r2s_mean, nb)) * (
            torch.square(te_r) * _rav(r2s_var, nb))

    # per-echo signal variance: the phasor's variance times the null-space
    # reprojection power plus the raw signal power
    s_var = torch.square((wp * (p0 @ wm)).abs())  # (nb, ne, nv)
    y_sigma = wm_var * s_var + wm_var * torch.square(smtx.abs())
    y_sigma_inv = torch.where(y_sigma > 0, 1.0 / y_sigma,
                              torch.zeros_like(y_sigma))
    y_sigma_inv = y_sigma_inv.to(torch.complex64)

    # N[b,v,s,t] = Σ_e conj(M)[b,e,s]·Σ⁻¹[b,e,v]·M[b,e,t]
    mc = m.conj()
    normal = torch.einsum("bes,bev,bet->bvst", mc, y_sigma_inv, m)
    rho_cov = mx.small_inv(normal)  # (nb, nv, ns, ns)
    rhs = torch.einsum("bes,bev->bvs", mc, y_sigma_inv * (wm * smtx))
    rho_hat = torch.einsum("bvst,bvt->bsv", rho_cov, rhs) / rho_sc

    res_rho = _from_complex(rho_hat.reshape(nb, ns, hgt, wdt))
    rho_var = rho_cov.abs().reshape(nb, -1, ns * ns).transpose(-1, -2)
    res_rho_var = rho_var.reshape(nb, ns * ns, hgt, wdt)[..., None] \
        / (rho_sc ** 2)
    return res_rho, res_rho_var


def acq_uncertainty(rho_maps: torch.Tensor, phi: Posterior, r2s: Posterior,
                    te: torch.Tensor, field: float = 1.5,
                    r2_sc: float = R2_SC, fm_sc: float = FM_SC,
                    rho_sc: float = RHO_SC, rem_r2: bool = False,
                    only_mag: bool = False,
                    species: SpeciesModel = WATER_FAT_7PEAK) -> torch.Tensor:
    """Per-echo signal variance from map posteriors, by the delta method
    through the forward phasor: Var[S_e] ≈ Wp_var_e·|(Mρ)_e|².

    rho_maps (nb, ≥2, H, W, 2) water/fat rows; the posteriors' fields
    (nb, H, W), normalized (φ's mean is not read). Returns (nb, ne, H, W,
    1 or 2) float32, duplicated over re/im unless `only_mag`.
    """
    nb, _, hgt, wdt, _ = rho_maps.shape
    ne = te.shape[1]
    m = mx.model_matrix(te, field, species)
    rho_mtx = (_to_complex(rho_maps[:, :2]) * rho_sc).reshape(nb, 2, -1)

    phi_var = phi.variance * (fm_sc ** 2)
    if rem_r2:
        r2s_mean = torch.zeros_like(phi_var)
        r2s_var = torch.zeros_like(phi_var)
    else:
        r2s_mean = r2s.mean * r2_sc
        r2s_var = r2s.variance * (r2_sc ** 2)

    te_r = te.float()
    wp_var = 1.0 - torch.exp(-torch.square(2.0 * np.pi * te_r)
                             * _rav(phi_var, nb))
    if not rem_r2:
        wp_var = wp_var + torch.exp(-te_r * _rav(r2s_mean, nb)) * (
            torch.square(te_r) * _rav(r2s_var, nb))

    s_var = wp_var * torch.square((m @ rho_mtx).abs())  # (nb, ne, nv)
    res = s_var.reshape(nb, ne, hgt, wdt)[..., None]
    return res if only_mag else torch.cat([res, res], dim=-1)
