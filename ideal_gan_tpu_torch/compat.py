"""Reference-API compatibility layer (port of `ideal_gan_tpu/compat.py`).

Maps the reference's public `wflib` names onto the port's physics so that
reference users can migrate with little renaming. Signatures follow the
reference where practical; TF tensors become torch tensors, TFP
distributions become `prob.Normal` / `prob.Rician` or
`physics.Posterior`, and the randomized TE train takes a
`torch.Generator` where the reference used the global numpy RNG (and the
JAX package a key). Tensors stay on the device they arrive on.

    import ideal_gan_tpu_torch.compat as wf
    M, M_pinv = wf.gen_M(te)
    rho, recon = wf.acq_to_acq(acqs, param_maps, te)
"""

from __future__ import annotations

import torch

from . import physics as _ph
from .data import layouts

# module-level constants, as the reference exposes them
# (wflib/IDEAL_model.py:5-19)
species = list(_ph.WATER_FAT_7PEAK.names)
ns = _ph.WATER_FAT_7PEAK.n_species
fm_sc = _ph.FM_SC
rho_sc = _ph.RHO_SC
r2_sc = _ph.R2_SC


def gen_TEvar(n_ech, bs=1, orig=False, TE_ini_min=1.0e-3, TE_ini_d=1.4e-3,
              d_TE_min=1.6e-3, d_TE_d=1.0e-3, generator=None):
    """wflib.gen_TEvar (wflib/IDEAL_model.py:21-45): the reference train
    (TE1 1.3 ms, ΔTE 2.1 ms) with `orig`, a uniform one from the minima
    where both spreads are 0, else a randomized train drawn from
    `generator` (a `torch.Generator` seeded 0 where none is given). On the
    CPU, as the reference's numpy trains are."""
    if orig or (not TE_ini_d and not d_TE_d):
        te1 = 1.3e-3 if orig else TE_ini_min
        dte = 2.1e-3 if orig else d_TE_min
        return _ph.te_train(n_ech, bs, te1, dte)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return _ph.sample_te_train(generator, n_ech, bs, TE_ini_min, TE_ini_d,
                               d_TE_min, d_TE_d)


def gen_M(te, field=1.5, get_Mpinv=True, get_P0=False, get_H=False):
    """wflib.gen_M (wflib/IDEAL_model.py:48-77), with its return
    combinations: M; (M, M⁺); (M, P0, M⁺); (M, M⁺, H⁺)."""
    m = _ph.model_matrix(te, field)
    if not (get_Mpinv or get_P0 or get_H):
        return m
    m_pinv = _ph.pinv_normal(m)
    if get_P0 and get_Mpinv:
        return m, _ph.null_projector(m, m_pinv), m_pinv
    if get_Mpinv and not get_P0 and not get_H:
        return m, m_pinv
    if get_Mpinv and not get_P0:
        return m, m_pinv, _ph.phase_constraint_matrix(m, m_pinv)
    return m


def gen_A(M, gen_AtA_pinv=False):
    """wflib.gen_A (wflib/IDEAL_model.py:80-97): (A, A⁺[, (AᵀA)⁻¹])."""
    return _ph.mag_design_matrix(M, gen_ata_pinv=gen_AtA_pinv)


eigenvals = _ph.eigenvals_2x2


def acq_to_acq(acqs, param_maps, te=None, field=1.5, r2_sc=200.0):
    """wflib.acq_to_acq (wflib/IDEAL_model.py:142-200): the (maps, recon)
    pair the reference trainers expect; the field's protocol TE train
    where `te` is None."""
    if te is None:
        te = _ph.te_train_for_field(acqs.shape[1], acqs.shape[0], field,
                                    device=acqs.device)
    return _ph.cycle_full(acqs, param_maps, te, field=field, r2_sc=r2_sc)


def IDEAL_model(out_maps, params, r2_sc=200.0):
    """wflib.IDEAL_model (wflib/IDEAL_model.py:220-299):
    params = [field, te]."""
    return _ph.synthesize(out_maps, params[1], field=params[0], r2_sc=r2_sc)


def IDEAL_mag(out_maps, params, r2_sc=200.0):
    return _ph.synthesize_mag(out_maps, params[1], field=params[0],
                              r2_sc=r2_sc)


def IDEAL_mag_phase(out_maps, params, r2_sc=200.0):
    return _ph.synthesize_mag_phase(out_maps, params[1], field=params[0],
                                    r2_sc=r2_sc)


def CSE_mag(acqs, out_maps, params, r2_sc=200.0, demod_signal=False,
            R2_prob=False, uncertainty=False, r2s_nu=None):
    """wflib.CSE_mag (wflib/IDEAL_model.py:314-401), with its return
    combinations."""
    res = _ph.cse_mag_fit(acqs, out_maps, params[1], field=params[0],
                          r2_sc=r2_sc, r2s_nu=r2s_nu if R2_prob else None)
    if uncertainty and demod_signal:
        return res.rho, res.recon, res.demod, res.uncertainty
    if uncertainty:
        return res.rho, res.recon, res.uncertainty, res.ls_coeffs
    if demod_signal:
        return res.rho, res.recon, res.demod, res.ls_coeffs
    return res.rho, res.recon


def get_rho(acqs, param_maps, field=1.5, te=None, r2_sc=200.0,
            phase_constraint=False, MEBCRN=True, acq_demod=False):
    """wflib.get_rho (wflib/IDEAL_model.py:527-624), with the legacy 4-D
    layout: acqs (nb, H, W, 2·ne) interleaved and param_maps (nb, H, W,
    [R2*, FM]) in, legacy ρ (and demodulated echoes) out. The 1.5 T
    protocol TE train where `te` is None."""
    if te is None:
        ne = acqs.shape[1] if MEBCRN else acqs.shape[-1] // 2
        te = _ph.te_train(ne, acqs.shape[0], device=acqs.device)
    if MEBCRN:
        pm = param_maps
    else:
        acqs = layouts.acqs_to_mebcrn(acqs)
        pm = torch.stack([param_maps[..., 1], param_maps[..., 0]],
                         dim=-1)[:, None]
    out = _ph.fit_rho(acqs, pm, te, field=field, r2_sc=r2_sc,
                      phase_constraint=phase_constraint, acq_demod=acq_demod)
    if MEBCRN:
        return out
    if acq_demod:
        return tuple(layouts.acqs_from_mebcrn(x) for x in out)
    return layouts.acqs_from_mebcrn(out)


def PDFF_uncertainty(acqs, phi_post, r2s_post, te=None, r2_sc=200.0,
                     rem_R2=False):
    """wflib.PDFF_uncertainty (wflib/IDEAL_model.py:628-706); posteriors
    are objects with mean()/variance() (or those attributes), or
    `physics.Posterior`."""
    if te is None:
        te = _ph.te_train(acqs.shape[1], acqs.shape[0], device=acqs.device)
    return _ph.pdff_uncertainty(acqs, _as_posterior(phi_post),
                                _as_posterior(r2s_post), te, r2_sc=r2_sc,
                                rem_r2=rem_R2)


def acq_uncertainty(rho_maps, phi_post, r2s_post, ne=6, te=None,
                    r2_sc=200.0, field=1.5, rem_R2=False, only_mag=False):
    """wflib.acq_uncertainty (wflib/IDEAL_model.py:710-767)."""
    if te is None:
        te = _ph.te_train_for_field(ne, rho_maps.shape[0], field,
                                    device=rho_maps.device)
    return _ph.acq_uncertainty(rho_maps, _as_posterior(phi_post),
                               _as_posterior(r2s_post), te, field=field,
                               r2_sc=r2_sc, rem_r2=rem_R2, only_mag=only_mag)


def _as_posterior(p) -> _ph.Posterior:
    """A `physics.Posterior` of (nb, H, W) mean and variance from a
    distribution-like object, squeezing a UNet head's (nb, 1, H, W, 1) or
    an (nb, H, W, 1) shape."""
    if isinstance(p, _ph.Posterior):
        return p
    mean = p.mean() if callable(getattr(p, "mean", None)) else p.mean
    var = (p.variance() if callable(getattr(p, "variance", None))
           else p.variance)
    mean, var = torch.as_tensor(mean), torch.as_tensor(var)
    if mean.ndim == 5:
        mean, var = mean[:, 0, ..., 0], var[:, 0, ..., 0]
    elif mean.ndim == 4:
        mean, var = mean[..., 0], var[..., 0]
    return _ph.Posterior(mean, var)
