"""Plain IDEAL water/fat physics: the 7-peak signal model, its forward
synthesis, the least-squares map fit (with the shared-phase constraint)
and the unsupervised cycle A -> (phi, R2*) -> A_hat.

Written from the signal model S_e = exp(2 pi i te_e xi) sum_s M[e, s] rho_s,
xi = phi + i R2*/2pi, M[e, s] = sum_p exp(2 pi i te_e f_p) a[p, s]. Layouts:
acquisitions (nb, ne, H, W, 2[re, im]), maps (nb, rows, H, W, 2), te
(nb, ne, 1) in seconds. Field maps are stored as phi/300 Hz, R2* as
R2*/200 1/s, water and fat as rho/1.4. The small per-row matrices are
built in double precision and rounded to complex64; the per-voxel
products run in complex64. No kernel, no cache.
"""

from __future__ import annotations

import math

import torch

FM_SC, R2_SC, RHO_SC = 300.0, 200.0, 1.4
GYRO_HZ_PER_T = 42.58e6
# the 7-peak water/fat spectrum: chemical shifts (ppm) and amplitudes of
# the water and fat columns
PEAKS_PPM = (0.0, -3.80, -3.40, -2.60, -1.94, -0.39, 0.60)
PEAK_AMPS = ((1.0, 0.0), (0.0, 0.087), (0.0, 0.693), (0.0, 0.128),
             (0.0, 0.004), (0.0, 0.039), (0.0, 0.048))


def model_matrix(te: torch.Tensor, field: float) -> torch.Tensor:
    """M (nb, ne, 2) complex128 from te (nb, ne, 1)."""
    t = te[..., 0].to(torch.float64)[..., None]  # (nb, ne, 1)
    f = torch.tensor(PEAKS_PPM, dtype=torch.float64,
                     device=te.device) * 1e-6 * GYRO_HZ_PER_T * field
    amps = torch.tensor(PEAK_AMPS, dtype=torch.complex128, device=te.device)
    return torch.exp(2j * math.pi * t * f) @ amps


def _pinv(m: torch.Tensor) -> torch.Tensor:
    mh = m.transpose(-1, -2).conj()
    return torch.linalg.solve(mh @ m, mh)


def _complex(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(x[..., 0].float(), x[..., 1].float())


def _planes(z: torch.Tensor) -> torch.Tensor:
    return torch.stack([z.real, z.imag], dim=-1).float()


def _phasor(te: torch.Tensor, phi: torch.Tensor, r2s: torch.Tensor,
            sign: float) -> torch.Tensor:
    """exp(sign 2 pi i te (phi + i R2*/2pi)) over (nb, ne, nv)."""
    nb = phi.shape[0]
    xi = torch.complex(phi.float(), (r2s / (2 * math.pi)).float())
    xi = xi.reshape(nb, 1, -1)
    return torch.exp(sign * 2j * math.pi * te.to(torch.complex64) * xi)


def synthesize(maps: torch.Tensor, te: torch.Tensor,
               field: float = 1.5) -> torch.Tensor:
    """Acquisitions of maps rows [water, fat, (phi, R2*)], R2* clipped at
    0: (nb, ne, H, W, 2)."""
    nb, _, h, w, _ = maps.shape
    ne = te.shape[1]
    m = model_matrix(te, field).to(torch.complex64)
    rho = (_complex(maps[:, :2]) * RHO_SC).reshape(nb, 2, -1)
    phi = maps[:, 2, ..., 0] * FM_SC
    r2s = torch.clamp(maps[:, 2, ..., 1], min=0.0) * R2_SC
    s = _phasor(te, phi, r2s, 1.0) * (m @ rho)
    return _planes(s.reshape(nb, ne, h, w))


def fit_rho(acqs: torch.Tensor, pm: torch.Tensor, te: torch.Tensor,
            field: float = 1.5, phase_constraint: bool = False
            ) -> torch.Tensor:
    """Water and fat (nb, 2, H, W, 2) by least squares, M+ W- S / 1.4, at
    the maps pm (nb, 1, H, W, [phi, R2*]). With `phase_constraint` water
    and fat share one phase, half the angle of sum_s c_s (H+ c)_s (no
    conjugate), H+ = inv(sym(Re(M+ M))), and their magnitudes are
    |H+| Re(c e^{-i phase})."""
    nb, ne, h, w, _ = acqs.shape
    m = model_matrix(te, field)
    mp = _pinv(m)
    s = _complex(acqs).reshape(nb, ne, -1)
    wm = _phasor(te, pm[:, 0, ..., 0] * FM_SC, pm[:, 0, ..., 1] * R2_SC,
                 -1.0)
    c = mp.to(torch.complex64) @ (wm * s)  # (nb, 2, nv)
    if phase_constraint:
        hr = (mp @ m).real
        hp = torch.linalg.inv(0.5 * (hr + hr.transpose(-1, -2)))
        hp = hp.to(torch.complex128)
        hc = hp.to(torch.complex64) @ c
        pha = 0.5 * torch.angle(torch.sum(c * hc, dim=1, keepdim=True))
        ph = torch.polar(torch.ones_like(pha), pha)
        mag = hp.abs().float() @ (c * ph.conj()).real
        c = mag * ph
    return _planes(c.reshape(nb, 2, h, w) / RHO_SC)


def cycle(acqs: torch.Tensor, pm: torch.Tensor, te: torch.Tensor,
          field: float = 1.5) -> torch.Tensor:
    """A_hat = W+ M M+ W- A (nb, ne, H, W, 2) at the maps pm (nb, 1, H, W,
    [phi, R2*])."""
    nb, ne, h, w, _ = acqs.shape
    m = model_matrix(te, field)
    proj = (m @ _pinv(m)).to(torch.complex64)  # (nb, ne, ne)
    s = _complex(acqs).reshape(nb, ne, -1)
    phi, r2s = pm[:, 0, ..., 0] * FM_SC, pm[:, 0, ..., 1] * R2_SC
    s_hat = _phasor(te, phi, r2s, 1.0) * (
        proj @ (_phasor(te, phi, r2s, -1.0) * s))
    return _planes(s_hat.reshape(nb, ne, h, w))
