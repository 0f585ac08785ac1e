"""The IDEAL map fit on the card (counterpart of
`ideal_gan_tpu/ops/pallas_ideal.py`'s fit entry points).

For CUDA tensors every entry point launches the hand-written fit kernel
(`csrc/ideal_fit.cu`); for CPU tensors it calls the kernel's plain version,
`physics.ops.fit_rho`. A CUDA tensor the kernel cannot take raises: there is
no fallback to the plain version on the card.

    ρ_s = (1/rho_sc) · Σ_e M⁺[s,e] · e^{−2πi·te_e·ξ} · S_e,
    ξ = φ·fm_sc + i·R2*·r2_sc/2π

The TPU tiling constants of the JAX module (row tiles, the (16, 128) bf16
block rule and its f32 fallbacks) have no counterpart here: the kernel
indexes voxels directly and takes any H, W.
"""

from __future__ import annotations

import ctypes

import torch

from ..physics import matrix as mx
from ..physics import ops as pops
from ..physics.constants import FM_SC, R2_SC, RHO_SC, SpeciesModel, WATER_FAT_7PEAK
from ._build import Kernel, check_launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

FIT_KERNEL = Kernel("ideal_fit", {
    "ideal_fit": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L,
                       _L, _L, _L, _L, _L, _L, _L, _L,
                       _I, _I, _I, _F, _F, _F, _I, _P]),
})
MAX_ECHOES = 12


def _phasor_mode(uniform_te: bool | None) -> int:
    """The kernel's phasor form: 1 the uniform-TE recurrence, 0 one
    sincos/exp per echo, 2 (uniform_te=None) decided per batch row on the
    card from te itself, with the JAX package's uniformity test."""
    return 2 if uniform_te is None else int(bool(uniform_te))


def _mat_scalars(m: torch.Tensor) -> torch.Tensor:
    """(nb, a, b) complex → (nb, a*b*2) float32, interleaved re/im."""
    flat = m.reshape(m.shape[0], -1)
    return torch.stack([flat.real, flat.imag], dim=-1).reshape(
        m.shape[0], -1).float().contiguous()


def precompute_fit_matrices(te: torch.Tensor, field: float = 1.5,
                            species: SpeciesModel = WATER_FAT_7PEAK):
    """The kernel's per-row operands for a TE train: (M⁺ as (nb, 2·ns·ne)
    float32 re/im pairs, te as (nb, ne) float32). Serving reuses one
    protocol across many batches."""
    m_pinv = mx.pinv_normal(mx.model_matrix(te, field, species))
    nb, ne = te.shape[0], te.shape[1]
    return _mat_scalars(m_pinv), te.reshape(nb, ne).float().contiguous()


def _flat_strides(t: torch.Tensor, name: str):
    """(batch, plane, voxel) element strides of a (nb, k, H, W) view whose
    (H, W) block is addressable as one flat voxel axis."""
    sb, sk, sh, sw = t.stride()
    if t.shape[2] > 1 and sh != t.shape[3] * sw:
        raise ValueError(f"fit kernel: {name} has non-flat (H, W) strides "
                         f"{t.stride()}")
    return sb, sk, sw


def _launch_fit(s_re, s_im, phi, r2s, mp, te_flat, r_re, r_im, uniform_te,
                fm_sc, r2_sc, rho_sc, ns):
    """Check every operand and launch the fit kernel. s_*: (nb, ne, H, W)
    views; phi/r2s: (nb, 1, H, W) views; r_*: (nb, ns, H, W) views."""
    nb, ne, hgt, wdt = s_re.shape
    dev = s_re.device
    if ns != 2:
        raise ValueError(f"fit kernel: takes 2 species, got {ns}")
    if not 2 <= ne <= MAX_ECHOES:
        raise ValueError(f"fit kernel: takes 2..{MAX_ECHOES} echoes, got {ne}")
    for name, t in (("s_im", s_im), ("phi", phi), ("r2s", r2s), ("mp", mp),
                    ("te", te_flat), ("rho_re", r_re), ("rho_im", r_im)):
        if t.device != dev:
            raise ValueError(f"fit kernel: {name} on {t.device}, echoes on "
                             f"{dev}")
    if s_re.dtype not in (torch.float32, torch.bfloat16) \
            or s_im.dtype != s_re.dtype:
        raise TypeError(f"fit kernel: echoes must be float32 or bfloat16, "
                        f"got {s_re.dtype}/{s_im.dtype}")
    if r_re.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fit kernel: output must be float32 or bfloat16, "
                        f"got {r_re.dtype}")
    for name, t in (("phi", phi), ("r2s", r2s), ("mp", mp), ("te", te_flat)):
        if t.dtype != torch.float32:
            raise TypeError(f"fit kernel: {name} must be float32, got "
                            f"{t.dtype}")
    if tuple(phi.shape) != (nb, 1, hgt, wdt) or r2s.shape != phi.shape:
        raise ValueError(f"fit kernel: field maps {tuple(phi.shape)} / "
                         f"{tuple(r2s.shape)} do not match echoes "
                         f"{tuple(s_re.shape)}")
    if tuple(mp.shape) != (nb, 2 * ns * ne) or not mp.is_contiguous():
        raise ValueError(f"fit kernel: M⁺ must be contiguous "
                         f"{(nb, 2 * ns * ne)}, got {tuple(mp.shape)}")
    if tuple(te_flat.shape) != (nb, ne) or not te_flat.is_contiguous():
        raise ValueError(f"fit kernel: te must be contiguous {(nb, ne)}, got "
                         f"{tuple(te_flat.shape)}")
    s_str = _flat_strides(s_re, "s_re")
    p_str = _flat_strides(phi, "phi")
    r_str = _flat_strides(r_re, "rho_re")
    if (_flat_strides(s_im, "s_im") != s_str
            or _flat_strides(r2s, "r2s") != p_str
            or _flat_strides(r_im, "rho_im") != r_str):
        raise ValueError("fit kernel: re/im (and φ/R2*) views must share "
                         "strides")
    rc = FIT_KERNEL.fn("ideal_fit")(
        s_re.data_ptr(), s_im.data_ptr(), phi.data_ptr(), r2s.data_ptr(),
        mp.data_ptr(), te_flat.data_ptr(), r_re.data_ptr(), r_im.data_ptr(),
        nb, ne, hgt * wdt, *s_str, p_str[0], p_str[2], *r_str,
        int(s_re.dtype == torch.bfloat16), int(r_re.dtype == torch.bfloat16),
        _phasor_mode(uniform_te), fm_sc, r2_sc, rho_sc, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    FIT_KERNEL.launches += 1
    check_launch(FIT_KERNEL, rc)


def fit_rho_planar(s_re, s_im, phi, r2s, te, field=1.5, r2_sc=R2_SC,
                   fm_sc=FM_SC, rho_sc=RHO_SC,
                   species: SpeciesModel = WATER_FAT_7PEAK,
                   uniform_te: bool | None = None, precomputed=None,
                   out_dtype=torch.float32):
    """Map fit on planar buffers.

    s_re, s_im : (nb, ne, H, W) float32 or bfloat16 echoes (math is f32)
    phi, r2s   : (nb, H, W) normalized field map / R2*
    te         : (nb, ne, 1) echo times
    out_dtype  : torch.float32 or torch.bfloat16 for the ρ stores
    uniform_te : True forces the uniform-TE phasor recurrence, False the
                 per-echo form; None lets the kernel test each row's te
    precomputed: optional `precompute_fit_matrices(te, ...)` result

    Returns (rho_re, rho_im), each (nb, ns, H, W) in `out_dtype`.
    """
    if s_re.device.type == "cpu":
        acqs = torch.stack([s_re.float(), s_im.float()], dim=-1)
        pm = torch.stack([phi.float(), r2s.float()], dim=-1)[:, None]
        rho = pops.fit_rho(acqs, pm, te, field, r2_sc, fm_sc, rho_sc,
                           species=species)
        return rho[..., 0].to(out_dtype), rho[..., 1].to(out_dtype)
    nb, ne, hgt, wdt = s_re.shape
    ns = species.n_species
    if precomputed is None:
        precomputed = precompute_fit_matrices(te, field, species)
    mp, te_flat = precomputed
    r_re = torch.empty((nb, ns, hgt, wdt), dtype=out_dtype, device=s_re.device)
    r_im = torch.empty_like(r_re)
    _launch_fit(s_re, s_im, phi[:, None], r2s[:, None], mp, te_flat, r_re,
                r_im, uniform_te, fm_sc, r2_sc, rho_sc, ns)
    return r_re, r_im


def fit_rho_fused(acqs, param_maps, te, field=1.5, r2_sc=R2_SC, fm_sc=FM_SC,
                  rho_sc=RHO_SC, species: SpeciesModel = WATER_FAT_7PEAK,
                  uniform_te: bool | None = None):
    """Map fit on the MEBCRN layout, forward only.

    acqs (nb, ne, H, W, 2); param_maps (nb, ≥1, H, W, 2) with row 0 =
    (φ, R2*); te (nb, ne, 1). Returns (nb, ns, H, W, 2) float32. The kernel
    reads the interleaved re/im planes in place (stride 2), no copy.
    `uniform_te` as for `fit_rho_planar`.
    """
    if acqs.device.type == "cpu":
        return pops.fit_rho(acqs, param_maps, te, field, r2_sc, fm_sc,
                            rho_sc, species=species)
    nb, ne, hgt, wdt, _ = acqs.shape
    ns = species.n_species
    mp, te_flat = precompute_fit_matrices(te, field, species)
    out = torch.empty((nb, ns, hgt, wdt, 2), dtype=torch.float32,
                      device=acqs.device)
    _launch_fit(acqs[..., 0], acqs[..., 1], param_maps[:, 0:1, ..., 0],
                param_maps[:, 0:1, ..., 1], mp, te_flat, out[..., 0],
                out[..., 1], uniform_te, fm_sc, r2_sc, rho_sc, ns)
    return out
