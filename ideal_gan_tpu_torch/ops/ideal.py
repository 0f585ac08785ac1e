"""The IDEAL map fit, cycle, forward synthesis and magnitude fit on the card
(counterpart of `ideal_gan_tpu/ops/pallas_ideal.py`'s entry points).

For CUDA tensors every entry point launches a hand-written kernel
(`csrc/ideal_fit.cu`, `csrc/ideal_cycle.cu`, `csrc/ideal_forward.cu`,
`csrc/ideal_mag_fit.cu`); for CPU tensors it calls the kernel's plain
version, `physics.ops.fit_rho`, `cycle_full`, `synthesize` or
`cse_mag_fit`. A CUDA tensor the kernel cannot take raises: there is no
fallback to the plain version on the card.

    fit:        ρ_s = (1/rho_sc) · Σ_e M⁺[s,e] · e^{−2πi·te_e·ξ} · S_e
    cycle:      the fit, then Â_e = e^{+2πi·te_e·ξ} · Σ_s M[e,s] · (rho_sc·ρ_s)
    synthesis:  S_e = e^{+2πi·te_e·ξ₊} · Σ_s M[e,s] · (rho_sc·ρ_s)
    ξ = φ·fm_sc + i·R2*·r2_sc/2π;  ξ₊ the same with R2* clamped at 0
    magnitude:  (a, b, c) = A⁺ · (e^{te·R2*}·|S|)², |Ŝ_e| = √(A·(a,b,c))_e /
                e^{te_e·R2*}, (|W|, |F|) from the 2×2 eigensolve

`fit_rho_fused`, `cycle_full_fused`, `cycle_fused`, `synthesize_fused` and
`cse_mag_fused` are differentiable: as the JAX package's custom VJPs do, the backward is
autograd through the plain version from the saved inputs, for the inputs
that need a gradient. The TPU tiling constants of the JAX module (row
tiles, the (16, 128) bf16 block rule and its f32 fallbacks) have no
counterpart here: the kernels index voxels directly and take any H, W.

The kernels' per-row matrices (M, M⁺, A, A⁺) are built by torch matmuls
at full float32 precision whatever the TF32 setting (`_fp32_matmuls`): with
TF32 on they would carry a 10-bit mantissa into every voxel's fit and move
the phantom's magnitude PDFF by up to 2.8e-3.
"""

from __future__ import annotations

import contextlib
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
CYCLE_KERNEL = Kernel("ideal_cycle", {
    "ideal_cycle": (_I, [_P] * 11 + [_I, _I] + [_L] * 12
                    + [_I, _F, _F, _F, _I, _P]),
})
FORWARD_KERNEL = Kernel("ideal_forward", {
    "ideal_forward": (_I, [_P] * 8 + [_I, _I] + [_L] * 9
                      + [_I, _F, _F, _F, _I, _P]),
})
MAG_FIT_KERNEL = Kernel("ideal_mag_fit", {
    "ideal_mag_fit": (_I, [_P] * 9 + [_I, _I] + [_L] * 6
                      + [_I, _F, _F, _F, _I, _P]),
})
MAX_ECHOES = 12
# the profiler range around the physics Functions' reference backward
BACKWARD_RANGE = "physics reference backward"


def _phasor_mode(uniform_te: bool | None) -> int:
    """The kernel's phasor form: 1 the uniform-TE recurrence, 0 one
    sincos/exp per echo, 2 (uniform_te=None) decided per batch row on the
    card from te itself, with the JAX package's uniformity test."""
    return 2 if uniform_te is None else int(bool(uniform_te))


@contextlib.contextmanager
def _fp32_matmuls():
    """Full-precision float32 and complex64 matmuls inside (no TF32), the
    caller's `torch.backends.cuda.matmul.allow_tf32` restored after. That
    flag keeps PyTorch's legacy and per-backend precision settings in
    step; `torch.set_float32_matmul_precision` sets every backend's, and
    PyTorch 2.11 then refuses the mix once the CUDA flag is set alone."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def _rowwise_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (nb, i, k) @ b (nb, k, j) as a sum over k in a fixed order of
    elementwise products, so that each row's result is independent of the
    batch around it: a batched cuBLAS matmul may take another algorithm,
    and round otherwise, for another nb (it did for the magnitude fit's
    A⁺ on the H100, and `chip_smoke.py`'s batch-elementwise gate failed)."""
    out = a[..., :, :1] * b[..., :1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def _pinv_rows(m: torch.Tensor) -> torch.Tensor:
    """`physics.matrix.pinv_normal` ((MᴴM)⁻¹Mᴴ) by `_rowwise_matmul`."""
    mh = m.transpose(-1, -2).conj()
    return _rowwise_matmul(mx.small_inv(_rowwise_matmul(mh, m)), mh)


def _mat_scalars(m: torch.Tensor) -> torch.Tensor:
    """(nb, a, b) complex → (nb, a*b*2) float32, interleaved re/im."""
    flat = m.reshape(m.shape[0], -1)
    return torch.stack([flat.real, flat.imag], dim=-1).reshape(
        m.shape[0], -1).float().contiguous()


def precompute_fit_matrices(te: torch.Tensor, field: float = 1.5,
                            species: SpeciesModel = WATER_FAT_7PEAK):
    """The kernel's per-row operands for a TE train: (M⁺ as (nb, 2·ns·ne)
    float32 re/im pairs, te as (nb, ne) float32). Serving reuses one
    protocol across many batches. Each row's operands are independent of
    the other rows (`_pinv_rows`), as the kernels are batch-elementwise."""
    with _fp32_matmuls():
        m_pinv = _pinv_rows(mx.model_matrix(te, field, species))
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
    check_launch(FIT_KERNEL, rc, r_re, r_im)


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


def _fit_rho_kernel(acqs, param_maps, te, field, r2_sc, fm_sc, rho_sc,
                   species, uniform_te):
    """The fit kernel on MEBCRN views, forward only."""
    nb, ne, hgt, wdt, _ = acqs.shape
    ns = species.n_species
    mp, te_flat = precompute_fit_matrices(te, field, species)
    out = torch.empty((nb, ns, hgt, wdt, 2), dtype=torch.float32,
                      device=acqs.device)
    _launch_fit(acqs[..., 0], acqs[..., 1], param_maps[:, 0:1, ..., 0],
                param_maps[:, 0:1, ..., 1], mp, te_flat, out[..., 0],
                out[..., 1], uniform_te, fm_sc, r2_sc, rho_sc, ns)
    return out


def _check_cycle_operands(acqs, param_maps, te):
    nb, ne, hgt, wdt, two = acqs.shape
    if two != 2 or acqs.dtype != torch.float32:
        raise TypeError(f"cycle kernel: acqs must be float32 (nb, ne, H, W, "
                        f"2), got {acqs.dtype} {tuple(acqs.shape)}")
    if param_maps.dtype != torch.float32 \
            or tuple(param_maps.shape[2:]) != (hgt, wdt, 2) \
            or param_maps.shape[0] != nb:
        raise ValueError(f"cycle kernel: param_maps must be float32 (nb, ≥1, "
                         f"H, W, 2) over (φ, R2*), got {param_maps.dtype} "
                         f"{tuple(param_maps.shape)}")
    if not 2 <= ne <= MAX_ECHOES:
        raise ValueError(f"cycle kernel: takes 2..{MAX_ECHOES} echoes, got "
                         f"{ne}")
    for name, t in (("param_maps", param_maps), ("te", te)):
        if t.device != acqs.device:
            raise ValueError(f"cycle kernel: {name} on {t.device}, acqs on "
                             f"{acqs.device}")


def precompute_cycle_matrices(te: torch.Tensor, field: float = 1.5,
                              species: SpeciesModel = WATER_FAT_7PEAK):
    """The cycle kernel's per-row operands for a TE train: (M as (nb,
    2·ne·ns), M⁺ as (nb, 2·ns·ne), float32 re/im pairs; te as (nb, ne)
    float32)."""
    with _fp32_matmuls():
        m = mx.model_matrix(te, field, species)
    m_pinv = _pinv_rows(m)
    nb, ne = te.shape[0], te.shape[1]
    return (_mat_scalars(m), _mat_scalars(m_pinv),
            te.reshape(nb, ne).float().contiguous())


def _cycle_kernel(acqs, param_maps, te, field, r2_sc, fm_sc, rho_sc,
                  species, uniform_te, precomputed=None):
    """The cycle kernel on MEBCRN views: (ρ, Â), forward only."""
    _check_cycle_operands(acqs, param_maps, te)
    nb, ne, hgt, wdt, _ = acqs.shape
    ns = species.n_species
    if ns != 2:
        raise ValueError(f"cycle kernel: takes 2 species, got {ns}")
    m_s, mp_s, te_flat = precomputed or precompute_cycle_matrices(
        te, field, species)
    if m_s.shape != (nb, 2 * ne * ns) or mp_s.shape != m_s.shape \
            or te_flat.shape != (nb, ne):
        raise ValueError(f"cycle kernel: precomputed operands "
                         f"{m_s.shape}, {mp_s.shape}, {te_flat.shape} do not "
                         f"match {nb} rows of {ne} echoes")
    rho = torch.empty((nb, ns, hgt, wdt, 2), dtype=torch.float32,
                      device=acqs.device)
    recon = torch.empty((nb, ne, hgt, wdt, 2), dtype=torch.float32,
                        device=acqs.device)
    s_re, s_im = acqs[..., 0], acqs[..., 1]
    phi, r2s = param_maps[:, 0:1, ..., 0], param_maps[:, 0:1, ..., 1]
    s_str = _flat_strides(s_re, "acqs")
    p_str = _flat_strides(phi, "param_maps")
    r_str = _flat_strides(rho[..., 0], "rho")
    o_str = _flat_strides(recon[..., 0], "recon")
    rc = CYCLE_KERNEL.fn("ideal_cycle")(
        s_re.data_ptr(), s_im.data_ptr(), phi.data_ptr(), r2s.data_ptr(),
        m_s.data_ptr(), mp_s.data_ptr(), te_flat.data_ptr(),
        rho[..., 0].data_ptr(), rho[..., 1].data_ptr(),
        recon[..., 0].data_ptr(), recon[..., 1].data_ptr(),
        nb, ne, hgt * wdt, *s_str, p_str[0], p_str[2], *r_str, *o_str,
        _phasor_mode(uniform_te), fm_sc, r2_sc, rho_sc, acqs.device.index,
        torch.cuda.current_stream(acqs.device).cuda_stream)
    CYCLE_KERNEL.launches += 1
    check_launch(CYCLE_KERNEL, rc, rho, recon)
    return rho, recon


class _Physics(torch.autograd.Function):
    """A physics kernel whose backward is autograd through its plain
    version from the saved (acqs, param_maps, te), as the JAX package's
    `_fit_bwd` / `_cycle_full_bwd` do. CPU tensors run the plain version
    forward too; `kernel_opts` are the kernel's own trailing arguments.
    `acqs` is data on the training path: its gradient is computed only
    when it is asked for (`needs_input_grad`)."""

    @staticmethod
    def forward(ctx, kernel, plain, acqs, param_maps, te, consts,
                kernel_opts):
        ctx.plain, ctx.consts = plain, consts
        ctx.save_for_backward(acqs, param_maps, te)
        if acqs.device.type == "cpu":
            return plain(acqs, param_maps, te, *consts)
        return kernel(acqs, param_maps, te, *consts, *kernel_opts)

    @staticmethod
    def backward(ctx, *grads):
        acqs, param_maps, te = ctx.saved_tensors
        need = ctx.needs_input_grad[2:4]
        with torch.enable_grad(), \
                torch.profiler.record_function(BACKWARD_RANGE):
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip((acqs, param_maps), need)]
            outs = ctx.plain(*ins, te, *ctx.consts)
            outs = outs if isinstance(outs, tuple) else (outs,)
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(outs, wrt, grads)) if wrt else None
        da, dp = (next(got) if n else None for n in need)
        return None, None, da, dp, None, None, None


def fit_rho_fused(acqs, param_maps, te, field=1.5, r2_sc=R2_SC, fm_sc=FM_SC,
                  rho_sc=RHO_SC, species: SpeciesModel = WATER_FAT_7PEAK,
                  uniform_te: bool | None = None):
    """Map fit on the MEBCRN layout.

    acqs (nb, ne, H, W, 2); param_maps (nb, ≥1, H, W, 2) with row 0 =
    (φ, R2*); te (nb, ne, 1). Returns (nb, ns, H, W, 2) float32. The kernel
    reads the interleaved re/im planes in place (stride 2), no copy.
    `uniform_te` as for `fit_rho_planar`. Differentiable in acqs and
    param_maps (autograd through `physics.fit_rho`). Only row 0 is read, as
    the TPU kernel reads it: the bipolar row of a 4-row param_maps is
    `physics.fit_rho`'s alone.
    """
    def plain(a, p, t, *consts):
        return pops.fit_rho(a, p[:, :1], t, *consts[:4], species=consts[4])

    return _Physics.apply(_fit_rho_kernel, plain, acqs, param_maps, te,
                          (field, r2_sc, fm_sc, rho_sc, species),
                          (uniform_te,))


def cycle_full_fused(acqs, param_maps, te, field=1.5, r2_sc=R2_SC,
                     fm_sc=FM_SC, rho_sc=RHO_SC,
                     species: SpeciesModel = WATER_FAT_7PEAK,
                     uniform_te: bool | None = None):
    """The fused IDEAL cycle: (ρ (nb, ns, H, W, 2), Â (nb, ne, H, W, 2)),
    the LS water/fat maps and the reprojected acquisitions of the
    unsupervised loss, in one pass of the cycle kernel.

    acqs (nb, ne, H, W, 2) float32; param_maps (nb, ≥1, H, W, 2) with row 0
    = (φ, R2*); te (nb, ne, 1). `uniform_te`: True forces the uniform-TE
    phasor recurrence, False the per-echo form, None lets the kernel test
    each row's te. Differentiable in acqs and param_maps (autograd through
    `physics.cycle_full`).
    """
    return _Physics.apply(_cycle_kernel, pops.cycle_full, acqs, param_maps,
                          te, (field, r2_sc, fm_sc, rho_sc, species),
                          (uniform_te,))


def cycle_fused(acqs, param_maps, te, field=1.5, r2_sc=R2_SC, fm_sc=FM_SC,
                species: SpeciesModel = WATER_FAT_7PEAK,
                uniform_te: bool | None = None):
    """The fused IDEAL cycle Â = W⁺MM⁺W⁻A (layouts as `cycle_full_fused`)."""
    return cycle_full_fused(acqs, param_maps, te, field, r2_sc, fm_sc,
                            RHO_SC, species, uniform_te)[1]


def precompute_synth_matrices(te: torch.Tensor, field: float = 1.5,
                              species: SpeciesModel = WATER_FAT_7PEAK):
    """The synthesis kernel's per-row operands for a TE train: (M as (nb,
    2·ne·ns) float32 re/im pairs, te as (nb, ne) float32)."""
    nb, ne = te.shape[0], te.shape[1]
    with _fp32_matmuls():
        m = mx.model_matrix(te, field, species)
    return _mat_scalars(m), te.reshape(nb, ne).float().contiguous()


def _synth_kernel(out_maps, te, field, r2_sc, fm_sc, rho_sc, species,
                  uniform_te, precomputed=None):
    """The synthesis kernel on MEBCRN views: echoes (nb, ne, H, W, 2),
    forward only."""
    nb, nm, hgt, wdt, two = out_maps.shape
    ns = species.n_species
    if ns != 2:
        raise ValueError(f"synthesis kernel: takes 2 species, got {ns}")
    if two != 2 or nm != ns + 1 or out_maps.dtype != torch.float32:
        raise TypeError(f"synthesis kernel: out_maps must be float32 (nb, "
                        f"{ns + 1}, H, W, 2), got {out_maps.dtype} "
                        f"{tuple(out_maps.shape)}")
    if te.device != out_maps.device:
        raise ValueError(f"synthesis kernel: te on {te.device}, out_maps on "
                         f"{out_maps.device}")
    ne = te.shape[1]
    if not 2 <= ne <= MAX_ECHOES or tuple(te.shape) != (nb, ne, 1):
        raise ValueError(f"synthesis kernel: te must be (nb, 2..{MAX_ECHOES}, "
                         f"1), got {tuple(te.shape)}")
    m_s, te_flat = precomputed or precompute_synth_matrices(te, field,
                                                            species)
    if m_s.shape != (nb, 2 * ne * ns) or te_flat.shape != (nb, ne):
        raise ValueError(f"synthesis kernel: precomputed operands "
                         f"{m_s.shape}, {te_flat.shape} do not match {nb} "
                         f"rows of {ne} echoes")
    out = torch.empty((nb, ne, hgt, wdt, 2), dtype=torch.float32,
                      device=out_maps.device)
    r_re, r_im = out_maps[:, :ns, ..., 0], out_maps[:, :ns, ..., 1]
    phi, r2s = out_maps[:, ns:, ..., 0], out_maps[:, ns:, ..., 1]
    r_str = _flat_strides(r_re, "out_maps")
    p_str = _flat_strides(phi, "out_maps")
    o_str = _flat_strides(out[..., 0], "echoes")
    rc = FORWARD_KERNEL.fn("ideal_forward")(
        r_re.data_ptr(), r_im.data_ptr(), phi.data_ptr(), r2s.data_ptr(),
        m_s.data_ptr(), te_flat.data_ptr(), out[..., 0].data_ptr(),
        out[..., 1].data_ptr(), nb, ne, hgt * wdt, *r_str, p_str[0],
        p_str[2], *o_str, _phasor_mode(uniform_te), fm_sc, r2_sc, rho_sc,
        out_maps.device.index,
        torch.cuda.current_stream(out_maps.device).cuda_stream)
    FORWARD_KERNEL.launches += 1
    check_launch(FORWARD_KERNEL, rc, out)
    return out


class _Synthesize(torch.autograd.Function):
    """The synthesis kernel, whose backward is autograd through
    `physics.synthesize` from the saved (out_maps, te), as the JAX
    package's `_synth_bwd` does. CPU tensors run the plain version."""

    @staticmethod
    def forward(ctx, out_maps, te, consts, uniform_te):
        ctx.consts = consts
        ctx.save_for_backward(out_maps, te)
        if out_maps.device.type == "cpu":
            return pops.synthesize(out_maps, te, *consts)
        return _synth_kernel(out_maps, te, *consts, uniform_te)

    @staticmethod
    def backward(ctx, g):
        out_maps, te = ctx.saved_tensors
        with torch.enable_grad(), \
                torch.profiler.record_function(BACKWARD_RANGE):
            om = out_maps.detach().requires_grad_()
            (dm,) = torch.autograd.grad(
                pops.synthesize(om, te, *ctx.consts), om, g)
        return dm, None, None, None


def synthesize_fused(out_maps, te, field=1.5, r2_sc=R2_SC, fm_sc=FM_SC,
                     rho_sc=RHO_SC, species: SpeciesModel = WATER_FAT_7PEAK,
                     uniform_te: bool | None = None):
    """The fused forward synthesis S = W⁺Mρ: echoes (nb, ne, H, W, 2)
    float32 from out_maps (nb, 3, H, W, 2) float32, rows [water, fat,
    (φ, R2*)] with R2* clamped at 0, at te (nb, ne, 1). `uniform_te`: True
    forces the uniform-TE phasor recurrence, False the per-echo form, None
    lets the kernel test each row's te. Differentiable in out_maps
    (autograd through `physics.synthesize`)."""
    return _Synthesize.apply(out_maps, te,
                             (field, r2_sc, fm_sc, rho_sc, species),
                             uniform_te)


def precompute_mag_matrices(te: torch.Tensor, field: float = 1.5,
                            species: SpeciesModel = WATER_FAT_7PEAK):
    """The magnitude fit kernel's per-row operands for a TE train: (A as
    (nb, ne·3), A⁺ as (nb, 3·ne), te as (nb, ne)), float32."""
    nb, ne = te.shape[0], te.shape[1]
    with _fp32_matmuls():
        a = mx.mag_columns(mx.model_matrix(te, field, species))
    at = a.transpose(-1, -2)
    a_pinv = _rowwise_matmul(mx.small_inv(_rowwise_matmul(at, a)), at)
    return (a.reshape(nb, -1).contiguous(), a_pinv.reshape(nb, -1).contiguous(),
            te.reshape(nb, ne).float().contiguous())


def _mag_fit_kernel(acqs, out_maps, te, field, r2_sc, rho_sc, species,
                    uniform_te, precomputed=None):
    """The magnitude fit kernel: (ρ (nb, 2, H, W, 1), |Ŝ| (nb, ne, H, W, 1),
    LS (nb, 3, H, W, 1), ratio (nb, 1, H, W, 1)), forward only. R2* is read
    in place from channel 0 of `out_maps`' row 0."""
    nb, ne, hgt, wdt, one = acqs.shape
    if species.n_species != 2:
        raise ValueError(f"magnitude fit kernel: takes 2 species, got "
                         f"{species.n_species}")
    if one != 1 or acqs.dtype != torch.float32:
        raise TypeError(f"magnitude fit kernel: acqs must be float32 (nb, ne, "
                        f"H, W, 1), got {acqs.dtype} {tuple(acqs.shape)}")
    if out_maps.dtype != torch.float32:
        raise TypeError(f"magnitude fit kernel: out_maps must be float32, got "
                        f"{out_maps.dtype}")
    if out_maps.ndim != 5 or out_maps.shape[0] != nb \
            or tuple(out_maps.shape[2:4]) != (hgt, wdt):
        raise ValueError(f"magnitude fit kernel: out_maps must be (nb, ≥1, H, "
                         f"W, ≥1) with R2* in channel 0 of row 0, got "
                         f"{tuple(out_maps.shape)} for acqs "
                         f"{tuple(acqs.shape)}")
    if not 3 <= ne <= MAX_ECHOES or tuple(te.shape) != (nb, ne, 1):
        raise ValueError(f"magnitude fit kernel: takes 3..{MAX_ECHOES} echoes "
                         f"and te (nb, ne, 1), got acqs {tuple(acqs.shape)}, "
                         f"te {tuple(te.shape)}")
    for name, t in (("out_maps", out_maps), ("te", te)):
        if t.device != acqs.device:
            raise ValueError(f"magnitude fit kernel: {name} on {t.device}, "
                             f"acqs on {acqs.device}")
    a_s, ap_s, te_flat = precomputed or precompute_mag_matrices(te, field,
                                                                species)
    if a_s.shape != (nb, 3 * ne) or ap_s.shape != a_s.shape \
            or te_flat.shape != (nb, ne):
        raise ValueError(f"magnitude fit kernel: precomputed operands "
                         f"{a_s.shape}, {ap_s.shape}, {te_flat.shape} do not "
                         f"match {nb} rows of {ne} echoes")
    dev = acqs.device
    rho, recon, ls, unc = (
        torch.empty((nb, k, hgt, wdt, 1), dtype=torch.float32, device=dev)
        for k in (2, ne, 3, 1))
    s = acqs[..., 0]
    r2s = out_maps[:, 0:1, ..., 0]
    s_str = _flat_strides(s, "acqs")
    p_str = _flat_strides(r2s, "out_maps")
    rc = MAG_FIT_KERNEL.fn("ideal_mag_fit")(
        s.data_ptr(), r2s.data_ptr(), a_s.data_ptr(), ap_s.data_ptr(),
        te_flat.data_ptr(), rho.data_ptr(), recon.data_ptr(), ls.data_ptr(),
        unc.data_ptr(), nb, ne, hgt * wdt, *s_str, p_str[0], p_str[2],
        _phasor_mode(uniform_te), r2_sc, rho_sc, rho_sc ** 2, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    MAG_FIT_KERNEL.launches += 1
    check_launch(MAG_FIT_KERNEL, rc, rho, recon, ls, unc)
    return rho, recon, ls, unc


def _mag_fit_plain(acqs, out_maps, te, field, r2_sc, rho_sc, species):
    """The kernel's outputs from `physics.cse_mag_fit`."""
    res = pops.cse_mag_fit(acqs, out_maps, te, field, r2_sc, rho_sc,
                           species=species)
    return res.rho, res.recon, res.ls_coeffs, res.uncertainty


def cse_mag_fused(acqs, out_maps, te, field=1.5, r2_sc=R2_SC, rho_sc=RHO_SC,
                  r2s_nu=None, species: SpeciesModel = WATER_FAT_7PEAK,
                  uniform_te: bool | None = None) -> pops.CSEMagResult:
    """The fused magnitude-domain fit: `physics.cse_mag_fit`'s
    `CSEMagResult` with ρ, |Ŝ|, the LS coefficients and the rank-1 ratio
    from one pass of the magnitude fit kernel.

    acqs (nb, ne, H, W, 1) float32 magnitudes; out_maps (nb, ≥1, H, W, ≥1)
    float32 with channel 0 of row 0 the normalized R2*; te (nb, ne, 1).
    `uniform_te`: True forces the uniform-TE recurrence, False one exp per
    echo, None lets the kernel test each row's te. `demod` is not a kernel
    output (nor the TPU kernel's): it is (e^{te·R2*}·|S|)² in plain
    elementwise ops, with the Rician ν `r2s_nu` in place of R2* when given,
    so ν's gradient is ordinary autograd. Differentiable in acqs and
    out_maps (autograd through `physics.cse_mag_fit`)."""
    rho, recon, ls, unc = _Physics.apply(
        _mag_fit_kernel, _mag_fit_plain, acqs, out_maps, te,
        (field, r2_sc, rho_sc, species), (uniform_te,))
    demod = pops.mag_demod(acqs, out_maps if r2s_nu is None else r2s_nu, te,
                           r2_sc)
    return pops.CSEMagResult(rho, recon, demod, ls, unc)
