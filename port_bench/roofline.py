"""The yardstick of the per-layer rooflines and of `mfu`: the work that the
inputs need, counted from shapes whatever implements it, and the peaks of
one NVIDIA H100 SXM (the data sheet's dense rates, at its 700 W limit).

ConvLSTM (nb slices, H x W, Cin inputs, F filters, ne echoes; echo 0's
recurrent term multiplies a zero state and is not counted):
- forward: 2 nb H W 9 4F (Cin ne + F (ne - 1)) FLOPs;
- backward without the input gradient: the kernel's gradient (the
  forward's count again) and the gradient through the recurrent term
  2 nb H W 9 4F F (ne - 1); a recomputation of the states or of the
  gates is an implementation's choice and is not counted;
- bytes: the echoes and the kernel read once, the last state written
  once (forward); the backward reads them and the state's gradient and
  writes the kernel's gradient.

Per-voxel IDEAL kernels (nb slices, H x W voxels, ne echoes, 2 species),
float32, each input read once and each output written once:
- fit: echoes 8 ne + (phi, R2*) 8 read, rho 16 written;
- cycle: echoes 8 ne + 8 read, rho 16 and A_hat 8 ne written;
- synthesis: rho 16 + 8 read, echoes 8 ne written.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12


def peak_flops(cfg: dict) -> float:
    """The highest dense rate the configuration's stated precision
    permits: TF32 where its cuDNN convolutions may run in TF32
    (`cudnn_tf32`), else 3xTF32, a float32-accurate product on the tensor
    cores in three TF32 passes (as the ConvLSTM kernels make it)."""
    return TF32_FLOPS_PER_S if cfg["cudnn_tf32"] else TF32_FLOPS_PER_S / 3


def convlstm_flops(nb, h, w, cin, f, ne, backward=False) -> float:
    """FLOPs of one call: its forward, and with `backward` its backward
    too."""
    vox = nb * h * w
    fwd = 2.0 * vox * 9 * 4 * f * (cin * ne + f * (ne - 1))
    if not backward:
        return fwd
    return 2.0 * fwd + 2.0 * vox * 9 * 4 * f * f * (ne - 1)


def convlstm_bytes(nb, h, w, cin, f, ne, backward=False) -> float:
    vox = nb * h * w
    x, k, state = 4.0 * vox * ne * cin, 4.0 * 9 * (cin + f) * 4 * f, \
        4.0 * vox * f
    fwd = x + k + 4.0 * 4 * f + state
    return fwd + (x + k + state + k if backward else 0.0)


IDEAL_BYTES_PER_VOXEL = {
    "fit": lambda ne: 8 * ne + 8 + 16,
    "cycle": lambda ne: 8 * ne + 8 + 16 + 8 * ne,
    "synth": lambda ne: 16 + 8 + 8 * ne,
}


def ideal_bytes(kind: str, nb, h, w, ne) -> float:
    return float(IDEAL_BYTES_PER_VOXEL[kind](ne)) * nb * h * w


def convlstm_bound_s(calls, peak: float) -> float:
    """The least time of `calls` [(nb, h, w, cin, f, ne, backward)]: the
    larger of FLOPs over `peak` (FLOP/s) and bytes over HBM's, summed call
    by call."""
    return sum(max(convlstm_flops(*c) / peak,
                   convlstm_bytes(*c) / HBM_BYTES_PER_S) for c in calls)


def ideal_bound_s(calls) -> float:
    """The least time of per-voxel kernel `calls` [(kind, nb, h, w, ne)]."""
    return sum(ideal_bytes(*c) / HBM_BYTES_PER_S for c in calls)
