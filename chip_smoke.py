#!/usr/bin/env python3
"""Drive the PyTorch port's AI-DEAL serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (no phase catches its own failure; any
error or mismatch ends the run with a non-zero exit and no `ok` line):

1. env      torch / CUDA versions, the card's name and power limit.
2. build    compiles every kernel of `ideal_gan_tpu_torch/csrc/` with nvcc
            (one process per source, in parallel) and prints the seconds
            and the ptxas register / spill report.
3. kernels  each kernel at the main path's shapes against its plain PyTorch
            version on the same inputs (TF32 off), with CUDA-event times of
            both and the card's lower bound for the same work:
            - map fit: the serving call (MEBCRN, nb=8) and planar buffers
              at nb=8 and nb=128 in f32, bf16 echoes, and bf16 echoes with
              bf16 rho; accuracy guard against the synthetic ground truth
              (max err < 5e-2) and the bf16 PDFF gate (< 3e-3);
            - ConvLSTM forward: Cin=2 and Cin=1, F=36, ne=6, nb=8.
4. e2e      `ideal_gan_tpu_torch.cli.infer.main` on 16 synthetic 384²
            slices at batch 8 (AI-DEAL, F=36, seeded random weights), with
            every launch counter set to 0 just before and read just after;
            fails unless both kernels ran (at least 2 fit and 24 ConvLSTM
            launches) and every map is finite. Then the first chunk again on
            the card (TF32 off) and on the CPU with the same weights, maps
            and PDFF compared.

The last three lines are the card's `nvidia-smi` name and power limit, the
`{"kernels": [...]}` summary and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): FP32 on CUDA cores, HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

SIZE, NE, F_MAIN, NB_SERVE = 384, 6, 36, 8


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, dev, iters: int = 10, warmup: int = 2) -> float:
    """Mean time of one call: CUDA events around `iters` calls after
    warm-up (a host clock on the CPU, for rehearsals only)."""
    import torch
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def set_tf32(on: bool) -> None:
    import torch
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def build_phase() -> None:
    from ideal_gan_tpu_torch.ops import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in rep.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, rep in reports.items()}
    emit("build", seconds=round(secs, 3), ptxas=ptxas)


def bench_inputs(nb: int, size: int, dev):
    """bench.py's synthetic fit inputs: real water/fat, field map and R2*
    drawn uniformly, echoes from the forward model. Returns (acqs MEBCRN,
    maps, te) on `dev`."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch import physics
    rng = np.random.default_rng(0)
    shape = (nb, size, size)
    water = rng.uniform(0.1, 0.7, shape).astype(np.float32)
    fat = rng.uniform(0.0, 0.5, shape).astype(np.float32)
    phi = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
    r2s = rng.uniform(0.0, 0.5, shape).astype(np.float32)
    zeros = np.zeros_like(water)
    maps = torch.from_numpy(np.stack([
        np.stack([water, zeros], -1), np.stack([fat, zeros], -1),
        np.stack([phi, r2s], -1)], axis=1)).to(dev)
    te = physics.te_train(NE, bs=nb, device=dev)
    return physics.synthesize(maps, te), maps, te


def fit_entry(dev, size: int = SIZE, nbs=(NB_SERVE, 128)) -> dict:
    """The fit kernel against `physics.fit_rho` on the same inputs."""
    import torch
    from ideal_gan_tpu_torch import ops, physics

    def pdff(rre, rim):
        w = torch.complex(rre[:, 0].float(), rim[:, 0].float()).abs()
        f = torch.complex(rre[:, 1].float(), rim[:, 1].float()).abs()
        return f / torch.clamp(w + f, min=1e-6)

    cases = []
    for nb in nbs:
        acqs, maps, te = bench_inputs(nb, size, dev)
        pm = maps[:, 2:3].contiguous()
        nv = nb * size * size
        plain = lambda: physics.fit_rho(acqs, pm, te)  # noqa: E731
        ref = plain()
        plain_ms = time_ms(plain, dev)
        gt_err = None
        if nb == nbs[0]:
            # the serving call: MEBCRN in place, as cli.infer runs it (with
            # its per-call M⁺ build); the kernel alone timed on the same
            # interleaved views with M⁺ precomputed
            fused = lambda: ops.fit_rho_fused(acqs, pm, te)  # noqa: E731
            out = fused()
            pre = ops.precompute_fit_matrices(te)
            kernel_only = lambda: ops.fit_rho_planar(  # noqa: E731
                acqs[..., 0], acqs[..., 1], pm[:, 0, ..., 0],
                pm[:, 0, ..., 1], te, precomputed=pre)
            err = float((out - ref).abs().max())
            tol_ok = bool(((out - ref).abs()
                           <= 1e-5 + 1e-4 * ref.abs()).all())
            gt_err = float((out - maps[:, :2]).abs().max())
            n_bytes = nv * (NE * 8 + 8 + 2 * 8)
            b_ms, b_by = bound(n_bytes, nv * (NE * 24 + 5 * 6))
            cases.append(dict(
                call="fit_rho_fused MEBCRN", nb=nb, echoes="f32",
                rho="f32", max_abs_err=err, within_tol=tol_ok,
                gt_max_err=gt_err, ms=time_ms(kernel_only, dev),
                call_ms=time_ms(fused, dev), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by))
        s_re = acqs[..., 0].contiguous()
        s_im = acqs[..., 1].contiguous()
        phi = maps[:, 2, ..., 0].contiguous()
        r2s = maps[:, 2, ..., 1].contiguous()
        pre = ops.precompute_fit_matrices(te)
        f32_out = None
        for echoes, rho_t in (("f32", torch.float32),
                              ("bf16", torch.float32),
                              ("bf16", torch.bfloat16)):
            e_t = torch.float32 if echoes == "f32" else torch.bfloat16
            a_re, a_im = s_re.to(e_t), s_im.to(e_t)
            fit = lambda: ops.fit_rho_planar(  # noqa: E731
                a_re, a_im, phi, r2s, te, uniform_te=True,
                precomputed=pre, out_dtype=rho_t)
            rre, rim = fit()
            # plain version on the same (rounded) echoes
            ref_c = physics.fit_rho(
                torch.stack([a_re.float(), a_im.float()], -1), pm, te)
            got = torch.stack([rre.float(), rim.float()], -1)
            err = float((got - ref_c).abs().max())
            if rho_t == torch.float32:
                tol_ok = bool(((got - ref_c).abs()
                               <= 1e-5 + 1e-4 * ref_c.abs()).all())
            else:
                # bf16 stores keep 8 bits of mantissa: |rho| < 1.5 rounds
                # by at most 2^-8
                tol_ok = err <= 2 ** -8 * 1.5
            if f32_out is None:
                f32_out = (rre, rim)
                gt = float((got - maps[:, :2]).abs().max())
                if gt >= 5e-2:
                    raise AssertionError(f"fit inaccurate vs ground truth: "
                                         f"max err {gt}")
            pdff_dev = float((pdff(rre, rim) - pdff(*f32_out)).abs().max())
            if pdff_dev >= 3e-3:
                raise AssertionError(f"fit {echoes}/{rho_t}: PDFF deviates "
                                     f"{pdff_dev} from f32 (gate 3e-3)")
            in_b = 2 if e_t == torch.bfloat16 else 4
            out_b = 2 if rho_t == torch.bfloat16 else 4
            n_bytes = nv * (NE * 2 * in_b + 8 + 2 * 2 * out_b)
            b_ms, b_by = bound(n_bytes, nv * (NE * 24 + 5 * 6))
            cases.append(dict(
                call="fit_rho_planar", nb=nb, echoes=echoes,
                rho="bf16" if rho_t == torch.bfloat16 else "f32",
                max_abs_err=err, within_tol=tol_ok, pdff_dev_vs_f32=pdff_dev,
                ms=time_ms(fit, dev), plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by))
        del acqs, maps, s_re, s_im
    bad = [c for c in cases if not c["within_tol"]]
    if bad:
        raise AssertionError(f"fit kernel disagrees with fit_rho: {bad}")
    main = cases[0]
    return dict(
        name=ops.FIT_KERNEL.name, route="cuda", source=ops.FIT_KERNEL.source,
        replaces="ideal_gan_tpu/ops/pallas_ideal.py:141",
        launches=None, max_abs_err=main["max_abs_err"], ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        tolerance="|d| <= 1e-5 + 1e-4*|plain| (f32 rho), 2^-8*1.5 (bf16 "
                  "rho)", cases=cases)


def convlstm_entry(dev, size: int = SIZE, nb: int = NB_SERVE,
                   f: int = F_MAIN) -> dict:
    """The ConvLSTM forward kernel against `convlstm_reference`."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from ideal_gan_tpu_torch import ops
    cases = []
    for cin in (2, 1):
        rng = np.random.default_rng(cin)
        x = torch.from_numpy((rng.normal(size=(nb, NE, size, size, cin))
                              * 0.5).astype(np.float32)).to(dev)
        k = torch.from_numpy((rng.normal(size=(3, 3, cin + f, 4 * f))
                              * (2.0 / (9 * (cin + f))) ** 0.5
                              ).astype(np.float32)).to(dev)
        b = torch.from_numpy((rng.normal(size=(4 * f,)) * 0.1)
                             .astype(np.float32)).to(dev)
        out = ops.convlstm_forward(x, k, b)
        ref = ops.convlstm_reference(x, k, b)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        kernel_ms = time_ms(lambda: ops.convlstm_forward(x, k, b), dev,
                            iters=5)
        plain_ms = time_ms(lambda: ops.convlstm_reference(x, k, b), dev,
                           iters=5)
        # partial yardstick: one echo's gate convolution alone (cuDNN)
        inp = torch.zeros((nb, cin + f, size, size), device=dev)
        w = k.permute(3, 2, 0, 1).contiguous()
        conv_ms = time_ms(lambda: F.conv2d(inp, w, padding=1), dev, iters=5)
        npx = nb * size * size
        flops = 2 * 9 * 4 * f * npx * (cin + (NE - 1) * (cin + f))
        n_bytes = 4 * (x.numel() + k.numel() + b.numel() + npx * f)
        b_ms, b_by = bound(n_bytes, flops)
        cases.append(dict(cin=cin, F=f, ne=NE, nb=nb, max_abs_err=err,
                          ref_max_abs=scale, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, gflop=flops / 1e9,
                          cudnn_one_echo_gate_conv_ms_partial=conv_ms))
        # f32 sums over K = 9*(Cin+F) = 342 terms in another order than
        # cuDNN's, carried through 6 echoes of the recurrence
        if err > 1e-4 * max(scale, 1.0):
            raise AssertionError(f"convlstm kernel disagrees with the "
                                 f"reference: {cases[-1]}")
        del x, inp
    main = cases[0]
    return dict(
        name=ops.CONVLSTM_KERNEL.name, route="cuda",
        source=ops.CONVLSTM_KERNEL.source,
        replaces="ideal_gan_tpu/ops/pallas_convlstm.py:177",
        launches=None, max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        tolerance="|d| <= 1e-4 * max(|plain|max, 1)", cases=cases)


def e2e_phase(dev, out_dir: Path, size: int = SIZE, n: int = 16,
              batch: int = NB_SERVE) -> dict:
    """The serving CLI on the card with the launch counters read around it,
    then the first chunk on the card and on the CPU, compared."""
    import numpy as np
    import torch
    from ideal_gan_tpu_torch import ops
    from ideal_gan_tpu_torch.cli import infer, roi_analysis
    from ideal_gan_tpu_torch.cli.common import load_cohorts

    argv = ["--model_sel", "AI-DEAL", "--synthetic", str(n), "--data_size",
            str(size), "--infer_batch", str(batch), "--export", "npz",
            "--seed", "0", "--device", str(dev), "--output_base",
            str(out_dir)]
    for k in ops.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    maps = infer.main(argv)
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    if maps.shape != (n, 3, size, size, 2) or not np.isfinite(maps).all():
        raise AssertionError(f"e2e maps shape {maps.shape} or not finite")
    with np.load(out_dir / "infer" / "maps_pred.npz") as npz:
        slices_per_s = float(npz["slices_per_s"])

    cfg = dict(infer.DEFAULTS, seed=0, synthetic=n, data_size=size)
    acqs, _, te = load_cohorts(cfg)
    a, t = acqs[:batch], te[:batch]
    set_tf32(False)
    dev_maps = roi_analysis._per_slice(
        roi_analysis.make_infer_run(cfg, a, dev), a, t, batch, dev)[0]
    t_cpu = time.perf_counter()
    cpu_maps = roi_analysis._per_slice(
        roi_analysis.make_infer_run(cfg, a, "cpu"), a, t, batch, "cpu")[0]
    cpu_s = time.perf_counter() - t_cpu
    pd_dev, _, _ = infer.maps_to_display(dev_maps)
    pd_cpu, _, _ = infer.maps_to_display(cpu_maps)
    maps_err = float(np.abs(dev_maps - cpu_maps).max())
    # PDFF = |F|/|W+F| is ill-conditioned where random nets make the fitted
    # water and fat cancel: compared where |W+F| > 0.2
    w_f = cpu_maps[:, 0] + cpu_maps[:, 1]
    stable = np.abs(w_f[..., 0] + 1j * w_f[..., 1]) > 0.2
    pdff_err = float(np.abs(pd_dev - pd_cpu)[stable].max())
    tf32_err = float(np.abs(maps[:batch] - cpu_maps).max())
    return dict(launches=launches, slices_per_s=slices_per_s,
                ms_per_slice=1e3 / slices_per_s, wall_s=wall,
                cpu_chunk_s=cpu_s, maps_max_abs_err_vs_cpu=maps_err,
                pdff_max_abs_err_vs_cpu=pdff_err,
                pdff_compared_share=float(stable.mean()),
                serving_tf32_maps_max_abs_diff_vs_cpu=tf32_err)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ideal_gan_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(ideal_gan_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    smi = smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    t_start = time.perf_counter()
    build_phase()
    set_tf32(False)
    kernels = [fit_entry(dev), convlstm_entry(dev)]
    emit("kernels", card=smi, kernels=kernels)
    set_tf32(True)  # the serving run at PyTorch's defaults
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        e2e = e2e_phase(dev, Path(tmp))
    emit("e2e", card=smi, **e2e)
    need = {"ideal_fit": 2, "convlstm_fwd": 24}
    short = {k: v for k, v in e2e["launches"].items() if v < need[k]}
    if short:
        raise AssertionError(f"main path skipped kernels: {short}")
    # float32 everywhere (TF32 off on the card); cuDNN's and the CPU's
    # convolutions sum in other orders through ~20 conv layers and the
    # 6-echo recurrence, and the fit amplifies field-map error by
    # 2*pi*te*fm_sc
    if e2e["maps_max_abs_err_vs_cpu"] > 5e-3 \
            or e2e["pdff_max_abs_err_vs_cpu"] > 5e-3:
        raise AssertionError(f"card and CPU maps disagree: {e2e}")
    for k in kernels:
        k["launches"] = e2e["launches"][k["name"]]
    emit("done", seconds=round(time.perf_counter() - t_start, 3))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
