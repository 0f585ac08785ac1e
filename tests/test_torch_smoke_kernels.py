"""`chip_smoke.py`'s kernels phase rehearsed at a tiny size on the CPU, where
every wrapper takes its plain version: each kernel entry's control flow and
the fields of the `kernels` line, before any chip time is spent. Imports no
JAX. Budget: 240 s for the file on a loaded Tier-1 worker (110.4–129.5 s
under the Tier-1 command; 3.6 s alone).
"""

from pathlib import Path

import pytest
import torch

from ideal_gan_tpu_torch import ops

ROOT = Path(__file__).resolve().parent.parent
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}
SHAPES = ((2, 6, 1), (1, 6, 1), (2, 8, 1))  # (Cin, F, nb)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


def _check_entries(entries):
    for entry, n_cases in entries:
        assert KERNEL_KEYS <= set(entry)
        assert len(entry["cases"]) == n_cases
        assert Path(ROOT, entry["source"]).is_file()


def test_physics_kernel_entries_rehearse_on_cpu(chip_smoke):
    """The fit, cycle, synthesis and magnitude-fit entries."""
    cpu = torch.device("cpu")
    fit = chip_smoke.fit_entry(cpu, size=32, nbs=(2, 3))
    cycle = chip_smoke.cycle_entry(cpu, size=16, nb=2)
    synth = chip_smoke.forward_entry(cpu, size=16, nb=2)
    mag_fit = chip_smoke.mag_fit_entry(cpu, size=16, nb=2)
    _check_entries(((fit, 8), (cycle, 2), (synth, 4), (mag_fit, 4)))
    assert {e["name"] for e in (fit, cycle, synth, mag_fit)} == {
        k.name for k in (ops.FIT_KERNEL, ops.CYCLE_KERNEL, ops.FORWARD_KERNEL,
                         ops.MAG_FIT_KERNEL)}
    assert 0.0 < synth["clamped_share"] < 0.5
    for entry in (fit, cycle, synth, mag_fit):  # profiler time: card only
        assert "device_ms" in entry and entry["device_ms"] is None
        assert entry["max_abs_err"] == 0.0  # plain vs plain here
    assert {c["te"] for c in mag_fit["cases"]} == {"uniform", "jittered"}
    assert all(c[n]["beyond_1e_5_1e_4"] == 0 for c in mag_fit["cases"]
               for n in ("rho", "recon", "ls_coeffs", "uncertainty"))


def test_convlstm_kernel_entries_rehearse_on_cpu(chip_smoke):
    """The ConvLSTM forward and backward entries: the forward's float64
    distance, determinism check and 3xTF32 / FP32 bounds; the backward's
    float64 gate, its pair gates on random inputs (the kink-masked first
    pair against float64 among them), its determinism check, and
    its recompute / sweep split; the HMMA counts of both (None here: no
    card, no build)."""
    cpu = torch.device("cpu")
    lstm = chip_smoke.convlstm_entry(cpu, size=16, shapes=SHAPES)
    bwd = chip_smoke.convlstm_bwd_entry(cpu, size=12, shapes=SHAPES)
    _check_entries(((lstm, 3), (bwd, 9)))
    # with the physics entries, every kernel of the port has its entry
    assert {lstm["name"], bwd["name"]} == {ops.CONVLSTM_KERNEL.name,
                                           ops.CONVLSTM_BWD_KERNEL.name}
    assert len(ops.KERNELS) == 6
    for entry in (lstm, bwd):
        assert entry["wide"]["F"] == 8 and entry["wide"]["cin"] == 2
    assert lstm["max_abs_err"] == 0.0  # plain vs plain here
    # the forward against float64: here the plain f32 version's distance
    assert lstm["hmma"] is None and lstm["device_ms"] is None
    assert lstm["deterministic"] is True
    for c in lstm["cases"]:
        assert c["deterministic"] and c["device_ms"] is None
        assert 0.0 < c["max_abs_err_vs_f64"] < 1e-5 * c["f64_max_abs"]
        assert c["max_abs_err_vs_f64"] == c["plain_f32_vs_f64"]
        # 3xTF32 on the tensor cores: 495/3 TFLOP/s against FP32's 67
        assert c["bound_by"] == "operations"
        assert c["bound_ms"] == pytest.approx(c["bound_fp32_ms"] * 67 / 165)
        assert c["cudnn_one_echo_gate_conv_tf32_ms_partial"] > 0.0
    assert lstm["max_abs_err_vs_f64"] == max(
        c["max_abs_err_vs_f64"] for c in lstm["cases"])
    # the backward is held to the plain version in float64 too
    assert bwd["max_abs_err"] < 1e-5
    assert all(c[n]["max_abs_err"] == 0.0 for c in bwd["cases"]
               for n in ("dx", "dk", "db"))
    # random inputs: two launches bit for bit, and the bounds of the split
    random = [c for c in bwd["cases"] if c["inputs"] == "random"]
    assert len(random) == 3 and all(c["deterministic"] for c in random)
    assert bwd["deterministic"] is True
    assert bwd["hmma"] is None and bwd["stages_device_ms"] is None
    for c in random:
        assert c["recompute"]["device_ms"] is None
        assert c["sweep"]["device_ms"] is None
        # 3xTF32 on the tensor cores: 495/3 TFLOP/s against FP32's 67
        assert c["sweep"]["bound_ms"] == pytest.approx(
            c["sweep"]["bound_fp32_ms"] * 67 / 165)
        assert c["bound_ms"] == c["sweep"]["bound_ms"]
        assert c["recompute"]["bound_ms"] == pytest.approx(
            c["recompute"]["bound_fp32_ms"] * 67 / 165)
        assert c["recompute"]["bound_ms"] > 0.0
    assert bwd["wide"]["sweep"] == random[-1]["sweep"]
    # random inputs: the launch against its launches on pairs of samples
    odd = chip_smoke.convlstm_bwd_entry(cpu, size=8, shapes=((1, 4, 3),))
    pairs = [c[n] for c in bwd["cases"] + odd["cases"]
             if c["inputs"] == "random" for n in ("dx", "dk", "db")]
    assert len(pairs) == 12
    assert all(p["vs_pairs"] <= 1e-6 * p["scale"] for p in pairs)
    # the first pair against float64, g zeroed around the kink (plain vs
    # plain here)
    for c in random:
        assert 0.0 <= c["kink_masked_share"] < 1.0
        for n in ("dx", "dk", "db"):
            assert c[n]["kink_masked_vs_f64"] \
                == c[n]["kink_masked_plain_f32_vs_f64"]
            assert c[n]["kink_masked_vs_f64"] \
                < 1e-5 * c[n]["kink_masked_scale"]


def test_hmma_count_reads_cuobjdump(chip_smoke, monkeypatch, tmp_path):
    """`hmma_counts` counts HMMA lines per kernel in `cuobjdump -sass`."""
    from ideal_gan_tpu_torch.ops import _build
    lib = tmp_path / "lib.so"
    lib.write_bytes(b"")
    tool = tmp_path / "cuobjdump"
    tool.write_text("#!/bin/sh\ncat <<'X'\n"
                    "  Function : _ZN4anon9gates_mmaE\n"
                    "  /*0010*/ HMMA.1684.F32.TF32 R4, R8, R12, R4 ;\n"
                    "  /*0020*/ FADD R1, R2, R3 ;\n"
                    "  /*0030*/ HMMA.1684.F32.TF32 R4, R8, R12, R4 ;\n"
                    "  Function : _ZN4anon9sum_slotsE\n"
                    "  /*0010*/ FADD R1, R2, R3 ;\nX\n")
    tool.chmod(0o755)
    monkeypatch.setattr(_build, "_lib_path", lambda name: lib)
    monkeypatch.setenv("PATH", f"{tmp_path}:/usr/bin:/bin")
    got = chip_smoke.hmma_counts("convlstm_bwd",
                                 ["gates_mma", "dk_mma", "sum_slots"])
    assert got == {"gates_mma": 2, "dk_mma": 0, "sum_slots": 0}
