"""`chip_smoke.py`'s kernels phase rehearsed at a tiny size on the CPU, where
every wrapper takes its plain version: each kernel entry's control flow and
the fields of the `kernels` line, before any chip time is spent. Imports no
JAX. Budget: 240 s for the file on a loaded Tier-1 worker (110.4–129.5 s
under the Tier-1 command; 3.6 s alone; 210.1 s under it with the bf16
entries' rehearsal on torch's default thread pool; 2.5 s on one thread
beside five port files on six workers).
"""

from pathlib import Path

import pytest
import torch

from ideal_gan_tpu_torch import ops
from torch_one_thread import one_thread  # noqa: F401

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
    # and the bf16 storage mode's two (test_convlstm_bf16_entries_...)
    assert len(ops.KERNELS) == 8
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


def test_convlstm_bf16_entries_rehearse_on_cpu(chip_smoke):
    """The bf16 storage mode's forward and backward entries: the fields of
    the `kernels` line, the gate against the plain version (plain vs plain
    here), the f32 and float64 witnesses and the ulp shares, the bound at
    the dense bf16 rate, the timed backward case per shape."""
    cpu = torch.device("cpu")
    shapes = ((2, 6, 1), (1, 6, 1), (2, 8, 1), (1, 8, 1))
    fwd, bwd = chip_smoke.convlstm_bf16_entries(cpu, size=12, shapes=shapes)
    _check_entries(((fwd, 4), (bwd, 8)))
    assert fwd["name"] == ops.CONVLSTM_BF16_KERNEL.name == "convlstm_fwd_bf16"
    assert bwd["name"] == ops.CONVLSTM_BWD_BF16_KERNEL.name
    assert fwd["source"] == ops.CONVLSTM_KERNEL.source
    assert fwd["replaces"].endswith(":177") and bwd["replaces"].endswith(
        ":517")
    assert fwd["sass"] is None and bwd["sass"] is None
    assert fwd["max_abs_err"] == bwd["max_abs_err"] == 0.0
    assert fwd["deterministic"] and bwd["deterministic"]
    assert fwd["wide"]["F"] == bwd["wide"]["F"] == 8
    for c in fwd["cases"]:
        assert c["share_beyond_1ulp"] == 0.0 and c["device_ms"] is None
        # bf16 against the f32 and float64 plain versions: apart; the f32
        # version's output, held to the bf16 plain version, fails the gate
        for w in (c["vs_f32_kernel"], c["vs_plain_f64"]):
            assert w["max_abs_err"] > 0.0
        assert c["f32_kernel_control"]["fails"]
        assert c["f32_kernel_control"]["share_beyond_1ulp"] \
            > chip_smoke.BF16_ULP_SHARE
        assert c["bound_by"] == "operations"
        assert c["cudnn_one_echo_gate_conv_bf16_ms_partial"] > 0.0
    assert {c["inputs"] for c in bwd["cases"]} == set(chip_smoke.KINK_FREE)
    timed = [c for c in bwd["cases"] if "ms" in c]
    assert len(timed) == 4 and all(c["inputs"] == "smooth" for c in timed)
    for c in timed:
        assert c["stages_device_ms"] is None and c["plain_ms"] > 0.0
        for n in ("dx", "dk", "db"):
            assert c[n]["max_abs_err"] == 0.0
            assert c[n]["vs_plain_f64"]["max_abs_err"] > 0.0
        assert c["f32_kernel_control_fails"]
    # u = 2^-8 over ne = 6 echoes
    assert chip_smoke.bf16_gate(1.0) == 6 * 2 * 2.0 ** -8
    # the share gate alone rejects a reading within bf16_gate
    assert chip_smoke.bf16_fails(dict(max_abs_err=0.0, scale=1.0,
                                      share_beyond_1ulp=0.03))
    assert not chip_smoke.bf16_fails(dict(max_abs_err=0.01, scale=1.0,
                                          share_beyond_1ulp=0.01))


def test_hmma_count_reads_cuobjdump(chip_smoke, monkeypatch, tmp_path):
    """`hmma_counts` counts HMMA and HGMMA lines per kernel in `cuobjdump
    -sass`; `sass_counts` the lines that hold each label's substrings, and
    `bf16_claims_missing` names the instructions a bf16 kernel lacks."""
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
                    "  /*0010*/ FADD R1, R2, R3 ;\n"
                    "  Function : _ZN4anon13gates_wg_bf16E\n"
                    "  /*0010*/ UTMALDG.4D [UR8], [UR4] ;\n"
                    "  /*0020*/ HGMMA.64x96x16.F32.BF16 R24, gdesc[UR4], "
                    "R24 ;\n"
                    "  /*0030*/ LDSM.16.M88.4 R4, [R2] ;\nX\n")
    tool.chmod(0o755)
    monkeypatch.setattr(_build, "_lib_path", lambda name: lib)
    monkeypatch.setenv("PATH", f"{tmp_path}:/usr/bin:/bin")
    got = chip_smoke.hmma_counts("convlstm_bwd",
                                 ["gates_mma", "dk_mma", "sum_slots"])
    assert got == {"gates_mma": 2, "dk_mma": 0, "sum_slots": 0}
    # with an opcode, only the HMMA lines that hold it
    assert chip_smoke.hmma_counts("convlstm_bwd", ["gates_mma"], "BF16") \
        == {"gates_mma": 0}
    assert chip_smoke.hmma_counts("convlstm_bwd", ["gates_wg_bf16"],
                                  "BF16") == {"gates_wg_bf16": 1}
    sass = chip_smoke.sass_counts("convlstm_bwd", ["gates_wg_bf16"],
                                  chip_smoke.BF16_SASS)
    assert sass == {"gates_wg_bf16": dict(HGMMA=1, HMMA=0, UTMALDG=1,
                                          UBLKCP=0, LDGSTS=0, LDSM=1,
                                          LDG16=0)}
    assert chip_smoke.bf16_claims_missing(sass) == [("gates_wg_bf16",
                                                     "UBLKCP")]
    assert chip_smoke.bf16_claims_missing(None) == []
