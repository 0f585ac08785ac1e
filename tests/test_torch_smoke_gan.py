"""`chip_smoke.py`'s gan phase (the GAN CLI at the JAX defaults with the
adversary, counted and timed; one short epoch each with VQ, cGAN and bf16;
the card-vs-CPU g- and d-steps with their float64 witness and the bf16
gate) and the kernels phase's batch-elementwise ConvLSTM check, rehearsed
at a tiny size on the CPU, where every wrapper takes its plain version
(the VGG input resized to 32² instead of 224², the PatchGAN 8 wide).
Imports no JAX. Under the Tier-1 command (six workers) the file took 70 s
with the PatchGAN at its full width 72.
"""

from pathlib import Path

import pytest
import torch

from ideal_gan_tpu_torch import ops
from ideal_gan_tpu_torch.eval import metrics
from ideal_gan_tpu_torch.train import gan

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gan_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path,
                                    monkeypatch):
    monkeypatch.setattr(gan, "echoes_to_vgg_input",
                        lambda x: metrics.echoes_to_vgg_input(x, size=32))
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    g = chip_smoke.gan_phase(cpu, tmp_path, size=32, f=4, n=1, epochs=2,
                             n_short=1, parity_size=32, d=8)
    runs = {"main": g["main"], **g["short"]}
    assert set(g["short"]) == {"vq", "cgan", "bf16"}
    for name, r in runs.items():
        assert r["launches"] == r["g_step_launches"] == no_launches, name
        assert r["finite"] and not r["no_gradient"], name
        # u moves on d-steps only
        assert r["u_changed_by_run"] and r["u_changed_by_d_step"], name
        assert not r["u_changed_by_g_step"], name
        assert "D_A_r1" in r["epochs"][-1] and "G_loss" in r["epochs"][-1]
    assert g["main"]["g_steps"] == g["main"]["d_steps"] == 2
    assert g["short"]["bf16"]["bf16"] and not g["main"]["bf16"]
    assert "VQ_perplexity" in g["short"]["vq"]["epochs"][-1]
    assert g["main"]["device_ms"] is None and g["main"]["g_step_ms"] > 0
    par = g["parity"]
    for step in ("g_step", "g_step_no_adversary", "d_step"):
        assert par[step]["loss_rel_diff"] == par[step]["grad_max_rel"] == 0
        vs64 = par[step]["vs_cpu_float64"]
        assert vs64["card"] == vs64["cpu"] < 5e-2
        assert par[step]["loss_vs_f64"]["card"] == \
            par[step]["loss_vs_f64"]["cpu"]
    assert "D_A_r1" in par["d_step"]["metrics"]
    assert par["g_step_no_adversary"]["metrics"]["A2B2A_g_loss"] == 0.0
    bf16 = par["bf16_g_step_no_adversary"]
    assert not bf16["failures"] and bf16["controls_fail"]
    # the envelope gate: a card step off the CPU's and off float64 fails it
    wrong = dict(par["d_step"], grad_max_rel=0.5,
                 vs_cpu_float64={"card": 0.5, "cpu": 1e-3})
    assert chip_smoke._gan_parity_failures({"d": wrong}) == {
        "d": ["gradients"]}
    near = dict(wrong, vs_cpu_float64={"card": 0.05, "cpu": 0.03})
    assert chip_smoke._gan_parity_failures({"d": near}) == {}
    # the gates pass but for the launches, which the CPU does not count
    with pytest.raises(AssertionError, match="every g-step only"):
        chip_smoke.check_gan(g)
    for r in runs.values():
        lstm = chip_smoke.GAN_LSTM[r["bf16"]]
        r["g_step_launches"] = dict(no_launches, **{lstm[0]: 11, lstm[1]: 7})
        r["launches"] = dict(no_launches, **{
            lstm[0]: 11 * r["g_steps"], lstm[1]: 7 * r["g_steps"]})
    chip_smoke.check_gan(g)
    g["short"]["cgan"]["d_step_launches"] = dict(no_launches,
                                                 convlstm_fwd=1)
    with pytest.raises(AssertionError, match="every g-step only"):
        chip_smoke.check_gan(g)


def test_convlstm_batch_elementwise_rehearses_on_cpu(chip_smoke, one_thread):
    """The fields and the gate; the CPU's plain versions are not bitwise
    batch-invariant (their convolutions sum in batch-dependent orders), so
    here only the reductions are held and the gate's failure is shown."""
    be = chip_smoke.convlstm_batch_elementwise(torch.device("cpu"), size=8,
                                               f=4)
    for dtype in ("float32", "bfloat16"):
        r = be[dtype]
        assert max(r["reduced_rel_diff"].values()) <= r["reduced_tol"]
        assert isinstance(r["h_bit_equal"], bool)
    for dtype in ("float32", "bfloat16"):
        be[dtype].update(h_bit_equal=True, dx_bit_equal=True, ok=True)
    chip_smoke.check_batch_elementwise(be)
    be["bfloat16"]["ok"] = False
    with pytest.raises(AssertionError, match="batch-elementwise"):
        chip_smoke.check_batch_elementwise(be)
