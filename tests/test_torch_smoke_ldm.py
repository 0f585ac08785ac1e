"""`chip_smoke.py`'s ldm phase (the LDM CLIs on the gan phase's runs,
counted and timed; the card-vs-CPU denoiser step, reverse steps and DDIM
chain with their float64 witness) and the kernels phase's forward-only
ConvLSTM shape, rehearsed at a tiny size on the CPU, where every wrapper
takes its plain version: two tiny `train_gan` runs (f32 and bf16; 32²,
latent (8, 8, 12)), an LDM of F=8, dim_mults (1, 2), T=8, the VGG input
resized to 32² and its FID features from the first block (`VGG_TAPS`).
Imports no JAX.
"""

from pathlib import Path

import pytest
import torch

from ideal_gan_tpu_torch import ops
from ideal_gan_tpu_torch.cli import test_genmetrics, train_gan
from ideal_gan_tpu_torch.eval import metrics

ROOT = Path(__file__).resolve().parent.parent
TINY_LDM = ["--n_timesteps", "8", "--n_ldm_filters", "8", "--dim_mults",
            "[1,2]", "--infer_steps", "4"]
PARITY = dict(n_timesteps=8, n_ldm_filters=8, dim_mults=(1, 2),
              infer_steps=4)
# the FID embedding from the first VGG19 block alone (64 features): the
# host's sqrtm of the default taps' 1472² covariance takes 3–4 s
VGG_TAPS = (1,)


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


def _gan_runs(out: Path) -> None:
    for name, extra in (("gan", []), ("gan_bf16", ["--bf16", "1"])):
        train_gan.main([
            "--dataset", name, "--synthetic", "2", "--data_size", "32",
            "--n_G_filters", "12", "--n_downsamplings", "2",
            "--n_res_blocks", "1", "--encoded_size", "12", "--batch_size",
            "2", "--epochs", "1", "--A_loss", "MSE", "--device", "cpu",
            "--output_base", str(out), *extra])


def test_ldm_phase_rehearses_on_cpu(chip_smoke, one_thread, tmp_path,
                                    monkeypatch):
    monkeypatch.setattr(test_genmetrics, "echoes_to_vgg_input",
                        lambda x: metrics.echoes_to_vgg_input(x, size=32))
    monkeypatch.setattr(test_genmetrics, "init_vgg19",
                        lambda: metrics.init_vgg19(taps=VGG_TAPS))
    _gan_runs(tmp_path)
    cpu = torch.device("cpu")
    no_launches = {k.name: 0 for k in ops.KERNELS}
    r = chip_smoke.ldm_phase(cpu, tmp_path, tmp_path / "gan",
                             tmp_path / "gan_bf16", n=2, epochs=2, batch=2,
                             n_samples=2, size=32, flags=TINY_LDM,
                             parity_cfg=PARITY, lat=8, channels=12)
    main, bf16 = r["main"], r["bf16"]
    assert main["steps"] == 2 and main["encodes"] == 1 + 1 + 2
    assert bf16["steps"] == 1 and bf16["encodes"] == 3
    assert bf16["bf16"] and not main["bf16"]
    for run in (main, bf16, r["gen"], r["metrics"]):
        assert run["launches"] == no_launches
    for run in (main, bf16):
        assert run["finite"] and not run["no_gradient"]
        assert run["class_kernels_without_gradient"] == 2 + 1 + 1
        assert run["class_kernels_zero"]
        assert run["z_std_rel_diff"] <= 1e-12
        assert run["checkpoint_z_std"] == run["z_std"]
    assert main["step_ms"] > 0 and main["denoiser_ms"] > 0
    assert main["device_ms"] is None
    gen = r["gen"]
    assert gen["shapes_ok"] and gen["finite"] and gen["shards"] == 1
    assert gen["acqs_shape"] == [2, 6, 32, 32, 2]
    assert len(gen["seconds_per_batch"]) == 1
    res = r["metrics"]["results"]
    assert r["metrics"]["finite"] and res["features"] in ("imagenet",
                                                           "random-init")
    assert "MS_SSIM_pairs" not in res  # 32 px < 176
    par = r["parity"]
    assert par["step"]["loss_rel_diff"] == par["step"]["grad_max_rel"] == 0
    assert par["step"]["vs_cpu_float64"]["card"] == \
        par["step"]["vs_cpu_float64"]["cpu"] < 1e-4
    assert par["reverse_steps"] == {"ddpm": 0.0, "ddim": 0.0}
    ch = par["ddim_chain"]
    assert ch["steps"] == 4 and ch["card_vs_cpu"] == 0.0
    assert 0.0 < ch["card_vs_f64"] == ch["cpu_vs_f64"] < 1e-5
    # the gates pass but for the launches (the CPU counts none) and the
    # MS-SSIM of 176 px or more
    with pytest.raises(AssertionError, match="6 times an encode"):
        chip_smoke.check_ldm(r)
    for run in (main, bf16):
        fwd = chip_smoke.GAN_LSTM[run["bf16"]][0]
        run["launches"] = dict(no_launches, **{fwd: 6 * run["encodes"]})
    with pytest.raises(AssertionError, match="metrics missing"):
        chip_smoke.check_ldm(r)
    res["MS_SSIM_pairs"] = 0.5
    chip_smoke.check_ldm(r)
    # controls: a backward launch, an encoder run while sampling, a z_std
    # off its float64 value, a chain farther from float64 than 2x the CPU
    for broken, match in (
            (("main", "launches", dict(main["launches"], convlstm_bwd=1)),
             "backward never"),
            (("gen", "launches", dict(no_launches, convlstm_fwd=6)),
             "ran the encoder"),
            (("bf16", "z_std_rel_diff", 2e-6), "z_std"),
            (("main", "no_gradient", ["final_conv.bias"]), "without a"),
    ):
        part, key, value = broken
        saved = r[part][key]
        r[part][key] = value
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_ldm(r)
        r[part][key] = saved
    ch["card_vs_f64"] = 2.1 * ch["cpu_vs_f64"]
    with pytest.raises(AssertionError, match="ddim_chain"):
        chip_smoke.check_ldm(r)


def test_bf16_forward_only_shape_rehearses_on_cpu(chip_smoke, one_thread):
    """A shape in `fwd_only` (the LDM's encode at (nb=8, 192²) on the card)
    gets the forward case and no backward case."""
    cpu = torch.device("cpu")
    shapes = ((2, 6, 1), (1, 6, 1), (2, 8, 1), (2, 6, 2, 8))
    fwd, bwd = chip_smoke.convlstm_bf16_entries(
        cpu, size=12, shapes=shapes, fwd_only=((2, 6, 2, 8),))
    assert [(c["nb"], c["size"]) for c in fwd["cases"]][-1] == (2, 8)
    assert all(c["nb"] == 1 for c in bwd["cases"])
    assert len(bwd["cases"]) == 3 * len(chip_smoke.KINK_FREE)
    assert chip_smoke.LDM_ENCODE_SHAPE in chip_smoke.LSTM_FWD_SHAPES
    assert chip_smoke.LSTM_BF16_FWD_ONLY == (chip_smoke.LDM_ENCODE_SHAPE,)
