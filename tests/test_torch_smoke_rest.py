"""`chip_smoke.py`'s rest phase (the Flipout decoders, CriticZ, SGAN,
PMComplex and InceptionV3 card vs CPU, the gradient penalty's double
backward, cli.test_gradients counted and card vs CPU, --debug_nans)
rehearsed at a tiny size on the CPU, where every wrapper takes its plain
version and the "card" run is a second CPU run on the same draws. Imports no
JAX.
"""

from pathlib import Path

import pytest
import torch

from ideal_gan_tpu_torch.utils import nans
from torch_one_thread import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture(autouse=True)
def sanitizer_off():
    yield
    nans.set_debug_nans(False)


def test_rest_phase_rehearses_on_cpu(chip_smoke, tmp_path):
    cpu = torch.device("cpu")
    r = chip_smoke.rest_phase(cpu, tmp_path, size=64, gan_size=32, f=4, d=4,
                              num_layers=2, latent=8, sgan_filters=4,
                              sgan_batch=1, pm_filters=4, inception_size=75,
                              downsample=2)
    mods = r["modules"]
    assert all(v["gap"] == 0.0 and v["vs_float64"] is None
               for v in mods.values())
    # 3 draws a Flipout convolution: the 12 residual blocks' 24 always, the
    # stem, the towers' stems and heads in train mode
    assert mods["bayes_decoder_train"]["n_draws"] == 3 * 29
    assert mods["bayes_decoder_eval"]["n_draws"] == 3 * 24
    assert mods["decoder_bayes_head_train"]["n_draws"] == 6
    assert mods["decoder_bayes_head_eval"]["n_draws"] == 0
    assert mods["bayes_decoder_train"]["shape"] == [1, 1, 32, 32, 2]
    assert mods["critic_z"]["shape"] == [1, 1, 1, 4]
    assert mods["inception_v3"]["shape"] == [6, 2048]
    for mode in ("wgan-gp", "dragan"):
        gp = r["gradient_penalty"][mode]
        assert gp["loss_rel_diff"] == gp["grad_max_rel"] == 0.0
        assert gp["loss"] > 0 and gp["leaves"] > 0
    for name in ("defaults", "f4_full"):
        run = r["test_gradients"][name]
        assert run["finite"] and run["max_grad"] > 0
        assert run["parity"]["loss_rel_diff"] == 0.0
        assert run["size"] == (32 if name == "defaults" else 64)
    pm = mods["pm_complex"]["pool_routes"]
    assert pm["pools"] == chip_smoke.PM_POOLS and pm["windows"] > 0
    assert pm["flipped"] == pm["flipped_at_ties"] \
        == [0] * chip_smoke.PM_POOLS
    assert pm["max_deficit"] == pm["max_delta"] == 0.0
    dn = r["debug_nans"]
    assert dn["same_loss"] and dn["flag_was_on"]
    assert "aten.convolution" in dn["nan_error"]
    # on the CPU the wrappers take their plain versions: an ATen op is named
    assert all(e and e.startswith("debug_nans: NaN in the output of aten.")
               for e in dn["kernel_nan_errors"].values())
    assert not nans.debug_nans_enabled()
    chip_smoke.check_rest(r, on_card=False)
    # the gates: the CPU launches no kernel; a module off the CPU passes
    # only inside the float64 envelope
    with pytest.raises(AssertionError, match="launched"):
        chip_smoke.check_rest(r)
    far = {"gap": 1e-3, "vs_float64": {"card": 1e-3, "cpu": 1e-4}}
    near = {"gap": 1e-3, "vs_float64": {"card": 1.5e-4, "cpu": 1e-4}}
    assert chip_smoke._module_fails(far)
    assert not chip_smoke._module_fails(near)
    assert chip_smoke._module_fails(dict(near, vs_float64=None))
    # InceptionV3 has no envelope; PMComplex must take the card's routes
    plain = dict(r, modules=dict(mods, inception_v3=near))
    with pytest.raises(AssertionError, match="inception_v3"):
        chip_smoke.check_rest(plain, on_card=False)
    unpinned = dict(r, modules=dict(mods, pm_complex=dict(
        mods["pm_complex"], pool_routes=None)))
    with pytest.raises(AssertionError, match="routes"):
        chip_smoke.check_rest(unpinned, on_card=False)


def test_pool_routes_pin_and_count_flips(chip_smoke):
    """`_PoolRoutes` records the port's complex max-pool routes, and a run
    on other values that takes them counts the windows it would route
    elsewhere: here an exact tie of |z| in (dx, dy) = (0, 0) and (0, 1),
    where the port takes the first and the record the second."""
    from ideal_gan_tpu_torch.models import complexnn
    gen = torch.Generator().manual_seed(0)
    z = torch.complex(torch.randn(1, 2, 4, 4, generator=gen),
                      torch.randn(1, 2, 4, 4, generator=gen))
    z[0, 0, 0, 0], z[0, 0, 1, 0] = 0.999999 + 0j, 1j
    z[0, 0, 0, 1] = z[0, 0, 1, 1] = 0.1j
    with chip_smoke._pool_dispatch(), torch.no_grad():
        with chip_smoke._routed(chip_smoke._PoolRoutes()) as rec:
            card = complexnn.complex_max_pool_2x2(z)
        z2 = z.clone()
        z2[0, 0, 0, 0] = 1.0 + 0j
        own = complexnn.complex_max_pool_2x2(z2)
        with chip_smoke._routed(chip_smoke._PoolRoutes(rec.calls)) as pin:
            pinned = complexnn.complex_max_pool_2x2(z2)
    assert card[0, 0, 0, 0] == 1j and pinned[0, 0, 0, 0] == 1j
    assert own[0, 0, 0, 0] == 1.0  # the first of equal maxima
    assert torch.equal(pinned.flatten()[1:], own.flatten()[1:])
    s = pin.summary()
    assert s["pools"] == 1 and s["windows"] == 8
    assert s["flipped"] == s["flipped_at_ties"] == [1]
    assert s["max_deficit"] == 0.0 and s["max_delta"] > 0
