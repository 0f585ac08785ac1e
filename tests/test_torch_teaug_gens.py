"""The TE-augmentation trainer's other generators vs the JAX package: the
U-Net, the 2U-Net (both steps: G_A2B's with G_A2R2 run without a gradient,
then G_A2R2's with G_A2B frozen), MDWF-Net on the legacy layout with its
"dense_l1" TE input, and `out_vars="WF"`; and the port's teaug CLI on each.

Inputs are made with numpy from a seed and handed to both packages (TE
trains as arrays, the JAX package's noise passed to the port); weights are
Flax parameters drawn at random (the TEEncoders' and the Dense's biases
spread, `test_torch_teaug._random_params`), converted by
`ideal_gan_tpu_torch.convert`, which also maps gradient trees. Nets have 2
levels of F=4 at 32² (both packages' `build_model` nets with
`num_layers=2`). G_A2R2's gradient is read from the JAX package's own
`make_r2_train_step`, run with `optax.identity()`: the parameters it
returns are the old ones plus the gradient. Tolerances: the loss and every
metric rtol 2e-5; every gradient leaf to 1e-3 of the global gradient scale
(tests/test_torch_sup.py).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.data import layouts as jlayouts  # noqa: E402
from ideal_gan_tpu.train import teaug as jteaug  # noqa: E402
from ideal_gan_tpu_torch import convert, models  # noqa: E402
from ideal_gan_tpu_torch.cli import train_teaug  # noqa: E402
from ideal_gan_tpu_torch.train import teaug as tteaug  # noqa: E402
from ideal_gan_tpu_torch.utils import Checkpoint  # noqa: E402

from test_torch_teaug import _grads, _random_params, _te, _worst_grad  # noqa: E402

F_SMALL, LAYERS, SIZE, NE = 4, 2, 32, 6
CASES = {
    "U-Net": dict(G_model="U-Net", R2_TV_weight=1e-3, FM_TV_weight=1e-3),
    "2U-Net": dict(G_model="2U-Net", R2_TV_weight=1e-3),
    "MDWF-Net": dict(G_model="MDWF-Net", FM_TV_weight=1e-3),
    "U-Net-WF": dict(G_model="U-Net", out_vars="WF"),
    "VET-Net-WF": dict(out_vars="WF"),
}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The nets here are tiny: under the Tier-1 command's parallel workers
    torch's thread pool costs more time than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    """Synthetic maps, a jittered TE train and the JAX package's noise."""
    _, maps, _ = (np.array(a) for a in j_synthetic(2, h=SIZE, w=SIZE, ne=NE))
    te = _te("jittered", 2, seed=8)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.normal(key, (2, NE, SIZE, SIZE, 2)))
    return maps, te, key, noise


@pytest.fixture
def two_level_port(monkeypatch):
    """`train.teaug.build_model` and `build_r2_model` choosing among 2-level
    nets."""
    for name in ("UNet", "VETNet", "MDWFNet"):
        monkeypatch.setattr(tteaug, name, functools.partial(
            getattr(models, name), num_layers=LAYERS))


def _to_sd(g_model, tree):
    if g_model in ("U-Net", "2U-Net"):
        return convert.unet(tree, LAYERS)
    if g_model == "MDWF-Net":
        return convert.mdwfnet(tree, LAYERS)
    return convert.vetnet(tree, LAYERS)


def _nets(cfg, seed):
    """The JAX nets (G_A2B, G_A2R2 or None) at 2 levels with random
    parameters, and the port's loaded with them."""
    jm = jteaug.build_model(cfg).clone(num_layers=LAYERS)
    a = jnp.zeros((1, NE, SIZE, SIZE, 2))
    te_vec = jnp.asarray(_te("jittered", 1)[..., 0])
    x = jlayouts.acqs_from_mebcrn(a) if cfg["G_model"] == "MDWF-Net" else a
    p = _random_params(jm, seed, x, te_vec)
    tm = tteaug.build_model(cfg)
    tm.load_state_dict(_to_sd(cfg["G_model"], p))
    if cfg["G_model"] != "2U-Net":
        return jm, p, tm, None, None, None
    jr2 = jteaug.build_r2_model(cfg).clone(num_layers=LAYERS)
    p_r2 = _random_params(jr2, seed + 1, a[..., :1], te_vec)
    tr2 = tteaug.build_r2_model(cfg)
    tr2.load_state_dict(convert.unet(p_r2, LAYERS))
    return jm, p, tm, jr2, p_r2, tr2


def _check(loss, metrics, j_val, j_metrics, grads, j_grads):
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(j_metrics[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    assert abs(float(loss.detach()) - float(j_val)) \
        / max(abs(float(j_val)), 1.0) <= 2e-5
    assert _worst_grad(grads, j_grads) <= 1e-3


@pytest.mark.parametrize("case", CASES)
def test_generator_step_matches_jax(batch, two_level_port, case):
    maps, te, key, noise = batch
    cfg = dict(jteaug.DEFAULTS, n_G_filters=F_SMALL, **CASES[case])
    jm, p, tm, jr2, p_r2, tr2 = _nets(cfg, 31)
    (j_val, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        jteaug.make_loss_fn(cfg, jm, jr2), has_aux=True))(
            p, p_r2, jnp.asarray(maps), jnp.asarray(te), key)
    loss, metrics = tteaug.make_loss_fn(cfg, tm, tr2)(_t(maps), _t(te),
                                                      _t(noise))
    loss.backward()
    _check(loss, metrics, j_val, j_metrics, _grads(tm),
           _to_sd(cfg["G_model"], j_grads))
    if tr2 is not None:  # G_A2R2 runs in G_A2B's step without a gradient
        assert all(q.grad is None for q in tr2.parameters())


def test_2unet_r2_step_matches_jax(batch, two_level_port):
    maps, te, key, noise = batch
    cfg = dict(jteaug.DEFAULTS, n_G_filters=F_SMALL, G_model="2U-Net",
               R2_TV_weight=1e-3)
    jm, p, tm, jr2, p_r2, tr2 = _nets(cfg, 41)
    tx = optax.identity()
    state = jteaug.TEAugState(p, tx.init(p), jnp.zeros((), jnp.int32), p_r2,
                              tx.init(p_r2))
    step = jteaug.make_r2_train_step(cfg, jm, jr2, tx)
    new, j_metrics = step(state, (jnp.asarray(maps), jnp.asarray(te)), key)
    j_grads = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        new.params_r2, p_r2)

    loss, metrics = tteaug.make_r2_loss_fn(cfg, tm, tr2)(_t(maps), _t(te),
                                                         _t(noise))
    loss.backward()
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(j_metrics[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    assert float(loss.detach()) > 0
    assert _worst_grad(_grads(tr2), convert.unet(j_grads, LAYERS)) <= 1e-3
    assert all(q.grad is None for q in tm.parameters())  # G_A2B frozen


def test_mdwf_net_with_wf_outputs_raises(batch):
    """The JAX package's WF branch hands MDWF-Net the 5-D echoes, which its
    legacy-layout net cannot take (Flax raises a parameter shape error);
    the port raises too."""
    maps, te, _, noise = batch
    cfg = dict(tteaug.DEFAULTS, G_model="MDWF-Net", out_vars="WF",
               n_G_filters=F_SMALL)
    loss_fn = tteaug.make_loss_fn(cfg, tteaug.build_model(cfg))
    with pytest.raises(ValueError, match="legacy"):
        loss_fn(_t(maps), _t(te), _t(noise))


def test_unported_settings_raise_for_the_2unet():
    # bf16, remat and microbatch are ported: the same state-dict names
    cfg = dict(tteaug.DEFAULTS, G_model="2U-Net", n_G_filters=4)
    for build in (tteaug.build_model, tteaug.build_r2_model):
        keys = set(build(cfg).state_dict())
        for over in (dict(microbatch=2), dict(bf16=True), dict(remat=True)):
            assert set(build(dict(cfg, **over)).state_dict()) == keys
    with pytest.raises(NameError):
        tteaug.build_model(dict(tteaug.DEFAULTS, G_model="MEBCRN"))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(tmp_path, *extra):
    return train_teaug.main(
        ["--device", "cpu", "--synthetic", "4", "--data_size", "32",
         "--batch_size", "2", "--n_G_filters", str(F_SMALL), "--output_base",
         str(tmp_path), "--epochs", "1", *extra])


@pytest.mark.parametrize("g_model", ["U-Net", "MDWF-Net"])
def test_cli_trains_generator(tmp_path, g_model):
    out = _cli(tmp_path, "--G_model", g_model)
    state = out["state"]
    assert state.step == 2 and state.r2_model is None
    assert np.isfinite(out["epochs"][0]["PM_loss"])
    saved = Checkpoint(tmp_path / "TEaug-300" / "checkpoints").restore(1)
    assert set(saved) == {"model", "opt", "step"}


def test_cli_2unet_alternates_and_checkpoints_both_nets(tmp_path, capsys):
    out = _cli(tmp_path, "--G_model", "2U-Net")
    state = out["state"]
    assert state.step == 2 and state.opt_r2.count == state.opt.count == 2
    ep = out["epochs"][0]
    assert {"R2_loss", "TV_R2_aux", "WF_loss_aux", "PM_loss"} <= set(ep)
    ckdir = tmp_path / "TEaug-300" / "checkpoints"
    saved = Checkpoint(ckdir).restore(1)
    assert set(saved) == {"model", "opt", "step", "r2_model", "opt_r2"}
    again = _cli(tmp_path, "--G_model", "2U-Net", "--epochs", "2")
    assert again["state"].opt_r2.count == saved["opt_r2"]["count"] + 2
    for k, v in saved["r2_model"].items():
        if k.endswith("bias_ih_l0"):
            continue
        assert not torch.equal(again["state"].r2_model.state_dict()[k], v), k
    assert "resumed from epoch 1" in capsys.readouterr().out


def test_cli_wf_outputs(tmp_path):
    out = _cli(tmp_path, "--G_model", "U-Net", "--out_vars", "WF")
    ep = out["epochs"][0]
    assert ep["PM_loss"] == ep["WF_loss"] == ep["G_loss"] > 0
