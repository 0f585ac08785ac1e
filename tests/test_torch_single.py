"""The single-subject magnitude–phase trainer of the port vs the JAX package:
the (FF, PD, phase) and the separate magnitude/phase forward models with
the bipolar readout phase, values and gradients; the trainer's loss,
metrics and gradients (bipolar and unipolar; MSE, MAE and MSLE; an even
and an odd width, where the symmetry term's negative-step slice is
rewritten with `torch.flip`); the whole nets' step; the CLI; and the loss
falling over 5 steps, as JAX's tests/test_train_mag_single.py:107-112.

Inputs are made with numpy from a seed and handed to both packages; the
nets' weights are Flax parameters (every leaf perturbed) converted by
`ideal_gan_tpu_torch.convert.single`. Tolerances, each the JAX package's
own:
- the forward models rtol 1e-4 / atol 1e-5 and their gradients rtol 1e-3 /
  atol 1e-5 (the cycle's, tests/test_pallas_kernels.py:101-173);
- the loss on the nets' outputs (stand-in nets that return a tensor, so
  that any width runs): loss and metrics 2e-5 relative to max(|JAX|, 1),
  the gradient of the outputs rtol 1e-3 / atol 1e-5·scale;
- the whole nets' step: loss and metrics 2e-5, every gradient leaf 2e-2 of
  the global gradient scale (MODEL_PARITY.json `tolerances`).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.train import single as jsingle  # noqa: E402
from ideal_gan_tpu_torch import convert, physics  # noqa: E402
from ideal_gan_tpu_torch.cli import train_single  # noqa: E402
from ideal_gan_tpu_torch.train import single as tsingle  # noqa: E402
from ideal_gan_tpu_torch.utils import Checkpoint  # noqa: E402

from test_torch_models import flax_params  # noqa: E402

F_SMALL = 4


@pytest.fixture(autouse=True)
def one_thread():
    """The nets here are tiny: under the Tier-1 command's parallel workers
    torch's thread pool costs more time than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _te(nb, seed=None):
    te = np.asarray(jph.te_train(6, bs=nb), np.float32)
    if seed is not None:
        te = te + np.random.default_rng(seed).uniform(
            -2e-4, 2e-4, te.shape).astype(np.float32)
    return te


# --------------------------------------------------------------------------
# the forward models
# --------------------------------------------------------------------------

def _mag_phase_maps(nb, h, w, seed):
    rng = np.random.default_rng(seed)
    row0 = np.concatenate([rng.uniform(0.1, 0.8, (nb, h, w, 2)),
                           rng.uniform(0.0, 0.3, (nb, h, w, 1)),
                           rng.normal(size=(nb, h, w, 1))], -1)
    row1 = np.concatenate([rng.uniform(-0.1, 0.1, (nb, h, w, 2)),
                           rng.uniform(-0.2, 0.2, (nb, h, w, 1)),
                           rng.uniform(-0.1, 0.1, (nb, h, w, 1))], -1)
    return np.stack([row0, row1], 1).astype(np.float32)


def _ffpd_maps(nb, h, w, seed):
    rng = np.random.default_rng(seed)
    maps = np.stack([
        np.stack([rng.uniform(0, 1, (nb, h, w)),
                  rng.normal(size=(nb, h, w))], -1),
        np.stack([rng.uniform(0.2, 1, (nb, h, w)),
                  rng.uniform(0, 0.3, (nb, h, w))], -1),
        np.stack([rng.uniform(-0.1, 0.1, (nb, h, w)),
                  rng.uniform(-0.2, 0.2, (nb, h, w))], -1)], 1)
    return maps.astype(np.float32)


SYNTHS = {"mag_phase": (jph.synthesize_mag_phase,
                        physics.synthesize_mag_phase, _mag_phase_maps),
          "mag": (jph.synthesize_mag, physics.synthesize_mag, _ffpd_maps)}


@pytest.mark.parametrize("name", sorted(SYNTHS))
@pytest.mark.parametrize("te_kind", ["uniform", "jittered"])
def test_synthesis_and_gradients_match_jax(name, te_kind):
    j_fn, t_fn, make = SYNTHS[name]
    maps = make(2, 4, 8, 1)
    te = _te(2, None if te_kind == "uniform" else 2)
    weights = np.random.default_rng(3).normal(
        size=(2, 6, 4, 8, 2)).astype(np.float32)

    def j_loss(m):
        return jnp.sum(j_fn(m, jnp.asarray(te)) * weights)

    ref = np.asarray(j_fn(jnp.asarray(maps), jnp.asarray(te)))
    j_grad = jax.grad(j_loss)(jnp.asarray(maps))
    leaf = _t(maps).requires_grad_()
    got = t_fn(leaf, _t(te))
    assert got.shape == ref.shape == (2, 6, 4, 8, 2)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    torch.sum(got * _t(weights)).backward()
    np.testing.assert_allclose(leaf.grad.numpy(), j_grad, rtol=1e-3,
                               atol=1e-5 * float(np.abs(j_grad).max()))


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("wdt", [8, 9, 10, 11])
def test_symmetry_halves_match_the_negative_step_slice(wdt):
    bp = np.random.default_rng(wdt).normal(size=(2, 3, wdt, 1)).astype(
        np.float32)
    left, right = tsingle.symmetry_halves(_t(bp))
    np.testing.assert_array_equal(left.numpy(),
                                  bp[:, :, wdt // 4:wdt // 2])
    np.testing.assert_array_equal(
        right.numpy(), bp[:, :, -(wdt // 4 + 1):-(wdt // 2 + 1):-1])


class _FixedJ:
    """A Flax-like stand-in whose `apply` returns its params: the JAX loss
    as a function of the nets' outputs."""

    def apply(self, variables, x):
        return variables["params"]


class _FixedT(torch.nn.Module):
    """A torch stand-in that returns its one parameter."""

    def __init__(self, out):
        super().__init__()
        self.out = torch.nn.Parameter(_t(out))

    def forward(self, x):
        return self.out


def _single_data(nb, h, w, seed=0):
    acqs, maps, te = (np.array(x) for x in j_synthetic(nb, h=h, w=w, ne=6,
                                                       seed=seed))
    return acqs, maps, te


LOSS_CASES = [("bipolar", "MSE", 16), ("bipolar", "MAE", 13),
              ("bipolar", "MSLE", 16), ("unipolar", "MSE", 13),
              ("unipolar", "MAE", 16), ("unipolar", "MSLE", 13)]


@pytest.mark.parametrize("grad_mode,main_loss,wdt", LOSS_CASES)
def test_loss_on_net_outputs_matches_jax(grad_mode, main_loss, wdt):
    """The loss with stand-in nets: every metric and the gradient of both
    outputs, at even and odd widths."""
    acqs, maps, te = _single_data(2, 12, wdt)
    cfg = dict(jsingle.DEFAULTS, grad_mode=grad_mode, main_loss=main_loss,
               FM_TV_weight=1e-3, FM_L1_weight=1e-2, BP_GR_weight=1e-2,
               BP_GR_sym_weight=0.5)
    rng = np.random.default_rng(7)
    n_pha = 4 if grad_mode == "bipolar" else 3
    out_mag = rng.uniform(0.0, 1.0, (2, 1, 12, wdt, 3)).astype(np.float32)
    out_pha = rng.normal(0.0, 0.2, (2, 1, 12, wdt, n_pha)).astype(np.float32)
    (j_val, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        lambda o: jsingle.make_loss_fn(cfg, _FixedJ(), _FixedJ())(
            o, *map(jnp.asarray, (acqs, maps, te))), has_aux=True))(
                (jnp.asarray(out_mag), jnp.asarray(out_pha)))
    g_mag, g_pha = _FixedT(out_mag), _FixedT(out_pha)
    loss, metrics = tsingle.make_loss_fn(cfg, g_mag, g_pha)(
        *map(_t, (acqs, maps, te)))
    loss.backward()
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(j_metrics[k]),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
    for net, j_g in zip((g_mag, g_pha), j_grads):
        np.testing.assert_allclose(net.out.grad.numpy(), j_g, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(j_g).max()))


@pytest.fixture(scope="module")
def single_case():
    acqs, maps, te = _single_data(2, 16, 16)
    cfg = dict(jsingle.DEFAULTS, n_G_filters=F_SMALL, BP_GR_weight=1e-3)
    g_mag, g_pha = jsingle.build_models(cfg)
    a1 = jnp.zeros((1, 6, 16, 16, 1))
    p_mag = flax_params(g_mag, a1, 51, noise=0.02)
    p_pha = flax_params(g_pha, a1, 52, noise=0.02)
    return cfg, (acqs, maps, te), (g_mag, g_pha), (p_mag, p_pha)


def test_step_matches_jax(single_case):
    cfg, data, (jg_mag, jg_pha), (p_mag, p_pha) = single_case
    (j_val, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        jsingle.make_loss_fn(cfg, jg_mag, jg_pha), has_aux=True))(
            (p_mag, p_pha), *map(jnp.asarray, data))
    g_mag, g_pha = tsingle.build_models(cfg)
    sd_mag, sd_pha = convert.single(p_mag, p_pha)
    g_mag.load_state_dict(sd_mag)
    g_pha.load_state_dict(sd_pha)
    loss, metrics = tsingle.make_loss_fn(cfg, g_mag, g_pha)(*map(_t, data))
    loss.backward()
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), float(j_metrics[k]),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
    grads = {f"{tag}.{n}": p.grad.numpy() for tag, net in
             (("mag", g_mag), ("pha", g_pha))
             for n, p in net.named_parameters()}
    ref = {f"{tag}.{n}": v for tag, sd in
           zip(("mag", "pha"), convert.single(*j_grads)) for n, v in
           sd.items()}
    assert set(grads) == set(ref)
    scale = max(float(np.abs(v.numpy()).max()) for v in ref.values())
    worst = max(float(np.abs(grads[k] - ref[k].numpy()).max())
                for k in grads) / scale
    assert worst <= 2e-2, worst
    no_grad = [k for k, v in grads.items() if "lstm" in k
               and not np.abs(v).max() > 0]
    assert not no_grad


def test_unported_settings_and_unknown_loss_raise():
    """bf16 and remat are ported (both nets in bfloat16 / rematerialized,
    their state-dict names unchanged); an unknown loss raises."""
    small = dict(tsingle.DEFAULTS, n_G_filters=4)
    plain = tsingle.build_models(small)
    for over, attr, want in ((dict(bf16=True), "dtype", torch.bfloat16),
                             (dict(remat=True), "remat", True)):
        nets = tsingle.build_models(dict(small, **over))
        for net, ref in zip(nets, plain):
            assert getattr(net, attr) == want
            assert set(net.state_dict()) == set(ref.state_dict())
    with pytest.raises(NameError, match="Main Loss"):
        tsingle.make_loss_fn(dict(tsingle.DEFAULTS, main_loss="Rice"),
                             None, None)


def test_loss_falls_over_5_steps():
    """JAX's TestSingleTrainer._run on 4 slices of one subject at 32 px,
    bipolar with BP_GR_weight 1e-6: the loss falls over 5 full-batch
    steps."""
    cfg = dict(tsingle.DEFAULTS, n_G_filters=F_SMALL, epochs=10,
               BP_GR_weight=1e-6)
    rng = np.random.default_rng(0)
    nb, h, w = 4, 32, 32
    mags = rng.uniform(0.1, 0.8, (nb, h, w, 2)).astype(np.float32)
    phas = rng.uniform(-0.1, 0.1, (nb, h, w, 2)).astype(np.float32)
    r2s = rng.uniform(0.0, 0.3, (nb, h, w)).astype(np.float32)
    phi = rng.uniform(-0.2, 0.2, (nb, h, w)).astype(np.float32)
    zeros = np.zeros_like(r2s)
    row0 = np.concatenate([mags, r2s[..., None], zeros[..., None]], -1)
    row1 = np.concatenate([phas, phi[..., None], zeros[..., None]], -1)
    te = physics.te_train(6, bs=nb)
    A = physics.synthesize_mag_phase(_t(np.stack([row0, row1], 1)), te)
    water = mags[..., 0] * np.exp(1j * phas[..., 0] * 4 * np.pi)
    fat = mags[..., 1] * np.exp(1j * phas[..., 1] * 4 * np.pi)
    B = np.stack([np.stack([water.real, water.imag], -1),
                  np.stack([fat.real, fat.imag], -1),
                  np.stack([phi, r2s], -1)], 1).astype(np.float32)
    g_mag, g_pha = tsingle.build_models(cfg)
    step, tx = tsingle.make_train_step(cfg, g_mag, g_pha)
    state = tsingle.init_state(cfg, g_mag, g_pha, tx,
                               torch.Generator().manual_seed(0), "cpu")
    losses = []
    for _ in range(5):
        state, m = step(state, (A, _t(B), te))
        losses.append(float(m["G_loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.step == 5 and state.opt.count == 5


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(tmp_path, *extra):
    return train_single.main(
        ["--device", "cpu", "--synthetic", "6", "--data_size", "16",
         "--data_idx", "1", "--n_G_filters", str(F_SMALL), "--output_base",
         str(tmp_path), *extra])


def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    out = _cli(tmp_path, "--epochs", "3", "--epoch_ckpt", "2")
    assert [e["epoch"] for e in out["epochs"]] == [2, 3]
    assert [e["steps"] for e in out["epochs"]] == [2, 1]
    ckdir = tmp_path / "WF-IDEAL" / "checkpoints"
    assert Checkpoint(ckdir).latest_step() == 3
    again = _cli(tmp_path, "--epochs", "4", "--epoch_ckpt", "2")
    assert [e["epoch"] for e in again["epochs"]] == [4]
    assert again["state"].opt.count == 4 and again["state"].step == 4
    text = capsys.readouterr().out
    assert "epoch 2/3 cycle=" in text and "epoch 4/4 cycle=" in text
    assert "resumed from epoch 3" in text
    # the run record: G_losses summaries (one every 50 epochs, none here)
    # in an event file beside the checkpoints
    assert list((tmp_path / "WF-IDEAL" / "summaries" / "train").glob(
        "events.out.tfevents.*"))
    with pytest.raises(SystemExit, match="data_idx"):
        _cli(tmp_path / "x", "--data_idx", "2")


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_single.main(["--synthetic", "3", "--data_size", "16",
                           "--data_idx", "0", "--output_base",
                           str(tmp_path)])
