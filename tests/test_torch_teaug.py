"""The TE-augmentation training slice of the port vs the JAX package: the
forward synthesis and its gradient, the randomized TE train, the TEEncoder,
AdaIN, VET-Net, the augmentations, the generator step's loss and
gradients, and the port's teaug CLI.

Inputs are made with numpy from a seed and handed to both packages (TE
trains as arrays, never the same RNG); model weights are Flax parameters
(every leaf perturbed) converted by `ideal_gan_tpu_torch.convert.vetnet`,
which also maps gradient trees, since its maps are linear. The JAX
package's Pallas kernels run in interpret mode on the CPU, as its own tests
run them. Tolerances:
- the synthesis rtol 1e-4 / atol 1e-5 (2e-4 / 2e-5 for the uniform-TE
  recurrence), its gradient rtol 1e-3 / atol 1e-5: the JAX package's own
  (tests/test_pallas_kernels.py:83, :98, :181);
- TEEncoder and AdaIN rtol / atol 1e-5 (float32, a few sums in another
  order); VET-Net's output rtol / atol 1e-4 as the UNets'
  (tests/test_torch_models.py) and its parameter gradients to 1e-3 of the
  global gradient scale (twenty layers of those sums in the backward, and
  AdaIN's √var of a 4- or 8-wide style vector amplifies them);
- the trainer's loss to 2e-5 relative and every gradient leaf to 2e-2 of
  the global gradient scale (MODEL_PARITY.json `tolerances`).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.models import VETNet as JVETNet  # noqa: E402
from ideal_gan_tpu.models import attention as jatt  # noqa: E402
from ideal_gan_tpu.models import blocks as jblocks  # noqa: E402
from ideal_gan_tpu.ops import pallas_ideal as jpi  # noqa: E402
from ideal_gan_tpu.train import teaug as jteaug  # noqa: E402
from ideal_gan_tpu_torch import convert, models, ops, physics  # noqa: E402
from ideal_gan_tpu_torch.cli import train_teaug  # noqa: E402
from ideal_gan_tpu_torch.data import bipolar_phase_row, random_fm_scale  # noqa: E402
from ideal_gan_tpu_torch.train import teaug as tteaug  # noqa: E402
from ideal_gan_tpu_torch.utils import Checkpoint  # noqa: E402

from test_torch_models import flax_params, nchw, nhwc  # noqa: E402

F_SMALL, LAYERS, SIZE, NE = 4, 2, 32, 6


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _te(kind, nb, ne=NE, seed=0):
    te = np.asarray(jph.te_train(ne, bs=nb), np.float32)
    if kind == "uniform":
        return te
    steps = 1.9e-3 + 1e-4 * np.random.default_rng(seed).normal(size=ne - 1)
    t = 1.2e-3 + np.concatenate([[0.0], np.cumsum(steps)])
    return np.tile(t.astype(np.float32), (nb, 1))[..., None]


def _maps(nb=2, h=4, w=128, seed=3, r2_lo=0.0):
    rng = np.random.default_rng(seed)
    maps = np.zeros((nb, 3, h, w, 2), np.float32)
    maps[:, :2] = rng.uniform(-0.5, 0.7, (nb, 2, h, w, 2))
    maps[:, 2, ..., 0] = rng.uniform(-0.3, 0.3, (nb, h, w))
    maps[:, 2, ..., 1] = rng.uniform(r2_lo, 0.5, (nb, h, w))
    return maps


# --------------------------------------------------------------------------
# the forward synthesis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("te_kind,r2_lo", [("uniform", 0.0),
                                           ("jittered", 0.0),
                                           ("jittered", -0.3)])
def test_synthesize_fused_matches_jax(te_kind, r2_lo):
    maps, te = _maps(r2_lo=r2_lo), _te(te_kind, 2)
    assert (maps[:, 2, ..., 1] < 0).any() == (r2_lo < 0)
    uniform = te_kind == "uniform"
    rtol, atol = (2e-4, 2e-5) if uniform else (1e-4, 1e-5)
    ref = np.asarray(jpi.synthesize_fused(jnp.asarray(maps), jnp.asarray(te),
                                          uniform_te=uniform))
    np.testing.assert_allclose(np.asarray(jph.synthesize(
        jnp.asarray(maps), jnp.asarray(te))), ref, rtol=rtol, atol=atol)
    got = ops.synthesize_fused(_t(maps), _t(te), uniform_te=uniform)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(
        got.numpy(), physics.synthesize(_t(maps), _t(te)).numpy())


@pytest.mark.parametrize("te_kind,r2_lo", [("uniform", 0.0),
                                           ("jittered", -0.3)])
def test_synthesize_fused_gradient_matches_jax(te_kind, r2_lo):
    maps, te = _maps(nb=1, h=8, r2_lo=r2_lo), _te(te_kind, 1)
    target = np.asarray(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))

    def j_loss(m):
        return jnp.mean(jnp.square(jpi.synthesize_fused(m, jnp.asarray(te))
                                   - target))

    ref = jax.grad(j_loss)(jnp.asarray(maps + 0.02))
    m = _t(maps + 0.02).requires_grad_()
    torch.mean(torch.square(ops.synthesize_fused(m, _t(te))
                            - _t(target))).backward()
    np.testing.assert_allclose(m.grad.numpy(), ref, rtol=1e-3, atol=1e-5)


# --------------------------------------------------------------------------
# TE trains
# --------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["1.5T", "3T", "bip_grad"])
def test_sample_te_ranges(preset):
    cfg = dict(tteaug.DEFAULTS, field=3.0 if preset == "3T" else 1.5,
               bip_grad=preset == "bip_grad")
    te1_min, te1_d, dte_min, dte_d = {
        "1.5T": (1.0e-3, 1.4e-3, 1.6e-3, 1.0e-3),
        "3T": (1.0e-3, 0.4e-3, 1.0e-3, 0.3e-3),
        "bip_grad": (1.0e-3, 1.4e-3, 0.9e-3, 0.3e-3)}[preset]
    gen = torch.Generator().manual_seed(5)
    trains = [tteaug.sample_te(gen, cfg, 3) for _ in range(400)]
    for te in trains[:3]:
        assert te.shape == (3, NE, 1) and te.dtype == torch.float32
        assert torch.equal(te[0], te[2])  # one train tiled over the batch
    t = torch.stack([te[0, :, 0] for te in trains]).double().numpy()
    d = np.diff(t, axis=1)
    jitter = d - d.mean(axis=1, keepdims=True)
    assert te1_min <= t[:, 0].min() and t[:, 0].max() <= te1_min + te1_d
    assert t[:, 0].max() - t[:, 0].min() > 0.9 * te1_d  # uniform spread
    # the common spacing within its range (the mean of 5 jittered steps)
    assert dte_min - 2e-4 < d.mean(axis=1).min()
    assert d.mean(axis=1).max() < dte_min + dte_d + 2e-4
    # per-echo jitter N(0, 1e-4²) around the common spacing
    assert 0.8e-4 < jitter.std() * np.sqrt(5 / 4) < 1.2e-4
    assert not jpi._te_is_uniform(trains[0].numpy())


# --------------------------------------------------------------------------
# TEEncoder, AdaIN, VET-Net
# --------------------------------------------------------------------------

def test_te_encoder_matches_flax():
    te = _te("jittered", 3)[..., 0] * np.array([[1.0], [30.0], [300.0]],
                                               np.float32)
    jm = jblocks.TEEncoder(8)
    p = flax_params(jm, jnp.asarray(te), 4, noise=0.3)
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(te)))
    assert (ref > 0).any() and (ref == 0).any()
    tm = models.TEEncoder(8)
    tm.load_state_dict(convert.te_encoder(p, ""))
    np.testing.assert_allclose(tm(_t(te)).detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tm(_t(te[..., None])).detach().numpy(), ref,
                               rtol=1e-5, atol=1e-5)


def test_adain_matches_jax():
    rng = np.random.default_rng(6)
    content = rng.normal(size=(2, 5, 7, 8)).astype(np.float32) * 2 + 0.5
    style = rng.uniform(0.0, 2.0, (2, 8)).astype(np.float32)

    def j_loss(c, s):
        return jnp.sum(jnp.square(jatt.adain(c, s)))

    ref = jatt.adain(jnp.asarray(content), jnp.asarray(style))
    jc, js = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(content),
                                              jnp.asarray(style))
    c = nchw(content).requires_grad_()
    s = _t(style).requires_grad_()
    out = models.adain(c, s)
    np.testing.assert_allclose(nhwc(out), ref, rtol=1e-5, atol=1e-5)
    out.square().sum().backward()
    np.testing.assert_allclose(nhwc(c.grad), jc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.grad.numpy(), js, rtol=1e-4, atol=1e-4)


def _random_params(module, seed, *args):
    """A Flax parameter tree of `module` with random values from numpy:
    He-normal kernels, N(1, 0.1²) norm scales, N(0, 0.1²) biases, γ = 0.7.
    Shapes by `jax.eval_shape` (Flax's own init compiles VET-Net for
    half a minute). Each TEEncoder's Dense bias is spread over [0, 1], so
    that every style vector has a variance far from 0, where AdaIN's √var
    is ill-conditioned."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return np.full(leaf.shape, 0.7, np.float32)
        if "scale" in name:
            return (1 + 0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        val = rng.normal(size=leaf.shape) * (
            0.1 if leaf.ndim == 1 else np.sqrt(2.0 / np.prod(leaf.shape[:-1])))
        if "Dense_0" in name and "bias" in name:
            val = val + np.linspace(0.0, 1.0, leaf.shape[0])
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


@pytest.fixture(scope="module")
def vetnet_case():
    """Synthetic maps and acquisitions, a jittered TE train, the Flax
    VET-Net (te_input) and its random parameters."""
    acqs, maps, _ = (np.array(a) for a in j_synthetic(2, h=SIZE, w=SIZE,
                                                       ne=NE))
    te = _te("jittered", 2, seed=7)
    jm = JVETNet(me_layer=True, te_input=True, filters=F_SMALL,
                 num_layers=LAYERS)
    p = _random_params(jm, 7, jnp.asarray(acqs[:1]),
                       jnp.asarray(te[:1, :, 0]))
    return acqs, maps, te, jm, p


def _grads(net):
    return {n: q.grad.numpy() for n, q in net.named_parameters()
            if q.requires_grad}


def _worst_grad(grads, j_grads):
    """max |Δg| over the leaves, over the global gradient scale. Every
    converted leaf has a gradient but the LSTMs' input bias, which Flax does
    not have (the port keeps it at 0)."""
    assert set(grads) == {k for k in j_grads if not k.endswith("bias_ih_l0")}
    scale = max(float(np.abs(np.asarray(j_grads[k])).max()) for k in grads)
    return max(float(np.abs(grads[k] - np.asarray(j_grads[k])).max())
               for k in grads) / scale


@pytest.mark.parametrize("te_input", [True, False])
def test_vetnet_matches_flax(vetnet_case, te_input):
    acqs, _, te, jm, p = vetnet_case
    te_vec = te[..., 0]
    if not te_input:
        jm = jm.clone(te_input=False)
        p = dict(p, _SharedEncoder_0={
            k: v for k, v in p["_SharedEncoder_0"].items()
            if not k.startswith("TEEncoder")})

    def j_loss(params):
        out = jm.apply({"params": params}, jnp.asarray(acqs),
                       jnp.asarray(te_vec))
        return jnp.mean(jnp.square(out - 0.3)), out

    (_, ref), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(p)
    tm = models.VETNet(2, te_input=te_input, filters=F_SMALL,
                       num_layers=LAYERS)
    tm.load_state_dict(convert.vetnet(p, LAYERS))
    out = tm(_t(acqs), _t(te_vec))
    assert out.shape == (2, 1, SIZE, SIZE, 2)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    torch.mean(torch.square(out - 0.3)).backward()
    assert _worst_grad(_grads(tm), convert.vetnet(j_grads, LAYERS)) <= 1e-3


def test_unported_settings_raise():
    """bf16, remat and microbatch are ported: VET-Net builds with the same
    state-dict names."""
    small = dict(tteaug.DEFAULTS, n_G_filters=4)
    keys = set(tteaug.build_model(small).state_dict())
    for over in (dict(microbatch=2), dict(bf16=True), dict(remat=True)):
        assert set(tteaug.build_model(dict(small, **over))
                   .state_dict()) == keys


# --------------------------------------------------------------------------
# augmentation
# --------------------------------------------------------------------------

def test_fm_scale_and_bipolar_row():
    """The JAX package's formulas (data/augment.py:35-58) on the draws the
    port's generator makes."""
    _, maps, _ = (np.array(a) for a in j_synthetic(2, h=16, w=16, ne=NE))
    m = _t(maps)
    scaled = random_fm_scale(torch.Generator().manual_seed(8), m, mean=1.1)
    z = float(torch.randn((), generator=torch.Generator().manual_seed(8)))
    want = maps.copy()
    want[:, 2, ..., 0] *= np.float32(1.1 + 0.25 * z)
    np.testing.assert_allclose(scaled.numpy(), want, rtol=1e-6)
    assert not np.array_equal(want, maps)

    row = bipolar_phase_row(torch.Generator().manual_seed(9), m)
    u = torch.rand(2, generator=torch.Generator().manual_seed(9)).numpy()
    x_lim, x_off = 0.1 + 0.4 * u[0], 0.01 * u[1]
    ramp = np.linspace(-1.0, 1.0, 16) * x_lim + x_off
    bp = np.where(maps[:, 2, ..., 0] != 0.0, ramp[None, None, :], 0.0)
    assert row.shape == (2, 4, 16, 16, 2) and torch.equal(row[:, :3], m)
    np.testing.assert_allclose(row[:, 3, ..., 0].numpy(), bp, rtol=1e-6,
                               atol=1e-7)
    assert not row[:, 3, ..., 1].any()


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["defaults", "sel_weight_tv"])
def test_generator_step_matches_jax(vetnet_case, variant):
    over = {"defaults": {},
            "sel_weight_tv": dict(sel_weight=True, sel_weight_pwr=2.0,
                                  R2_TV_weight=1e-3, FM_TV_weight=1e-3)}
    cfg = dict(jteaug.DEFAULTS, n_G_filters=F_SMALL, **over[variant])
    _, maps, te, jm, p = vetnet_case
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (2, NE, SIZE, SIZE, 2)))
    j_loss_fn = jteaug.make_loss_fn(cfg, jm)
    (j_val, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        j_loss_fn, has_aux=True))(p, None, jnp.asarray(maps),
                                  jnp.asarray(te), key)

    tm = models.VETNet(2, te_input=True, filters=F_SMALL, num_layers=LAYERS)
    tm.load_state_dict(convert.vetnet(p, LAYERS))
    loss, metrics = tteaug.make_loss_fn(cfg, tm)(_t(maps), _t(te),
                                                 _t(noise))
    loss.backward()
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(j_metrics[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    assert abs(float(loss.detach()) - float(j_val)) \
        / max(abs(float(j_val)), 1.0) <= 2e-5
    assert _worst_grad(_grads(tm), convert.vetnet(j_grads, LAYERS)) <= 2e-2


def test_generator_loss_decreases_on_cpu():
    _, maps, _ = (np.array(a) for a in j_synthetic(2, h=SIZE, w=SIZE,
                                                    ne=NE))
    cfg = dict(tteaug.DEFAULTS, n_G_filters=F_SMALL, epochs=2, lr=2e-3)
    model = tteaug.build_model(cfg)
    step, tx = tteaug.make_train_step(cfg, model)
    state = tteaug.init_state(cfg, model, tx,
                              torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    te = tteaug.sample_te(gen, cfg, 2)
    losses = []
    for _ in range(6):
        noise_gen = torch.Generator().manual_seed(2)  # the same noise
        state, m = step(state, (_t(maps), te), noise_gen)
        losses.append(float(m["G_loss"]))
        assert np.isfinite(float(m["WF_loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.step == state.opt.count == 6
    assert all(q.grad is not None and bool(q.grad.abs().max() > 0)
               for n, q in model.named_parameters()
               if q.requires_grad and ("lstm" in n or ".te." in n))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(tmp_path, *extra):
    return train_teaug.main(
        ["--device", "cpu", "--synthetic", "4", "--data_size", "32",
         "--batch_size", "2", "--n_G_filters", str(F_SMALL), "--output_base",
         str(tmp_path), *extra])


def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    out = _cli(tmp_path, "--epochs", "1", "--data_aug_p", "1.0", "--FM_aug",
               "true", "--bip_grad", "true")
    ckdir = tmp_path / "TEaug-300" / "checkpoints"
    assert Checkpoint(ckdir).latest_step() == 1
    assert [e["epoch"] for e in out["epochs"]] == [1]
    assert out["state"].step == 2  # 4 slices at batch 2
    saved = Checkpoint(ckdir).restore(1)
    again = _cli(tmp_path, "--epochs", "2")
    assert [e["epoch"] for e in again["epochs"]] == [2]
    assert again["state"].opt.count == saved["opt"]["count"] + 2
    assert Checkpoint(ckdir).latest_step() == 2
    text = capsys.readouterr().out
    assert "resumed from epoch 1" in text
    assert "epoch 2/2 PM_loss=" in text
    with pytest.raises(SystemExit, match="batch_size"):
        _cli(tmp_path / "x", "--epochs", "1", "--batch_size", "8")


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_teaug.main(["--synthetic", "4", "--data_size", "32",
                          "--batch_size", "2", "--n_G_filters", "4",
                          "--output_base", str(tmp_path)])
    model = tteaug.build_model(dict(tteaug.DEFAULTS, n_G_filters=4))
    _, tx = tteaug.make_train_step(tteaug.DEFAULTS, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        tteaug.init_state(tteaug.DEFAULTS, model, tx, torch.Generator())


def test_cli_rejects_unported_settings(tmp_path):
    """bf16, remat and microbatch are ported; a microbatch that does not
    divide the batch is rejected, as in the JAX package."""
    with pytest.raises(ValueError, match="divisible"):
        _cli(tmp_path, "--epochs", "1", "--microbatch", "3")
