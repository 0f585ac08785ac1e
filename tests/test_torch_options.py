"""The trainers' bf16, remat and microbatch options in the port.

- bf16 in the magnitude, single-subject and supervised trainers (the
  JAX package's own bf16 tests: `tests/test_train_sup.py::TestBF16`,
  `test_train_mag_single.py`'s `test_bf16_compute`): the losses of a few
  steps on the CPU are finite and fall, and the first step's loss lies
  within 5e-2 (relative) of the float32 step's from the same weights: a
  bf16 net's output carries about u = 2^-8 of relative rounding per layer,
  over the ~10 layers of a 2-level net and its physics-free loss.
- remat on and off: the same module tree and state-dict names, and
  bit-identical loss and gradients on the CPU (the recomputed forward is
  the same arithmetic); a JAX `remat=True` parameter tree loads through
  `ideal_gan_tpu_torch.convert`.
- microbatch: the microbatched supervised and VET-Net steps equal the
  full-batch step on the same noise (the chunks take its rows in order)
  to 1e-4 of the loss and 1e-3 of the gradient scale (sums in another
  order through ~20 layers; the JAX package's own check,
  `test_train_sup.py::TestMicrobatch`, sees ~1e-4), and equal JAX's
  microbatched step, given the noise JAX draws from each chunk's key, to
  2e-5 of the loss and 1e-3 (sup) / 2e-2 (VET-Net, its TEEncoders and
  AdaIN; tests/test_torch_teaug.py) of the gradient scale. A batch that
  the microbatch does not divide raises ValueError, as in the JAX
  package.

2-level nets of F=4 at 32²; inputs made with numpy from a seed; torch on one
thread.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.data import layouts as jlayouts  # noqa: E402
from ideal_gan_tpu.train import common as jcommon  # noqa: E402
from ideal_gan_tpu.train import sup as jsup  # noqa: E402
from ideal_gan_tpu.train import teaug as jteaug  # noqa: E402
from ideal_gan_tpu.train import unsup as junsup  # noqa: E402
from ideal_gan_tpu_torch import convert, models  # noqa: E402
from ideal_gan_tpu_torch.cli.common import synthetic_dataset  # noqa: E402
from ideal_gan_tpu_torch.train import common as tcommon  # noqa: E402
from ideal_gan_tpu_torch.train import mag as tmag  # noqa: E402
from ideal_gan_tpu_torch.train import single as tsingle  # noqa: E402
from ideal_gan_tpu_torch.train import sup as tsup  # noqa: E402
from ideal_gan_tpu_torch.train import teaug as tteaug  # noqa: E402
from ideal_gan_tpu_torch.train import unsup as tunsup  # noqa: E402

from test_torch_teaug import _random_params, _te  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

F_SMALL, LAYERS, SIZE, NE = 4, 2, 32, 6


@pytest.fixture
def two_level(monkeypatch):
    """The trainers' `build_model(s)` choosing among 2-level nets."""
    for mod in (tmag, tsingle, tsup, tteaug, tunsup):
        for name in ("UNet", "VETNet", "MDWFNet"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, functools.partial(
                    getattr(models, name), num_layers=LAYERS))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cohort(n=2, seed=0):
    return tuple(_t(a) for a in synthetic_dataset(n, h=SIZE, w=SIZE, ne=NE,
                                                  seed=seed))


# --------------------------------------------------------------------------
# bf16 in mag, single and sup
# --------------------------------------------------------------------------

def _mag(cfg):
    _, maps, te = _cohort()
    model = tmag.build_model(cfg)
    step, tx = tmag.make_train_step(cfg, model)
    state = tmag.init_state(cfg, model, tx, torch.Generator().manual_seed(0),
                            "cpu")
    first = float(tmag.make_loss_fn(cfg, model)(maps, te)[0].detach())
    return first, lambda: step(state, (maps, te))[1]


def _single(cfg):
    acqs, maps, te = _cohort(3)
    nets = tsingle.build_models(cfg)
    step, tx = tsingle.make_train_step(cfg, *nets)
    state = tsingle.init_state(cfg, *nets, tx,
                               torch.Generator().manual_seed(0), "cpu")
    first = float(tsingle.make_loss_fn(cfg, *nets)(acqs, maps, te)[0]
                  .detach())
    return first, lambda: step(state, (acqs, maps, te))[1]


def _sup(cfg):
    batch = _cohort()
    model = tsup.build_model(cfg)
    step, tx = tsup.make_train_step(cfg, model)
    state = tsup.init_state(cfg, model, tx, torch.Generator().manual_seed(0),
                            "cpu")
    first = float(tsup.make_loss_fn(cfg, model)(*batch)[0].detach())
    return first, lambda: step(state, batch,
                               torch.Generator().manual_seed(1))[1]


BF16_CASES = {
    # the JAX package's bf16 tests: supervised Rician mag, bipolar single,
    # sup out_vars WF (a U-Net here, the multi-decod's 2-decoder net in the
    # JAX test: both run every bf16 block)
    "mag-rice": (_mag, dict(tmag.DEFAULTS, main_loss="Rice", lr=2e-3), 4,
                 "G_loss"),
    "single-bipolar": (_single, dict(tsingle.DEFAULTS, lr=2e-3), 4,
                       "G_loss"),
    "sup-WF": (_sup, dict(tsup.DEFAULTS, out_vars="WF", G_model="U-Net",
                          lr=2e-3), 6, "G_loss"),
}


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_steps_finite_falling_and_near_f32(two_level, case):
    run, cfg, n, key = BF16_CASES[case]
    cfg = dict(cfg, n_G_filters=F_SMALL, epochs=n)
    f32_first, _ = run(cfg)
    first, step = run(dict(cfg, bf16=True))
    assert abs(first - f32_first) <= 5e-2 * abs(f32_first), (first, f32_first)
    losses = [float(step()[key]) for _ in range(n)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

def _remat_nets(remat):
    """VET-Net (ConvLSTM front, TE-AdaIN encoder, two decoders), AI-DEAL's
    FM U-Net (front, self-attention) and MDWF-Net (dense_l1 TE input),
    2 levels, seeded weights."""
    kw = dict(filters=F_SMALL, num_layers=LAYERS, remat=remat)
    nets = (models.VETNet(2, te_input=True, **kw),
            models.UNet(2, self_attention=True, **kw),
            models.MDWFNet(2 * NE, te_input=True, n_echoes=NE, **kw))
    for i, net in enumerate(nets):
        net.init_params(torch.Generator().manual_seed(i))
    return nets


def _remat_losses(nets):
    acqs, _, te = _cohort()
    te_vec = te[..., 0]
    outs = (nets[0](acqs, te_vec), nets[1](acqs),
            nets[2](acqs.permute(0, 2, 3, 1, 4).reshape(2, SIZE, SIZE, -1),
                    te_vec))
    res = []
    for net, out in zip(nets, outs):
        loss = torch.mean(torch.square(out - 0.3))
        loss.backward()
        res.append((float(loss.detach()),
                    {n: p.grad.clone() for n, p in net.named_parameters()
                     if p.grad is not None}))
    return res


def test_remat_is_bit_identical_and_keeps_the_parameter_names():
    plain, remat = _remat_nets(False), _remat_nets(True)
    for a, b in zip(plain, remat):
        assert list(a.state_dict()) == list(b.state_dict())
    for (l0, g0), (l1, g1) in zip(_remat_losses(plain),
                                  _remat_losses(remat)):
        assert l0 == l1
        assert set(g0) == set(g1) and len(g0) > 20
        assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_jax_remat_parameter_tree_loads_through_convert():
    acqs, _, te = (np.array(a) for a in j_synthetic(1, h=SIZE, w=SIZE,
                                                     ne=NE))
    cfg = dict(jteaug.DEFAULTS, n_G_filters=F_SMALL, remat=True)
    jm = jteaug.build_model(cfg).clone(num_layers=LAYERS)
    p = _random_params(jm, 3, jnp.asarray(acqs), jnp.asarray(te[:, :, 0]))
    tm = models.VETNet(2, te_input=True, filters=F_SMALL, num_layers=LAYERS,
                       remat=True)
    tm.load_state_dict(convert.vetnet(p, LAYERS))
    g_fm, _ = junsup.build_models(dict(junsup.DEFAULTS, n_G_filters=F_SMALL,
                                       remat=True))
    p = _random_params(g_fm.clone(num_layers=LAYERS), 4, jnp.asarray(acqs))
    tu = models.UNet(2, filters=F_SMALL, num_layers=LAYERS,
                     self_attention=True, remat=True)
    tu.load_state_dict(convert.unet(p, LAYERS))


# --------------------------------------------------------------------------
# microbatch
# --------------------------------------------------------------------------

def _grads(net):
    return {n: q.grad.clone().numpy() for n, q in net.named_parameters()
            if q.grad is not None}


def _gap(run, ref):
    """(relative loss difference, max |Δg| over the gradient scale)."""
    scale = max(float(np.abs(v).max()) for v in ref[1].values())
    assert set(run[1]) <= set(ref[1])
    return (abs(run[0] - ref[0]) / abs(ref[0]),
            max(float(np.abs(run[1][k] - ref[1][k]).max())
                for k in run[1]) / scale)


def _port_steps(make_grad_fn, cfg, net, args, micro):
    out = {}
    for m in (0, micro):
        net.zero_grad()
        loss, _ = make_grad_fn(dict(cfg, microbatch=m), net)(*args)
        out[m] = (float(loss.detach()), _grads(net))
    return out[0], out[micro]


def _jax_micro(loss_fn, params, batch, key, micro, to_sd):
    (val, _), grads = jax.jit(lambda p: jcommon.accumulate_microbatch_grads(
        lambda q, chunk, k: jax.value_and_grad(loss_fn, has_aux=True)(
            q, *chunk, k), p, batch, key, micro))(params)
    return float(val), {k: np.asarray(v, np.float32)
                        for k, v in to_sd(grads).items()
                        if not k.endswith("bias_ih_l0")}


def test_sup_microbatch_matches_full_batch_and_jax(two_level):
    acqs, maps, te = (np.array(a) for a in j_synthetic(4, h=SIZE, w=SIZE,
                                                       ne=NE))
    cfg = dict(jsup.DEFAULTS, n_G_filters=F_SMALL, G_model="U-Net",
               out_vars="WF-PM", sigma_noise=0.05, R2_TV_weight=1e-3,
               FM_TV_weight=1e-3, R2_L1_weight=1e-2, FM_L1_weight=1e-2)
    micro = 2
    jm = jsup.build_model(cfg).clone(num_layers=LAYERS)
    p = _random_params(jm, 21, jlayouts.acqs_from_mebcrn(
        jnp.asarray(acqs[:1])))
    key = jax.random.PRNGKey(5)
    batch = tuple(jnp.asarray(a) for a in (acqs, maps, te))
    j_run = _jax_micro(jsup.make_loss_fn(cfg, jm, tv_scale=2.0), p, batch,
                       key, micro, lambda g: convert.unet(g, LAYERS))
    # the noise JAX draws from each chunk's key, in the legacy layout
    noise = np.concatenate([np.asarray(jax.random.normal(
        k, (micro, SIZE, SIZE, 2 * NE))) for k in jax.random.split(key, 2)])
    tm = tsup.build_model(cfg)
    tm.load_state_dict(convert.unet(p, LAYERS))
    full, mb = _port_steps(tsup.make_grad_fn, cfg, tm,
                           (_t(acqs), _t(maps), _t(te), _t(noise)), micro)
    loss_gap, grad_gap = _gap(mb, full)
    assert loss_gap <= 1e-4 and grad_gap <= 1e-3, (loss_gap, grad_gap)
    loss_gap, grad_gap = _gap(mb, j_run)
    assert loss_gap <= 2e-5 and grad_gap <= 1e-3, (loss_gap, grad_gap)
    with pytest.raises(ValueError, match="divisible"):
        tsup.make_grad_fn(dict(cfg, microbatch=3), tm)(
            _t(acqs), _t(maps), _t(te), _t(noise))


def test_teaug_microbatch_matches_full_batch_and_jax():
    _, maps, _ = (np.array(a) for a in j_synthetic(4, h=SIZE, w=SIZE, ne=NE))
    te = _te("jittered", 4, seed=7)
    cfg = dict(jteaug.DEFAULTS, n_G_filters=F_SMALL, R2_TV_weight=1e-3,
               FM_TV_weight=1e-3)
    micro = 2
    jm = jteaug.build_model(cfg).clone(num_layers=LAYERS)
    p = _random_params(jm, 7, jnp.asarray(maps[:1, :1]),
                       jnp.asarray(te[:1, :, 0]))
    key = jax.random.PRNGKey(3)
    j_loss = jteaug.make_loss_fn(cfg, jm, tv_scale=2.0)
    j_run = _jax_micro(lambda q, B, t, k: j_loss(q, None, B, t, k), p,
                       (jnp.asarray(maps), jnp.asarray(te)), key, micro,
                       lambda g: convert.vetnet(g, LAYERS))
    noise = np.concatenate([np.asarray(jax.random.normal(
        k, (micro, NE, SIZE, SIZE, 2))) for k in jax.random.split(key, 2)])
    tm = models.VETNet(2, te_input=True, filters=F_SMALL, num_layers=LAYERS)
    tm.load_state_dict(convert.vetnet(p, LAYERS))
    full, mb = _port_steps(tteaug.make_grad_fn, cfg, tm,
                           (_t(maps), _t(te), _t(noise)), micro)
    loss_gap, grad_gap = _gap(mb, full)
    assert loss_gap <= 1e-4 and grad_gap <= 1e-3, (loss_gap, grad_gap)
    loss_gap, grad_gap = _gap(mb, j_run)
    assert loss_gap <= 2e-5 and grad_gap <= 2e-2, (loss_gap, grad_gap)
    with pytest.raises(ValueError, match="divisible"):
        tteaug.make_grad_fn(dict(cfg, microbatch=3), tm)(
            _t(maps), _t(te), _t(noise))


def test_accumulate_microbatch_grads_averages_in_float32():
    """Chunks in order, each loss backpropagated, the float32 gradients
    and the loss and metrics scaled by 1/n_chunks; None batch entries pass
    through."""
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    x = torch.arange(8.0).reshape(4, 2)
    seen = []

    def loss_fn(xc, none):
        seen.append((xc.clone(), none))
        loss = torch.sum(xc * w)
        return loss, {"m": loss * 2}

    loss, metrics = tcommon.accumulate_microbatch_grads(
        loss_fn, [w], (x, None), 2)
    assert [s[0].tolist() for s in seen] == [[[0, 1], [2, 3]],
                                             [[4, 5], [6, 7]]]
    assert all(s[1] is None for s in seen)
    assert float(loss) == float(torch.sum(x * w.detach())) / 2
    assert float(metrics["m"]) == 2 * float(loss)
    assert w.grad.dtype == torch.float32
    assert w.grad.tolist() == (x.sum(0) / 2).tolist()
    with pytest.raises(ValueError, match="divisible"):
        tcommon.accumulate_microbatch_grads(loss_fn, [w], (x,), 3)
