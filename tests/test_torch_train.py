"""The AI-DEAL training slice of the port vs the JAX package: the cycle
operators and their gradients, the ConvLSTM backward, the two faults found
in the port, the losses, the optimizer, the trainer's loss and gradients,
and the port's training CLI.

Inputs are made with numpy from a seed and handed to both packages; model
weights are Flax parameters (every leaf perturbed) converted by
`ideal_gan_tpu_torch.convert.unet`, which also maps gradient trees, since
its maps are linear (transposes, the spatial flip of ConvTranspose). The
JAX package's Pallas kernels run in interpret mode on the CPU, as its own
tests run them. Tolerances, each the JAX package's own:
- the cycle's values rtol 1e-4 / atol 1e-5 (2e-4 / 2e-5 for the uniform-TE
  recurrence) and gradients rtol 1e-3 / atol 1e-5
  (tests/test_pallas_kernels.py:101-173);
- the ConvLSTM backward rtol 1e-4 / atol 2e-5
  (tests/test_pallas_kernels.py:473-476);
- the trainer's loss to 2e-5 relative and every gradient leaf to 2e-2 of
  the global gradient scale (MODEL_PARITY.json `tolerances`);
- the optimizer's parameters to 1e-6 against optax.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.losses import regs as jregs  # noqa: E402
from ideal_gan_tpu.models import convlstm as jlstm  # noqa: E402
from ideal_gan_tpu.ops import pallas_convlstm as pc  # noqa: E402
from ideal_gan_tpu.ops import pallas_ideal as jpi  # noqa: E402
from ideal_gan_tpu.train import common as jcommon  # noqa: E402
from ideal_gan_tpu.train import unsup as junsup  # noqa: E402
from ideal_gan_tpu_torch import convert, losses, models, ops, physics  # noqa: E402
from ideal_gan_tpu_torch.cli import train_unsup  # noqa: E402
from ideal_gan_tpu_torch.data import random_echo_count, random_geometric  # noqa: E402
from ideal_gan_tpu_torch.train import common as tcommon  # noqa: E402
from ideal_gan_tpu_torch.train import unsup as tunsup  # noqa: E402
from ideal_gan_tpu_torch.utils import Checkpoint  # noqa: E402

from test_torch_models import flax_params  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --------------------------------------------------------------------------
# the cycle
# --------------------------------------------------------------------------

def _cycle_inputs(te_kind, nb=2, h=4, w=128, ne=6, seed=3):
    rng = np.random.default_rng(seed)
    maps = np.zeros((nb, 3, h, w, 2), np.float32)
    maps[:, :2] = rng.uniform(-0.5, 0.7, (nb, 2, h, w, 2))
    maps[:, 2, ..., 0] = rng.uniform(-0.3, 0.3, (nb, h, w))
    maps[:, 2, ..., 1] = rng.uniform(0.0, 0.5, (nb, h, w))
    te = np.asarray(jph.te_train(ne, bs=nb), np.float32)
    if te_kind == "jittered":
        te = te + rng.uniform(-2e-4, 2e-4, te.shape).astype(np.float32)
    acqs = np.asarray(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))
    pm = maps[:, 2:3] + 0.03 * rng.normal(size=maps[:, 2:3].shape)
    return acqs, pm.astype(np.float32), te


def _cycle_loss_np(rho, recon, acqs):
    return jnp.mean(jnp.square(recon - acqs)) + jnp.mean(rho)


@pytest.mark.parametrize("te_kind", ["uniform", "jittered"])
def test_cycle_values_match_jax(te_kind):
    acqs, pm, te = _cycle_inputs(te_kind)
    ref_rho, ref_recon = jph.cycle_full(jnp.asarray(acqs), jnp.asarray(pm),
                                        jnp.asarray(te))
    a, p, t = _t(acqs), _t(pm), _t(te)
    rho, recon = physics.cycle_full(a, p, t)
    np.testing.assert_allclose(rho.numpy(), ref_rho, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(recon.numpy(), ref_recon, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(physics.cycle(a, p, t).numpy(), ref_recon,
                               rtol=1e-4, atol=1e-5)
    # the fused entry points against the JAX package's Pallas kernel
    uniform = te_kind == "uniform"
    rtol, atol = (2e-4, 2e-5) if uniform else (1e-4, 1e-5)
    j_rho, j_recon = jpi.cycle_full_fused(
        jnp.asarray(acqs), jnp.asarray(pm), jnp.asarray(te),
        uniform_te=uniform)
    f_rho, f_recon = ops.cycle_full_fused(a, p, t, uniform_te=uniform)
    np.testing.assert_allclose(f_rho.numpy(), j_rho, rtol=rtol, atol=atol)
    np.testing.assert_allclose(f_recon.numpy(), j_recon, rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(ops.cycle_fused(a, p, t).numpy(), j_recon,
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("te_kind", ["uniform", "jittered"])
def test_cycle_gradients_match_jax(te_kind):
    acqs, pm, te = _cycle_inputs(te_kind, nb=1)

    def j_loss(a, p):
        rho, recon = jpi.cycle_full_fused(a, p, jnp.asarray(te))
        return _cycle_loss_np(rho, recon, jnp.asarray(acqs))

    ja, jp = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(acqs),
                                              jnp.asarray(pm))
    a = _t(acqs).requires_grad_()
    p = _t(pm).requires_grad_()
    rho, recon = ops.cycle_full_fused(a, p, _t(te))
    (torch.mean((recon - _t(acqs)) ** 2) + rho.mean()).backward()
    np.testing.assert_allclose(a.grad.numpy(), ja, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), jp, rtol=1e-3, atol=1e-5)


def test_cycle_r2_only_branch_matches_jax():
    acqs, pm, te = _cycle_inputs("uniform", nb=1)
    r2 = pm[..., 1:]

    def j_loss(p):
        rho, recon = jph.cycle_full(jnp.asarray(acqs), p, jnp.asarray(te))
        return _cycle_loss_np(rho, recon, jnp.asarray(acqs))

    jp = jax.grad(j_loss)(jnp.asarray(r2))
    ref = jph.cycle(jnp.asarray(acqs), jnp.asarray(r2), jnp.asarray(te))
    p = _t(r2).requires_grad_()
    rho, recon = physics.cycle_full(_t(acqs), p, _t(te))
    np.testing.assert_allclose(recon.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    (torch.mean((recon - _t(acqs)) ** 2) + rho.mean()).backward()
    np.testing.assert_allclose(p.grad.numpy(), jp, rtol=1e-3, atol=1e-5)


def test_physics_backward_skips_data_gradient():
    acqs, pm, te = _cycle_inputs("uniform", nb=1)
    a, p = _t(acqs), _t(pm).requires_grad_()
    rho, recon = ops.cycle_full_fused(a, p, _t(te))
    recon.sum().backward()
    assert a.grad is None and p.grad is not None


# --------------------------------------------------------------------------
# fault 1: gradients through the fit and the ConvLSTM
# --------------------------------------------------------------------------

def test_fit_rho_fused_gradients_match_jax():
    acqs, pm, te = _cycle_inputs("uniform", nb=1)

    def j_loss(p):
        return jnp.sum(jnp.square(jpi.fit_rho_fused(
            jnp.asarray(acqs), p, jnp.asarray(te))))

    jp = jax.grad(j_loss)(jnp.asarray(pm))
    p = _t(pm).requires_grad_()
    ops.fit_rho_fused(_t(acqs), p, _t(te)).square().sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), jp, rtol=1e-3, atol=1e-4)


def _lstm_inputs(nb, ne, h, w, cin, f, seed, zero_region=False):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(nb, ne, h, w, cin)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin + f, 4 * f)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(4 * f,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(nb, h, w, f)).astype(np.float32)
    if zero_region:  # the synthetic cohort's background, zero input bias
        x[:, :, :, : w // 2] = 0.0
        b[:] = 0.0
    return x, k, b, g


@pytest.mark.parametrize("nb,ne,h,w,cin,f,zero_region", [
    (2, 3, 16, 16, 2, 8, False), (1, 6, 12, 20, 2, 6, False),
    (2, 4, 16, 16, 1, 8, True), (1, 6, 9, 13, 2, 8, True)])
def test_convlstm_backward_matches_jax(nb, ne, h, w, cin, f, zero_region):
    x, k, b, g = _lstm_inputs(nb, ne, h, w, cin, f, seed=ne + f,
                              zero_region=zero_region)

    def j_loss(x_, k_, b_):
        out, _ = pc._jnp_reference(x_, k_, b_, "leaky_relu", "sigmoid")
        return jnp.sum(out * jnp.asarray(g))

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, k, b)))
    got = ops.convlstm_backward_reference(_t(x), _t(k), _t(b), _t(g))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=2e-5)
    xt, kt, bt = (_t(a).requires_grad_() for a in (x, k, b))
    (ops.convlstm_fused(xt, kt, bt) * _t(g)).sum().backward()
    for a, r in zip((xt.grad, kt.grad, bt.grad), ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=2e-5)


def test_convlstm_module_gradients_match_jax():
    """Fault 1 (ConvLSTM weights left without a gradient on the card) is
    repaired by routing the module through `convlstm_fused`; on the CPU its
    gradients equal jax.grad of the Flax module's, on the input with zero
    regions and zero bias of fault 2."""
    x, _, _, _ = _lstm_inputs(2, 4, 16, 16, 2, 8, seed=9, zero_region=True)
    jm = jlstm.ConvLSTM(filters=8)
    p = flax_params(jm, jnp.asarray(x), 9)
    p["input_conv"]["bias"] = np.zeros_like(p["input_conv"]["bias"])

    def j_loss(params):
        return jnp.mean(jnp.square(jm.apply({"params": params}, x)))

    jg = convert.convlstm(jax.grad(j_loss)(p), "")
    tm = models.ConvLSTM(2, 8)
    tm.load_state_dict(convert.convlstm(p, ""))
    tm(_t(x)).square().mean().backward()
    for name, param in tm.named_parameters():
        assert param.grad is not None, name
        np.testing.assert_allclose(param.grad.numpy(), jg[name].numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=name)


# --------------------------------------------------------------------------
# fault 2: leaky_relu's derivative at 0
# --------------------------------------------------------------------------

def test_leaky_relu_gradient_at_zero_is_one():
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    y = models.get_activation("leaky_relu")(x)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), [-0.2, 0.0, 2.0])
    jg = jax.grad(lambda v: jnp.sum(
        jax.nn.leaky_relu(v, negative_slope=0.2)))(jnp.asarray([-1.0, 0.0,
                                                                2.0]))
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0, atol=0)
    assert x.grad.tolist() == pytest.approx([0.2, 1.0, 1.0])


# --------------------------------------------------------------------------
# losses, augmentation, batches, checkpoints
# --------------------------------------------------------------------------

def test_regularizers_match_jax():
    rng = np.random.default_rng(4)
    img = rng.normal(size=(3, 9, 11, 2)).astype(np.float32)
    rows = rng.normal(size=(3, 1, 9, 11, 1)).astype(np.float32)
    np.testing.assert_allclose(losses.total_variation_2d(_t(img)).numpy(),
                               jregs.total_variation_2d(jnp.asarray(img)),
                               rtol=1e-5)
    for a in (img, rows):
        np.testing.assert_allclose(float(losses.total_variation(_t(a))),
                                   float(jregs.total_variation(a)),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(losses.l1_mean(_t(a))),
                                   float(jregs.l1_mean(a)), rtol=1e-5)


def test_random_geometric_is_a_dihedral_map():
    x = torch.arange(2 * 3 * 4 * 4 * 2, dtype=torch.float32).reshape(
        2, 3, 4, 4, 2)
    variants = []
    for k in range(3):
        r = torch.rot90(x, k, dims=(2, 3))
        for lr in (False, True):
            for ud in (False, True):
                v = torch.flip(r, (3,)) if lr else r
                variants.append(torch.flip(v, (2,)) if ud else v)
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(40):
        y = random_geometric(gen, x)
        assert y.is_contiguous() and y.shape == x.shape
        seen.add(next(i for i, v in enumerate(variants) if torch.equal(y, v)))
    assert len(seen) > 4


def test_echo_count_and_batches_match_jax():
    from ideal_gan_tpu.data import augment as jaug
    counts = [random_echo_count(np.random.default_rng(s)) for s in range(20)]
    assert counts == [jaug.random_echo_count(np.random.default_rng(s))
                      for s in range(20)]
    arrays = (np.arange(10), np.arange(10) * 2)
    got = list(tcommon.batch_iterator(arrays, 3, np.random.default_rng(1)))
    ref = list(jcommon.batch_iterator(arrays, 3, np.random.default_rng(1)))
    assert len(got) == len(ref) == 3
    for a, r in zip(got, ref):
        for x, y in zip(a, r):
            np.testing.assert_array_equal(x, y)


def test_checkpoint_keeps_the_newest(tmp_path):
    ckpt = Checkpoint(tmp_path / "c", max_to_keep=2)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    for step in (1, 2, 3):
        ckpt.save(step, {"w": torch.full((2,), float(step)), "step": step})
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    assert ckpt.restore()["step"] == 3
    assert torch.equal(ckpt.restore(2)["w"], torch.full((2,), 2.0))


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("total,decay,clip", [(6, 2, 1.0), (6, 6, None),
                                              (8, 3, 0.5)])
def test_adam_and_schedule_match_optax(total, decay, clip):
    rng = np.random.default_rng(total + decay)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32)
              for s in shapes] for scale in (0.1, 2.0, 0.3, 5.0, 0.05,
                                             1.0, 0.2, 3.0)[:total]]
    j_sched = jcommon.linear_decay_schedule(2e-3, total, decay)
    t_sched = tcommon.linear_decay_schedule(2e-3, total, decay)
    for step in range(total + 1):
        np.testing.assert_allclose(t_sched(step), float(j_sched(step)),
                                   rtol=1e-6)
    tx = jcommon.make_adam(j_sched, 0.9, 0.9999, clip_norm=clip)
    j_params = [jnp.asarray(p) for p in params]
    j_state = tx.init(j_params)
    t_params = [torch.nn.Parameter(_t(p)) for p in params]
    opt = tcommon.make_adam(t_sched, 0.9, 0.9999, clip_norm=clip)(t_params)
    for g in grads:
        upd, j_state = tx.update([jnp.asarray(x) for x in g], j_state,
                                 j_params)
        j_params = optax.apply_updates(j_params, upd)
        for p, x in zip(t_params, g):
            p.grad = _t(x)
        opt.step()
        for p, r in zip(t_params, j_params):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=1e-6,
                                       atol=1e-6)


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

F_SMALL = 4


@pytest.fixture(scope="module")
def trainer_case():
    acqs, _, te = (np.array(a) for a in j_synthetic(2, h=32, w=32, ne=6))
    cfg = dict(junsup.DEFAULTS, n_G_filters=F_SMALL)
    g_fm, g_r2 = junsup.build_models(cfg)
    a = jnp.asarray(acqs)
    a_abs = jnp.sqrt(jnp.sum(jnp.square(a), axis=-1, keepdims=True))
    p_fm = flax_params(g_fm, a[:1], 21, noise=0.02)
    p_r2 = flax_params(g_r2, a_abs[:1], 22, noise=0.02)
    return acqs, te, p_fm, p_r2


def _torch_nets(cfg, p_fm, p_r2):
    g_fm, g_r2 = tunsup.build_models(cfg)
    g_fm.load_state_dict(convert.unet(p_fm))
    g_r2.load_state_dict(convert.unet(p_r2))
    return g_fm, g_r2


def _compare(loss, grads, j_loss, j_grads):
    """MODEL_PARITY.json's metrics: loss rel-diff and the worst leaf's max
    |Δg| over the global gradient scale."""
    loss = float(loss.detach())
    rel = abs(loss - float(j_loss)) / max(abs(float(j_loss)), 1.0)
    assert rel <= 2e-5, rel
    assert set(grads) == set(j_grads)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in j_grads.values())
    worst = max(float(np.abs(grads[k] - np.asarray(j_grads[k])).max())
                for k in grads) / scale
    assert worst <= 2e-2, worst


@pytest.mark.parametrize("variant", ["FM", "PM_regs_offset"])
def test_fm_step_loss_and_grads_match_jax(trainer_case, variant):
    acqs, te, p_fm, p_r2 = trainer_case
    over = {"FM": dict(out_vars="FM"),
            "PM_regs_offset": dict(out_vars="PM", FM_TV_weight=1e-3,
                                   FM_L1_weight=1e-2, learn_fm_offset=True)}
    cfg = dict(junsup.DEFAULTS, n_G_filters=F_SMALL, **over[variant])
    jg_fm, jg_r2 = junsup.build_models(cfg)
    j_loss_fn = junsup.make_loss_fn(cfg, jg_fm, jg_r2)
    off = 0.01

    def j_loss(p, o):
        return j_loss_fn(p, o, p_r2, None, jnp.asarray(acqs),
                         jnp.asarray(te), jax.random.PRNGKey(0))[0]

    j_val, (j_grads, j_off) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        p_fm, jnp.float32(off))
    g_fm, g_r2 = _torch_nets(cfg, p_fm, p_r2)
    t_off = torch.tensor(off).requires_grad_()
    loss, metrics = tunsup.make_loss_fn(cfg, g_fm, g_r2)(
        t_off, _t(acqs), _t(te))
    loss.backward()
    assert set(metrics) == {"A2B2A_cycle_loss", "TV_FM", "L1_FM", "G_loss"}
    assert all(p.grad is None for p in g_r2.parameters())
    _compare(loss, {n: p.grad.numpy() for n, p in g_fm.named_parameters()},
             j_val, convert.unet(j_grads))
    if cfg["learn_fm_offset"]:
        np.testing.assert_allclose(float(t_off.grad), float(j_off),
                                   rtol=1e-3, atol=1e-6)
    else:
        assert t_off.grad is None and float(j_off) == 0.0


def test_r2_step_loss_and_grads_match_jax(trainer_case):
    acqs, te, p_fm, p_r2 = trainer_case
    cfg = dict(junsup.DEFAULTS, n_G_filters=F_SMALL, out_vars="PM",
               R2_TV_weight=1e-3, R2_L1_weight=1e-2)
    jg_fm, jg_r2 = junsup.build_models(cfg)

    def j_loss(p):  # make_r2_train_step's loss
        _, r2_mean, a_hat, _ = junsup._uq_pipeline(
            cfg, jg_fm, jg_r2, p_fm, jnp.float32(0.0), p, None,
            jnp.asarray(acqs), jnp.asarray(te), jax.random.PRNGKey(0),
            stop_grad_fm=True, with_var=False)
        loss = jnp.mean(jnp.square(jnp.asarray(acqs) - a_hat))
        r2_tv = jnp.sum(jregs.total_variation_2d(r2_mean[:, 0])) \
            * cfg["R2_TV_weight"]
        return loss + r2_tv + jregs.l1_mean(r2_mean) * cfg["R2_L1_weight"]

    j_val, j_grads = jax.value_and_grad(j_loss)(p_r2)
    g_fm, g_r2 = _torch_nets(cfg, p_fm, p_r2)
    loss, metrics = tunsup.make_r2_loss_fn(cfg, g_fm, g_r2)(
        torch.tensor(0.0), _t(acqs), _t(te))
    loss.backward()
    assert set(metrics) == {"R2_cycle_loss", "TV_R2", "L1_R2"}
    assert all(p.grad is None for p in g_fm.parameters())
    _compare(loss, {n: p.grad.numpy() for n, p in g_r2.named_parameters()},
             j_val, convert.unet(j_grads))


@pytest.mark.parametrize("out_vars", ["FM", "PM"])
def test_cycle_loss_decreases_on_cpu(out_vars):
    acqs, _, te = (np.array(a) for a in j_synthetic(4, h=32, w=32, ne=6))
    cfg = dict(tunsup.DEFAULTS, n_G_filters=F_SMALL, out_vars=out_vars,
               epochs=2, lr=2e-3)
    g_fm, g_r2 = tunsup.build_models(cfg)
    step, tx = tunsup.make_train_step(cfg, g_fm, g_r2)
    r2_step = tunsup.make_r2_train_step(cfg, g_fm, g_r2, tx)
    state = tunsup.init_state(cfg, g_fm, g_r2, tx,
                              torch.Generator().manual_seed(0), "cpu")
    batch = (_t(acqs), _t(te))
    losses_ = []
    for _ in range(6):
        state, m = step(state, batch)
        losses_.append(float(m["G_loss"]))
        if out_vars == "PM":
            state, r2m = r2_step(state, batch)
            assert np.isfinite(float(r2m["R2_cycle_loss"]))
    assert all(np.isfinite(losses_)) and losses_[-1] < losses_[0]
    assert state.step == (12 if out_vars == "PM" else 6)
    assert state.opt_fm.count == 6


def test_unported_settings_raise():
    # bf16 and remat are ported: both nets with the same state-dict names
    small = dict(tunsup.DEFAULTS, n_G_filters=4)
    plain = tunsup.build_models(small)
    for key in ("bf16", "remat"):
        nets = tunsup.build_models(dict(small, **{key: True}))
        assert [set(n.state_dict()) for n in nets] \
            == [set(n.state_dict()) for n in plain]
    # UQ is ported: Bayesian heads (tests/test_torch_uq.py)
    g_fm, g_r2 = tunsup.build_models(dict(tunsup.DEFAULTS, n_G_filters=4,
                                          UQ=True, UQ_R2s=True))
    assert g_fm.sigma is not None and g_r2.sigma is not None


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(tmp_path, *extra):
    return train_unsup.main(
        ["--device", "cpu", "--synthetic", "4", "--data_size", "32",
         "--batch_size", "2", "--n_G_filters", str(F_SMALL), "--output_base",
         str(tmp_path), *extra])


def test_cli_checkpoints_and_resumes(tmp_path, capsys):
    out = _cli(tmp_path, "--epochs", "1", "--out_vars", "PM", "--rand_ne",
               "true", "--data_aug_p", "1.0")
    ckdir = tmp_path / "Unsup-v0" / "checkpoints"
    assert Checkpoint(ckdir).latest_step() == 1
    assert [e["epoch"] for e in out["epochs"]] == [1]
    assert out["state"].step == 4  # 2 batches × (FM + R2)
    saved = Checkpoint(ckdir).restore(1)
    again = _cli(tmp_path, "--epochs", "2", "--out_vars", "PM")
    assert [e["epoch"] for e in again["epochs"]] == [2]
    assert again["state"].opt_fm.count == saved["opt_fm"]["count"] + 2
    assert Checkpoint(ckdir).latest_step() == 2
    text = capsys.readouterr().out
    assert "resumed from epoch 1" in text
    assert "epoch 2/2 cycle_loss=" in text


def test_cli_k_fold_and_remove_ech1(tmp_path):
    out = _cli(tmp_path, "--epochs", "1", "--k_fold", "1", "--k_folds_total",
               "2", "--remove_ech1", "true")
    assert out["epochs"][0]["steps"] == 1  # 4 slices, fold of 2 held out
    with pytest.raises(SystemExit, match="batch_size"):
        _cli(tmp_path / "x", "--epochs", "1", "--batch_size", "8")


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_unsup.main(["--synthetic", "4", "--data_size", "32",
                          "--batch_size", "2", "--output_base",
                          str(tmp_path)])


def test_init_state_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = dict(tunsup.DEFAULTS, n_G_filters=F_SMALL)
    g_fm, g_r2 = tunsup.build_models(cfg)
    _, tx = tunsup.make_train_step(cfg, g_fm, g_r2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tunsup.init_state(cfg, g_fm, g_r2, tx, torch.Generator())
