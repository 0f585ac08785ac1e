"""AI-DEAL uncertainty (UQ) in the port vs the JAX package: the null
projector, the propagated acquisition variance and the PDFF covariance, the
Normal posterior and the heteroscedastic losses, the Bayesian tanh UNet,
the UQ FM step, the σ-calibration step and the held-out NLL, PDFF-var
serving, and the training CLI with the calibration stage.

Inputs are made with numpy from a seed and handed to both packages; model
weights are Flax parameters (every leaf perturbed) converted by
`ideal_gan_tpu_torch.convert.unet`. Tolerances, each the JAX package's own:
- `acq_uncertainty` rtol 2e-3 / atol 1e-5, values and gradients;
  `pdff_uncertainty` ρ rtol 1e-2 / atol 1e-3 and its variance rtol 1e-2 /
  atol 1e-4 (tests/test_parity_reference.py:174-230); the null projector
  atol 1e-6 (float32 products of unit-size entries);
- `Normal`, the losses and `pdff_variance_map` rtol 1e-5 / atol 1e-6 (float32
  elementwise); the losses' gradients rtol 1e-3, as the cycle's
  (tests/test_pallas_kernels.py:101-173): near the 1e-5 floor the σ²
  derivative of `var_mse` is the difference of two terms ~1/σ², which
  float32 rounds in either order (5.4e-4 relative measured); the Bayesian
  UNet rtol / atol 1e-4 (tests/test_torch_models.py);
- the UQ FM step and the calibration step: loss and metrics to 2e-5
  relative, every gradient leaf to 2e-2 of the global gradient scale
  (MODEL_PARITY.json `tolerances`), `calib` after a step atol 1e-6;
- served ρ atol 5e-3 and the PDFF-var covariance rtol 1e-2 / atol 1e-4
  (tests/test_torch_infer.py; the fit turns the nets' 1e-5 residue into
  up to ~22 times that in ρ).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.cli import roi_analysis as jroi  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.losses import heteroscedastic as jhet  # noqa: E402
from ideal_gan_tpu.physics import matrix as jmx  # noqa: E402
from ideal_gan_tpu.prob import Normal as JNormal  # noqa: E402
from ideal_gan_tpu.prob import Rician as JRician  # noqa: E402
from ideal_gan_tpu.prob import distributions as jdist  # noqa: E402
from ideal_gan_tpu.train import unsup as junsup  # noqa: E402
from ideal_gan_tpu_torch import convert, losses, physics, prob  # noqa: E402
from ideal_gan_tpu_torch.cli import infer, roi_analysis, train_unsup  # noqa: E402
from ideal_gan_tpu_torch.train import unsup as tunsup  # noqa: E402
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


def _flat(tree, prefix):
    return {prefix + jax.tree_util.keystr(k, simple=True, separator="/"):
            np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# --------------------------------------------------------------------------
# the physics
# --------------------------------------------------------------------------

def _te(nb):
    return np.asarray(jph.te_train(6, bs=nb), np.float32)


def _posteriors(nb, h, w, seed):
    rng = np.random.default_rng(seed)
    phi_m = rng.uniform(-0.3, 0.3, (nb, h, w)).astype(np.float32)
    r2_m = rng.uniform(0.0, 0.5, (nb, h, w)).astype(np.float32)
    phi_v = rng.uniform(1e-5, 1e-3, (nb, h, w)).astype(np.float32)
    r2_v = rng.uniform(1e-5, 1e-3, (nb, h, w)).astype(np.float32)
    return phi_m, phi_v, r2_m, r2_v


def test_null_projector_matches_jax():
    te = _te(2) + np.random.default_rng(0).uniform(
        -2e-4, 2e-4, (2, 6, 1)).astype(np.float32)
    jm = jmx.model_matrix(jnp.asarray(te))
    ref = np.asarray(jmx.null_projector(jm, jmx.pinv_normal(jm)))
    m = physics.model_matrix(_t(te))
    got = physics.null_projector(m, physics.pinv_normal(m))
    assert got.dtype == torch.complex64 and got.shape == (2, 6, 6)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    # a Hermitian projector that annihilates span(M)
    np.testing.assert_allclose((got @ got).numpy(), got.numpy(), atol=1e-5)
    assert float((got @ m).abs().max()) < 1e-4


@pytest.mark.parametrize("rem_r2", [False, True])
def test_acq_uncertainty_and_gradients_match_jax(rem_r2):
    nb, h, w = 2, 8, 8
    rng = np.random.default_rng(1)
    rho = rng.uniform(-0.5, 0.7, (nb, 3, h, w, 2)).astype(np.float32)
    phi_m, phi_v, r2_m, r2_v = _posteriors(nb, h, w, 2)
    te = _te(nb)
    weights = rng.normal(size=(nb, 6, h, w, 2)).astype(np.float32)

    def j_fn(rho_, pv, rm, rv):
        var = jph.acq_uncertainty(rho_, jph.Posterior(phi_m, pv),
                                  jph.Posterior(rm, rv), jnp.asarray(te),
                                  rem_r2=rem_r2)
        return var, jnp.sum(var * weights)

    ref, _ = j_fn(jnp.asarray(rho), phi_v, r2_m, r2_v)
    j_grads = jax.grad(lambda *a: j_fn(*a)[1], argnums=(0, 1, 2, 3))(
        jnp.asarray(rho), jnp.asarray(phi_v), jnp.asarray(r2_m),
        jnp.asarray(r2_v))
    leaves = [_t(x).requires_grad_() for x in (rho, phi_v, r2_m, r2_v)]
    got = physics.acq_uncertainty(
        leaves[0], physics.Posterior(_t(phi_m), leaves[1]),
        physics.Posterior(leaves[2], leaves[3]), _t(te), rem_r2=rem_r2)
    assert got.shape == (nb, 6, h, w, 2)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-3,
                               atol=1e-5)
    torch.sum(got * _t(weights)).backward()
    for leaf, j_g in zip(leaves, j_grads):
        if rem_r2 and float(np.abs(j_g).max()) == 0.0:
            assert leaf.grad is None or not leaf.grad.any()
            continue
        np.testing.assert_allclose(leaf.grad.numpy(), j_g, rtol=2e-3,
                                   atol=1e-5 * max(1.0, np.abs(j_g).max()))
    only = physics.acq_uncertainty(
        _t(rho), physics.Posterior(_t(phi_m), _t(phi_v)),
        physics.Posterior(_t(r2_m), _t(r2_v)), _t(te), rem_r2=rem_r2,
        only_mag=True)
    np.testing.assert_array_equal(only.numpy(), got[..., :1].detach().numpy())


@pytest.mark.parametrize("rem_r2", [False, True])
def test_pdff_uncertainty_matches_jax(rem_r2):
    nb, h, w = 2, 8, 8
    acqs, maps, _ = (np.array(x) for x in j_synthetic(nb, h=h, w=w, ne=6))
    acqs = acqs + 0.01 * np.random.default_rng(3).normal(
        size=acqs.shape).astype(np.float32)
    phi_m, phi_v, r2_m, r2_v = _posteriors(nb, h, w, 4)
    phi_m = maps[:, 2, ..., 0] + 0.01 * phi_m
    te = _te(nb)
    rho_ref, var_ref = jph.pdff_uncertainty(
        jnp.asarray(acqs), jph.Posterior(phi_m, phi_v),
        jph.Posterior(r2_m, r2_v), jnp.asarray(te), rem_r2=rem_r2)
    rho, var = physics.pdff_uncertainty(
        _t(acqs), physics.Posterior(_t(phi_m), _t(phi_v)),
        physics.Posterior(_t(r2_m), _t(r2_v)), _t(te), rem_r2=rem_r2)
    assert rho.shape == (nb, 2, h, w, 2) and var.shape == (nb, 4, h, w, 1)
    np.testing.assert_allclose(rho.numpy(), rho_ref, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(var.numpy(), var_ref, rtol=1e-2, atol=1e-4)


# --------------------------------------------------------------------------
# the posterior and the losses
# --------------------------------------------------------------------------

def test_normal_matches_jax():
    rng = np.random.default_rng(5)
    loc = rng.normal(size=(3, 4)).astype(np.float32)
    scale = rng.uniform(0.1, 2.0, (3, 4)).astype(np.float32)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    jn, tn = JNormal(jnp.asarray(loc), jnp.asarray(scale)), \
        prob.Normal(_t(loc), _t(scale))
    for name in ("mean", "variance", "stddev", "kl_to_std_normal"):
        np.testing.assert_allclose(getattr(tn, name)().numpy(),
                                   getattr(jn, name)(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tn.log_prob(_t(x)).numpy(),
                               jn.log_prob(jnp.asarray(x)), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(prob.softplus_lb(_t(x)).numpy(),
                               jdist.softplus_lb(jnp.asarray(x)), rtol=1e-5,
                               atol=1e-6)
    # samples: seeded by the generator, loc + scale·N(0, 1) in shape
    draw = tn.sample(torch.Generator().manual_seed(0), (20000,))
    again = tn.sample(torch.Generator().manual_seed(0), (20000,))
    assert draw.shape == (20000, 3, 4) and torch.equal(draw, again)
    z = (draw - _t(loc)) / _t(scale)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01


def test_losses_match_jax():
    rng = np.random.default_rng(6)
    y = rng.uniform(0.0, 1.0, (2, 6, 8, 8, 2)).astype(np.float32)
    y[0, 0, 0, 0] = 0.0
    mu = (y + 0.1 * rng.normal(size=y.shape)).astype(np.float32)
    var = rng.uniform(0.0, 0.05, y.shape).astype(np.float32)
    var[0, 1, :2] = 0.0  # below the floor
    pred = np.concatenate([mu, var], axis=-1)
    y1, mag1 = y[..., :1], np.abs(mu[..., :1])

    cases = [
        (losses.var_mse, jhet.var_mse, (y, pred)),
        (losses.var_mse_r2, jhet.var_mse_r2,
         (y1, np.concatenate([mag1, var[..., :1]], -1))),
        (losses.var_mse_r2, jhet.var_mse_r2, (y1, mag1)),
        (losses.absolute_phase_disparity, jhet.absolute_phase_disparity,
         (y, mu)),
    ]
    for t_fn, j_fn, args in cases:
        leaf = _t(args[1]).requires_grad_()
        got = t_fn(_t(args[0]), leaf)
        j_val, j_grad = jax.jit(lambda y_, p: (j_fn(y_, p), jax.grad(
            lambda q: jnp.sum(j_fn(y_, q)))(p)))(*map(jnp.asarray, args))
        np.testing.assert_allclose(got.detach().numpy(), j_val, rtol=1e-5,
                                   atol=1e-6)
        torch.sum(got).backward()
        # the phase disparity's gradient at a zero magnitude: JAX's
        # arctan2 gives NaN, torch's atan2 0
        finite = np.isfinite(j_grad)
        assert np.isfinite(leaf.grad.numpy()).all()
        np.testing.assert_allclose(leaf.grad.numpy()[finite],
                                   np.asarray(j_grad)[finite], rtol=1e-3,
                                   atol=1e-6 * float(np.abs(
                                       np.asarray(j_grad)[finite]).max()))
    nu = np.abs(mu[..., :1]) + 0.1
    sigma = rng.uniform(0.05, 0.3, nu.shape).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.rician_nll(_t(y1), prob.Rician(_t(nu), _t(sigma)))),
        float(jhet.rician_nll(jnp.asarray(y1), JRician(jnp.asarray(nu),
                                                      jnp.asarray(sigma)))),
        rtol=1e-5)


# --------------------------------------------------------------------------
# the UQ steps
# --------------------------------------------------------------------------

def _abs(a):
    return jnp.sqrt(jnp.sum(jnp.square(a), axis=-1, keepdims=True))


@pytest.fixture(scope="module")
def uq_case():
    """The cohort, the UQ nets' Flax parameters and, from one jitted call,
    both nets' posteriors (the Bayesian tanh UNet's Normal, the R2* net's
    Rician)."""
    acqs, _, te = (np.array(a) for a in j_synthetic(2, h=32, w=32, ne=6))
    cfg = dict(junsup.DEFAULTS, n_G_filters=F_SMALL, UQ=True, UQ_R2s=True)
    g_fm, g_r2 = junsup.build_models(cfg)
    a = jnp.asarray(acqs)
    p_fm = flax_params(g_fm, a[:1], 41, noise=0.02)
    p_r2 = flax_params(g_r2, _abs(a)[:1], 42, noise=0.02)
    outs = jax.jit(lambda pf, pr: (g_fm.apply({"params": pf}, a),
                                   g_r2.apply({"params": pr}, _abs(a))))(
                                       p_fm, p_r2)
    return acqs, te, p_fm, p_r2, outs


def test_bayesian_tanh_unet_matches_flax(uq_case):
    acqs, _, p_fm, _, (ref, _) = uq_case
    cfg = dict(junsup.DEFAULTS, n_G_filters=F_SMALL, UQ=True)
    assert isinstance(ref, JNormal)
    tnet, _ = tunsup.build_models(cfg)
    tnet.load_state_dict(convert.unet(p_fm))
    out = tnet(_t(acqs))
    assert isinstance(out, prob.Normal)
    assert out.loc.shape == out.scale.shape == (2, 1, 32, 32, 1)
    np.testing.assert_allclose(out.loc.detach().numpy(), ref.loc, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out.scale.detach().numpy(), ref.scale,
                               rtol=1e-4, atol=1e-4)


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


CALIB = np.array([1.0, 0.8, 1.3, 0.5, 1.1, 0.9], np.float32)


class _Outputs:
    """A stand-in for a Flax net whose `apply` returns its params: the JAX
    loss as a function of the nets' outputs (the port nets' posteriors)."""

    def apply(self, variables, x, rngs=None, train=True):
        return variables["params"]


def _as_jax(out):
    if isinstance(out, prob.Normal):
        return JNormal(jnp.asarray(out.loc.detach().numpy()),
                       jnp.asarray(out.scale.detach().numpy()))
    if isinstance(out, prob.Rician):
        return JRician(jnp.asarray(out.nu.detach().numpy()),
                       jnp.asarray(out.sigma.detach().numpy()))
    return jnp.asarray(out.detach().numpy())


@pytest.mark.parametrize("variant", ["FM", "PM", "PM_UQ_R2s"])
def test_uq_fm_step_matches_jax(uq_case, variant):
    """The step held stage by stage: the posteriors to Flax's (the UNet
    tolerance), the loss and metrics to JAX's loss on the port's posteriors
    (2e-5), every gradient leaf to the JAX step's (2e-2 of scale). The
    loss of two independent float32 stacks is not held to 2e-5: at 32 px
    the nets' 2×2 bottleneck leaves Flax's and the port's φ ~1e-4 from
    float64 alike, and `var_mse`'s 1/σ moves the loss by 1.2e-5 (the
    port) and 5.4e-5 (JAX) from its value on float64 nets (PM_UQ_R2s;
    ROADMAP Queue 3)."""
    acqs, te, p_fm, p_r2, _ = uq_case
    over = {"FM": dict(out_vars="FM", UQ_R2s=False),
            "PM": dict(out_vars="PM", UQ_R2s=False),
            "PM_UQ_R2s": dict(out_vars="PM", FM_TV_weight=1e-3,
                              learn_fm_offset=True)}[variant]
    cfg = dict(dict(junsup.DEFAULTS, n_G_filters=F_SMALL, UQ=True,
                    UQ_R2s=True), **over)
    p_r2v = p_r2 if cfg["UQ_R2s"] else {k: v for k, v in p_r2.items()
                                        if k not in ("Conv_1", "Conv_2")}
    jg_fm, jg_r2 = junsup.build_models(cfg)
    a, t, key = jnp.asarray(acqs), jnp.asarray(te), jax.random.PRNGKey(0)
    off = 0.01

    def j_loss(p, o):
        return junsup.make_loss_fn(cfg, jg_fm, jg_r2)(
            p, o, p_r2v, jnp.asarray(CALIB), a, t, key)

    def j_step(p, o):  # the JAX step's gradients and both nets' outputs
        return (jax.grad(j_loss, argnums=(0, 1), has_aux=True)(p, o)[0],
                [jg_fm.apply({"params": p}, a),
                 jg_r2.apply({"params": p_r2v}, _abs(a))])

    (j_grads, j_off), refs = jax.jit(j_step)(p_fm, jnp.float32(off))
    g_fm, g_r2 = _torch_nets(cfg, p_fm, p_r2v)
    t_off = torch.tensor(off).requires_grad_()
    loss, metrics = tunsup.make_loss_fn(cfg, g_fm, g_r2)(
        t_off, _t(acqs), _t(te), _t(CALIB))
    loss.backward()

    with torch.no_grad():
        outs = [_as_jax(g_fm(_t(acqs))), _as_jax(g_r2(torch.sqrt(torch.sum(
            torch.square(_t(acqs)), dim=-1, keepdim=True))))]
    for out, ref in zip(outs, refs):
        for got, want in zip(jax.tree_util.tree_leaves(out),
                             jax.tree_util.tree_leaves(ref)):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    j_val, j_metrics = junsup.make_loss_fn(cfg, _Outputs(), _Outputs())(
        outs[0], jnp.float32(off), outs[1], jnp.asarray(CALIB), a, t, key)
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():  # relative to max(|JAX|, 1), as _compare
        np.testing.assert_allclose(float(v.detach()), float(j_metrics[k]),
                                   rtol=2e-5, atol=2e-5, err_msg=k)
    assert all(p.grad is None for p in g_r2.parameters())
    assert g_fm.sigma.conv2.weight.grad.abs().max() > 0
    grads = {n: p.grad.numpy() for n, p in g_fm.named_parameters()}
    j_grads = convert.unet(j_grads)
    if cfg["learn_fm_offset"]:  # the offset is one more gradient leaf
        grads["fm_offset"], j_grads["fm_offset"] = t_off.grad.numpy(), j_off
    else:
        assert t_off.grad is None and float(j_off) == 0.0
    _compare(loss, grads, j_val, j_grads)


def _j_state(cfg, g_fm, g_r2, p_fm, p_r2, calib):
    _, tx = junsup.make_train_step(cfg, g_fm, g_r2)
    return junsup.UnsupState(p_fm, tx.init(p_fm), p_r2, tx.init(p_r2),
                             jnp.asarray(calib),
                             junsup.make_calib_tx(cfg).init(
                                 jnp.asarray(calib)),
                             jnp.float32(0.0), jnp.zeros((), jnp.int32))


def test_calib_step_and_nll_match_jax(uq_case):
    acqs, te, p_fm, p_r2, _ = uq_case
    # a rate large enough that the step takes some entries below 0, where
    # the projection holds them at 0
    cfg = dict(junsup.DEFAULTS, n_G_filters=F_SMALL, UQ=True, UQ_R2s=True,
               out_vars="PM", UQ_calib=True, lr=20.0)
    jg_fm, jg_r2 = junsup.build_models(cfg)
    state0 = _j_state(cfg, jg_fm, jg_r2, p_fm, p_r2, CALIB)
    a, t = jnp.asarray(acqs), jnp.asarray(te)
    key = jax.random.PRNGKey(0)
    j_state, j_m = junsup.make_calib_train_step(cfg, jg_fm, jg_r2)(
        state0, (a, t), key)
    j_calib = np.asarray(j_state.calib)
    assert (j_calib == 0).any() and (j_calib > 0).any()

    g_fm, g_r2 = _torch_nets(cfg, p_fm, p_r2)
    _, tx = tunsup.make_train_step(cfg, g_fm, g_r2)
    state = tunsup.init_state(cfg, g_fm, g_r2, tx, torch.Generator(), "cpu")
    g_fm.load_state_dict(convert.unet(p_fm))
    g_r2.load_state_dict(convert.unet(p_r2))
    with torch.no_grad():
        state.calib.copy_(_t(CALIB))
    # the held-out NLL against JAX's on the port's posteriors: where calib
    # is 0, var_mse's floor multiplies the nets' float32 residue in Â by
    # 1/√1e-5 ≈ 316
    nll = tunsup.eval_calibrated_nll(cfg, g_fm, g_r2)
    with torch.no_grad():
        outs = [_as_jax(g_fm(_t(acqs))), _as_jax(g_r2(torch.sqrt(torch.sum(
            torch.square(_t(acqs)), dim=-1, keepdim=True))))]
    j_nll = junsup.eval_calibrated_nll(cfg, _Outputs(), _Outputs())
    j_on_outs = _j_state(cfg, jg_fm, jg_r2, *outs, CALIB)
    np.testing.assert_allclose(float(nll(state, _t(acqs), _t(te))),
                               float(j_nll(j_on_outs, a, t, key)), rtol=2e-5)
    # the step's loss and its one gradient leaf, calib
    calib = _t(CALIB).requires_grad_()
    loss, metrics = tunsup.make_calib_loss_fn(cfg, g_fm, g_r2)(
        calib, state.fm_offset, _t(acqs), _t(te))
    loss.backward()

    def j_calib_loss(c):
        _, _, a_hat, a_var = junsup._uq_pipeline(
            cfg, jg_fm, jg_r2, p_fm, jnp.float32(0.0), p_r2, c, a, t, key,
            train=False)
        return jhet.var_mse(a, jnp.concatenate([a_hat, a_var], axis=-1))

    j_grad = jax.jit(jax.grad(j_calib_loss))(jnp.asarray(CALIB))
    _compare(loss, {"calib": calib.grad.numpy()}, j_m["calib_loss"],
             {"calib": j_grad})
    assert all(p.grad is None for net in (g_fm, g_r2)
               for p in net.parameters())
    # one step: SGD at lr, then the projection at 0
    step = tunsup.make_calib_train_step(cfg, g_fm, g_r2)
    before = {k: v.clone() for k, v in g_fm.state_dict().items()}
    state, m = step(state, (_t(acqs), _t(te)))
    np.testing.assert_allclose(float(m["calib_loss"]),
                               float(j_m["calib_loss"]), rtol=2e-5)
    # the step moves calib by lr·g: it is held to lr times the gradient's
    # tolerance
    np.testing.assert_allclose(
        state.calib.detach().numpy(), j_calib,
        atol=cfg["lr"] * 2e-2 * float(np.abs(j_grad).max()))
    assert (state.calib == 0).any() and state.step == 1
    assert all(torch.equal(v, before[k])
               for k, v in g_fm.state_dict().items())
    j_at = j_on_outs._replace(
        calib=jnp.asarray(state.calib.detach().numpy()))
    np.testing.assert_allclose(float(nll(state, _t(acqs), _t(te))),
                               float(j_nll(j_at, a, t, key)), rtol=2e-5)



def test_checkpoints_without_calib_load_with_ones(tmp_path):
    cfg = dict(tunsup.DEFAULTS, n_G_filters=F_SMALL, UQ=True)
    g_fm, g_r2 = tunsup.build_models(cfg)
    _, tx = tunsup.make_train_step(cfg, g_fm, g_r2)
    state = tunsup.init_state(cfg, g_fm, g_r2, tx,
                              torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        state.calib.mul_(0.5)
    sd = state.state_dict()
    assert torch.equal(sd["calib"], torch.full((6,), 0.5))
    old = {k: v for k, v in sd.items() if k not in ("calib", "opt_calib")}
    ck = Checkpoint(tmp_path)
    ck.save(1, old)
    state.load_state_dict(ck.restore(1))
    assert torch.equal(state.calib.detach(), torch.ones(6))
    state.load_state_dict(sd)
    assert torch.equal(state.calib.detach(), torch.full((6,), 0.5))


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_pdff_variance_map_matches_jax():
    rng = np.random.default_rng(7)
    maps = rng.normal(size=(2, 3, 8, 8, 2)).astype(np.float32)
    maps[0, 1, 0, 0] = 0.0  # |F| = 0
    maps[0, 0, 0, 1] = -maps[0, 1, 0, 1]  # |W + F| = 0
    rho_var = rng.uniform(0.0, 0.1, (2, 4, 8, 8, 1)).astype(np.float32)
    got = roi_analysis.pdff_variance_map(maps, rho_var)
    np.testing.assert_allclose(got, jroi.pdff_variance_map(maps, rho_var),
                               rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all() and got[0, 0, 1] == 0.0


@pytest.mark.parametrize("map_name", ["PDFF-var", "PDFF"])
def test_infer_run_with_uq_heads_matches_jax(uq_case, tmp_path, map_name):
    """The AI-DEAL closure of the JAX `make_infer_run` (posterior heads, then
    `pdff_uncertainty` or the map fit) against the port's, on the UQ nets'
    weights through `--weights`."""
    acqs, te, p_fm, p_r2, (out, out_r2) = uq_case
    acqs = acqs[:2]
    a = jnp.asarray(acqs)
    fm, fm_var, r2, r2_var = out.loc, out.variance(), out_r2.nu, \
        out_r2.variance()
    if map_name == "PDFF-var":
        rho, rho_var = jph.pdff_uncertainty(
            a, jph.Posterior(fm[:, 0, ..., 0], fm_var[:, 0, ..., 0]),
            jph.Posterior(r2[:, 0, ..., 0], r2_var[:, 0, ..., 0]),
            jnp.asarray(te[:2]))
    else:
        rho = jph.fit_rho(a, jnp.concatenate([fm, r2], -1),
                          jnp.asarray(te[:2]))
        rho_var = np.zeros((2, 4, 32, 32, 1), np.float32)
    ref = np.asarray(rho)

    weights = tmp_path / "uq.npz"
    np.savez(weights, **_flat(p_fm, "params_fm/"), **_flat(p_r2, "params_r2/"))
    cfg = dict(infer.DEFAULTS, model_sel="AI-DEAL", weights=str(weights),
               map=map_name)
    run = roi_analysis.make_infer_run(cfg, acqs, device="cpu")
    maps, var = roi_analysis._per_slice(run, acqs, te[:2], 2, device="cpu")
    np.testing.assert_allclose(maps[:, 2, ..., :1], np.asarray(fm[:, 0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(maps[:, 2, ..., 1:], np.asarray(r2[:, 0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(maps[:, :2], ref, atol=5e-3)
    np.testing.assert_allclose(var, np.asarray(rho_var), rtol=1e-2,
                               atol=1e-4)
    assert (var.any() if map_name == "PDFF-var" else not var.any())


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(tmp_path, *extra):
    return train_unsup.main(
        ["--device", "cpu", "--synthetic", "8", "--data_size", "32",
         "--batch_size", "2", "--n_G_filters", str(F_SMALL), "--epochs", "1",
         "--output_base", str(tmp_path), *extra])


def test_cli_uq_calibration_stage(tmp_path, capsys):
    out = _cli(tmp_path, "--out_vars", "PM", "--UQ", "1", "--UQ_R2s", "1",
               "--UQ_calib", "1", "--lr", "0.05")
    # 8 slices: a calibration split of max(8 // 5, 2) = 2, 6 to train
    assert out["epochs"][0]["steps"] == 3
    cal = out["calibration"]
    assert cal["steps"] == 1 and len(cal["calib"]) == 6
    assert np.isfinite([cal["nll_before"], cal["nll_after"]]).all()
    assert min(cal["calib"]) >= 0.0 and cal["calib"] != [1.0] * 6
    ckdir = tmp_path / "Unsup-v0" / "checkpoints"
    assert Checkpoint(ckdir).latest_step() == 2
    saved = Checkpoint(ckdir).restore(2)
    np.testing.assert_allclose(saved["calib"].numpy(), cal["calib"])
    assert "calibration: held-out NLL" in capsys.readouterr().out


def test_cli_uq_calib_needs_a_bayesian_head(tmp_path, capsys):
    with pytest.raises(SystemExit, match="UQ_calib requires"):
        _cli(tmp_path, "--UQ_calib", "1")
    # too small a cohort for the split: the stage is skipped
    out = _cli(tmp_path / "s", "--synthetic", "3", "--UQ", "1",
               "--UQ_calib", "1")
    assert "calibration" not in out
    assert "skipping the calibration stage" in capsys.readouterr().out
