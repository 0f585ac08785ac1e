"""The port's last modules vs the JAX package's on the same numpy inputs and
the same weights: `Rician.sample`, the Flipout convolution, the Bayesian
residual block, `Decoder(bayes_layer=True)` with groups, `BayesDecoder`,
`CriticZ`, `SGAN` with Flax's batch norm, the PatchGAN's kernel sizes and
groups, `gradient_penalty`, the complex layers and `PMComplex`, and the
InceptionV3 features, with their `convert` maps.

Weights are Flax variables traced with `jax.eval_shape` and filled from a
seed (`_fill`), carried across by `ideal_gan_tpu_torch.convert`. Where the
JAX module draws (`jax.random.normal`, `rademacher`, `uniform`, looked up at
call time), the test records its draws by wrapping those functions with
`monkeypatch` around an eager JAX call and replays them into the port
(`prob.Replay`): `jax.random` streams cannot be reproduced in PyTorch.

Tolerances, as `tests/test_torch_models.py` states them: single blocks
rtol / atol 1e-5 (float32 on both sides, convolution sums in other orders),
whole nets 1e-4; gradients and the InceptionV3 features (97 layers) 1e-4
of their scale; exact where both sides select (the complex max-pool).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import losses as jlosses  # noqa: E402
from ideal_gan_tpu.eval import inception as jinc  # noqa: E402
from ideal_gan_tpu.models import bayes as jbayes  # noqa: E402
from ideal_gan_tpu.models import blocks as jblocks  # noqa: E402
from ideal_gan_tpu.models import complexnn as jcx  # noqa: E402
from ideal_gan_tpu.models import discriminator as jdisc  # noqa: E402
from ideal_gan_tpu.models import vae as jvae  # noqa: E402
from ideal_gan_tpu.prob import Rician as JRician  # noqa: E402
from ideal_gan_tpu_torch import convert, losses, models, prob  # noqa: E402
from ideal_gan_tpu_torch.eval import inception  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

BLOCK, NET, SCALE = 1e-5, 1e-4, 1e-4


class _Draws:
    """Records the JAX draws (`jax.random.normal`, `rademacher`, `uniform`,
    wrapped by the `jd` fixture) of a traced function: `record(fn)` is fn
    returning also the values it drew, in call order (traceable, so that
    the JAX side runs jitted: eager Flax applies are several times
    slower); `kinds` the kinds of the last recorded call, and
    `replay(values)` the `prob.Replay` of them."""

    def __init__(self):
        self.rec, self.kinds = [], []

    def record(self, fn):
        def recorded(*args, **kwargs):
            self.rec.clear()
            out = fn(*args, **kwargs)
            self.kinds = [k for k, _ in self.rec]
            return out, [v for _, v in self.rec]
        return recorded

    def replay(self, values) -> prob.Replay:
        return prob.Replay([(k, np.asarray(v))
                            for k, v in zip(self.kinds, values)])


@pytest.fixture
def jd(monkeypatch):
    draws = _Draws()
    for kind in ("normal", "rademacher", "uniform"):
        orig = getattr(jax.random, kind)

        def wrapped(*args, _orig=orig, _kind=kind, **kwargs):
            val = _orig(*args, **kwargs)
            draws.rec.append((_kind, val))
            return val

        monkeypatch.setattr(jax.random, kind, wrapped)
    return draws


def _weights(shape):
    """Fixed weights of an output in a test objective."""
    return np.cos(0.37 * np.arange(int(np.prod(shape)))).reshape(
        shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _crand(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64)


def _close(got, ref, tol=BLOCK):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=tol, atol=tol)


def _scaled(got: dict, ref: dict, tol=SCALE):
    """Every leaf of `got` within tol of the largest |ref| leaf (a leaf
    torch leaves at None, one the loss does not reach, is 0 as JAX's)."""
    assert set(got) == set(ref)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    for k in ref:
        g = np.zeros_like(ref[k]) if got[k] is None else \
            got[k].detach().cpu().numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        np.testing.assert_allclose(g, np.asarray(ref[k]), rtol=0,
                                   atol=tol * scale, err_msg=k)


def _fill(tree, seed):
    """Values for a tree of shapes: He-normal kernels (N(0, 2/fan_in)),
    Flipout log σ −3 + 0.1·N, norm scales 1 + 0.1·N, the complex norm's Γ
    diagonal 0.7 + 0.05·N and off-diagonal 0.1·N, attention γ 0.7, other
    vectors 0.05·N; batch statistics: means 0.1·N, variances 0.7 +
    0.2·|N| (BatchNorm's `var` 1 + 0.2·|N|), the complex covariance
    0.1·N."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = jax.tree_util.keystr(path), sds.shape
        if "kernel_log_sigma" in name:
            v = -3.0 + 0.1 * rng.normal(size=shape)
        elif "gamma_ri" in name or "vri" in name or "mean" in name:
            v = 0.1 * rng.normal(size=shape)
        elif "gamma_rr" in name or "gamma_ii" in name:
            v = 0.7 + 0.05 * rng.normal(size=shape)
        elif "gamma" in name:
            v = np.full(shape, 0.7)
        elif "vrr" in name or "vii" in name:
            v = 0.7 + 0.2 * np.abs(rng.normal(size=shape))
        elif name.endswith("'var']"):
            v = 1.0 + 0.2 * np.abs(rng.normal(size=shape))
        elif name.endswith("/u']"):
            v = rng.normal(size=shape)
        elif name.endswith("/sigma']"):
            v = np.ones(shape)
        elif "scale" in name:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2:
            v = rng.normal(size=shape) * (2.0 / np.prod(shape[:-1])) ** 0.5
        else:
            v = 0.05 * rng.normal(size=shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _variables(module, seed, *args, **kwargs):
    """Filled Flax variables of `module` (its init traced, not run)."""
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": key, "bayes": key}, *args, **kwargs))
    return _fill(dict(shapes), seed)


def _key(seed):
    return {"bayes": jax.random.PRNGKey(100 + seed)}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _kl_jax(state):
    return sum(float(np.sum(v)) for v in jax.tree_util.tree_leaves(
        state.get("losses", {})))


# --------------------------------------------------------------------------
# the Rician sampler
# --------------------------------------------------------------------------

def test_rician_sample_matches_jax_on_its_draws(jd):
    nu = np.abs(_rand((3, 4), 1)) + 0.1
    sigma = np.abs(_rand((3, 4), 2, 0.2))
    sigma[0, 0] = 0.0  # floored at 1e-10
    ref, vals = jax.jit(jd.record(lambda n, s: JRician(n, s).sample(
        jax.random.PRNGKey(3), (5,))))(jnp.asarray(nu), jnp.asarray(sigma))
    assert jd.kinds == ["normal", "normal"]
    replay = jd.replay(vals)
    got = prob.Rician(_t(nu), _t(sigma)).sample(replay, (5,))
    assert got.shape == (5, 3, 4) and replay.remaining == 0
    _close(got, ref, 1e-6)
    # from a generator: the Rician mean, E = σ√(π/2)·L½(−ν²/2σ²)
    dist = prob.Rician(torch.tensor([0.5, 2.0]), torch.tensor([0.3, 0.3]))
    s = dist.sample(torch.Generator().manual_seed(0), (40000,))
    se = s.std(dim=0) / 200.0
    assert bool(((s.mean(dim=0) - dist.mean()).abs() < 4 * se).all())


def test_replay_checks_kind_shape_and_count():
    like = torch.zeros(())
    replay = prob.Replay([("normal", np.zeros((2, 3)))])
    with pytest.raises(ValueError, match="rademacher"):
        replay.rademacher((2, 3), like)
    with pytest.raises(ValueError, match=r"\(3, 2\)"):
        replay.normal((3, 2), like)
    assert replay.normal((2, 3), like).shape == (2, 3)
    with pytest.raises(IndexError):
        replay.normal((2, 3), like)
    with pytest.raises(ValueError, match="noise source"):
        models.FlipoutConv(3, 4)(torch.zeros(1, 3, 4, 4), noise=None)


# --------------------------------------------------------------------------
# the Flipout layers and the Bayesian decoders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("deterministic,strides,activation", [
    (False, 1, None), (False, 2, "leaky_relu"), (True, 1, "tanh")])
def test_flipout_conv_matches_jax(jd, deterministic, strides, activation):
    x = _rand((2, 8, 8, 3), 4)
    jm = jbayes.FlipoutConv(4, (3, 3), strides=strides,
                            activation=activation)
    p = _variables(jm, 4, jnp.asarray(x))["params"]

    def j_obj(params):
        (out, st), vals = jd.record(lambda: jm.apply(
            {"params": params}, jnp.asarray(x), deterministic, rngs=_key(4),
            mutable=["losses"]))()
        kl = jax.tree_util.tree_leaves(st)[0]
        return jnp.sum(out * _weights(out.shape)) + kl, (out, kl, vals)

    (_, (ref, kl, vals)), j_grads = jax.jit(jax.value_and_grad(
        j_obj, has_aux=True))(p)
    assert len(vals) == (0 if deterministic else 3)
    tm = models.FlipoutConv(3, 4, strides=strides, activation=activation)
    tm.load_state_dict(convert.flipout(p))
    got = tm(_nchw(x), deterministic=deterministic, noise=jd.replay(vals))
    _close(_nhwc(got), ref)
    np.testing.assert_allclose(float(tm.kl().detach()), float(kl),
                               rtol=1e-5)
    # the gradients of the KL-regularized output, on the same draws
    (torch.sum(_nchw(_weights(np.shape(ref))) * got) + tm.kl()).backward()
    _scaled({n: q.grad for n, q in tm.named_parameters()},
            {k: v.numpy() for k, v in convert.flipout(j_grads).items()})


def test_bayes_residual_block_samples_in_eval_too(jd):
    x = _rand((2, 8, 8, 6), 6)
    jm = jblocks.ResidualBlock(bayes=True)
    p = _variables(jm, 6, jnp.asarray(x), False)["params"]
    ref, vals = jax.jit(jd.record(lambda a: jm.apply(
        {"params": p}, a, False, rngs=_key(6))))(jnp.asarray(x))
    assert jd.kinds == ["normal", "rademacher", "rademacher"] * 2
    tm = models.ResidualBlock(6, bayes=True)
    tm.load_state_dict(convert.bayes_residual_block(p, ""))
    _close(_nhwc(tm(_nchw(x), noise=jd.replay(vals))), ref)
    # a plain block with groups, against Flax's feature_group_count
    jg = jblocks.ResidualBlock(groups=2)
    pg = _variables(jg, 7, jnp.asarray(x))["params"]
    tg = models.ResidualBlock(6, groups=2)
    tg.load_state_dict(convert.conv_block(pg, ""))
    _close(_nhwc(tg(_nchw(x))),
           jax.jit(jg.apply)({"params": pg}, jnp.asarray(x)))


def _losses_sum(state):
    return sum(jax.tree_util.tree_leaves(state.get("losses", {})))


@pytest.mark.parametrize("bayes_layer,train,n_groups,multi_echo", [
    (True, True, 1, True), (True, False, 2, True), (False, True, 2, False)])
def test_decoder_bayes_head_and_groups_match_jax(jd, bayes_layer, train,
                                                 n_groups, multi_echo):
    z = _rand((2, 4, 4, 8), 8)
    kw = dict(filters=4, num_layers=2, num_res_blocks=1, n_groups=n_groups,
              multi_echo=multi_echo, bayes_layer=bayes_layer)
    jm = jvae.Decoder(encoded_dims=8, n_out=2, **kw)
    p = _variables(jm, 8, jnp.asarray(z))["params"]
    (ref, state), vals = jax.jit(jd.record(lambda a: jm.apply(
        {"params": p}, a, train, rngs=_key(8), mutable=["losses"])))(
        jnp.asarray(z))
    tm = models.Decoder(8, 2, **kw)
    tm.load_state_dict(convert.decoder(p, 2, 1))
    replay = jd.replay(vals)
    got = tm(_t(z), train=train, noise=replay)
    assert got.shape == ((2, 1, 16, 16, 2) if multi_echo else (2, 16, 16, 2))
    assert len(vals) == (6 if bayes_layer and train else 0)
    assert replay.remaining == 0
    _close(got, ref, NET)
    np.testing.assert_allclose(float(models.kl_sum(tm).detach()),
                               float(_losses_sum(state)), rtol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_bayes_decoder_matches_jax(jd, train):
    z = _rand((2, 4, 4, 8), 9)
    kw = dict(filters=2, num_layers=2, num_res_blocks=1)
    jm = jvae.BayesDecoder(encoded_dims=8, **kw)
    p = _variables(jm, 9, jnp.asarray(z))["params"]

    # a JAX trainer's objective: an output term plus the sum of `losses`
    # (its gradient in train mode only)
    def j_obj(params):
        (out, st), vals = jd.record(lambda: jm.apply(
            {"params": params}, jnp.asarray(z), train, rngs=_key(9),
            mutable=["losses"]))()
        kl = _losses_sum(st)
        return jnp.sum(out * _weights(out.shape)) + kl, (out, kl, vals)

    if train:
        (_, (ref, kl, vals)), j_grads = jax.jit(jax.value_and_grad(
            j_obj, has_aux=True))(p)
    else:
        _, (ref, kl, vals) = jax.jit(j_obj)(p)
    # the stem and the towers' stems and heads sample in train mode only,
    # the towers' 8 Bayesian residual blocks always (2 Flipout convolutions
    # each); 3 draws a Flipout convolution
    assert len(vals) == 3 * (16 + (5 if train else 0))
    tm = models.BayesDecoder(8, **kw)
    tm.load_state_dict(convert.bayes_decoder(p, 2, 1))
    replay = jd.replay(vals)
    got = tm(_t(z), train=train, noise=replay)
    assert got.shape == (2, 1, 16, 16, 2) and replay.remaining == 0
    _close(got, ref, NET)
    np.testing.assert_allclose(float(models.kl_sum(tm).detach()), float(kl),
                               rtol=1e-5)
    if not train:
        return
    (torch.sum(_t(_weights(got.shape)) * got) + models.kl_sum(tm)).backward()
    _scaled({n: q.grad for n, q in tm.named_parameters()},
            {k: v.numpy()
             for k, v in convert.bayes_decoder(j_grads, 2, 1).items()})


# --------------------------------------------------------------------------
# the discriminators and the gradient penalty
# --------------------------------------------------------------------------

def test_critic_z_matches_jax():
    z = _rand((2, 8, 8, 12), 11)
    jm = jdisc.CriticZ(dim=16, n_downsamplings=2)
    p = _variables(jm, 11, jnp.asarray(z))["params"]
    tm = models.CriticZ(12, dim=16, n_downsamplings=2)
    tm.load_state_dict(convert.critic_z(p))
    got = tm(_t(z))
    assert got.shape == (2, 2, 2, 4)
    _close(got, jax.jit(jm.apply)({"params": p}, jnp.asarray(z)), NET)


@pytest.mark.parametrize("gen_mode,train", [(False, True), (True, True),
                                            (False, False)])
def test_sgan_and_flax_batch_norm_match_jax(gen_mode, train):
    x = _rand((2, 8, 8, 2), 12)
    jm = jdisc.SGAN(gen_mode=gen_mode, num_filters=4, num_layers=2)
    v = _variables(jm, 12, jnp.asarray(x))
    ref, new = jax.jit(lambda a: jm.apply(v, a, train, mutable=["batch_stats"]))(
        jnp.asarray(x))
    tm = models.SGAN(2, gen_mode=gen_mode, num_filters=4, num_layers=2)
    tm.load_state_dict(convert.sgan(v["params"], v["batch_stats"]))
    got = tm(_t(x), train=train)
    for g, r in zip(got if not gen_mode else [got],
                    ref if not gen_mode else [ref]):
        _close(g, r, NET)
    # the running statistics after the step (unchanged out of train mode)
    stats = new["batch_stats"] if train else v["batch_stats"]
    for i, norm in enumerate(tm.norms):
        _close(norm.running_mean, stats[f"BatchNorm_{i}"]["mean"])
        _close(norm.running_var, stats[f"BatchNorm_{i}"]["var"])
    # torch's own batch norm (momentum 0.01 for Flax's 0.99) moves the
    # running mean alike and the running variance otherwise (unbiased)
    if train:
        h = torch.randn(2, 4, 3, 3, generator=torch.Generator().manual_seed(0))
        bn, fb = torch.nn.BatchNorm2d(4, momentum=0.01), models.FlaxBatchNorm(4)
        bn(h)
        fb(h)
        assert torch.allclose(bn.running_mean, fb.running_mean)
        assert not torch.allclose(bn.running_var, fb.running_var, rtol=1e-4)


def test_patchgan_kernel_sizes_and_groups_match_jax():
    x = _rand((2, 32, 32, 2), 13, 0.5)
    jm = jdisc.PatchGAN(dim=4, n_downsamplings=2, in_kernel=3, n_kernel=5)
    v = _variables(jm, 13, jnp.asarray(x))
    ref, new = jax.jit(lambda a: jm.apply(v, a, train=True,
                                          mutable=["batch_stats"]))(
        jnp.asarray(x))
    tm = models.PatchGAN(2, dim=4, n_downsamplings=2, in_kernel=3,
                         n_kernel=5)
    tm.load_state_dict(convert.patchgan(v["params"], v["batch_stats"]))
    assert [tuple(c.conv.weight.shape[-2:]) for c in tm.convs] == \
        [(3, 3), (5, 5), (5, 5), (5, 5)]
    _close(tm(_t(x), update_stats=True), ref, NET)
    for i, c in enumerate(tm.convs):
        _close(c.u, new["batch_stats"][f"SpectralNorm_{i}"][
            f"Conv_{i}/kernel/u"])
    # groups apply to every convolution, the one-channel logit map too:
    # neither package builds a grouped PatchGAN
    with pytest.raises(ValueError):
        jax.eval_shape(lambda: jdisc.PatchGAN(dim=4, n_groups=2).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2))))
    with pytest.raises(ValueError):
        models.PatchGAN(2, dim=4, n_groups=2)


@pytest.mark.parametrize("mode", ["none", "wgan-gp", "dragan"])
def test_gradient_penalty_matches_jax(jd, mode):
    real, fake = _rand((2, 16, 16, 2), 14, 0.5), _rand((2, 16, 16, 2), 15,
                                                        0.5)
    jm = jdisc.PatchGAN(dim=4, n_downsamplings=2)
    v = _variables(jm, 14, jnp.asarray(real))

    def j_gp(params):
        def critic(img):
            return jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, img,
                            train=False)
        gp, vals = jd.record(jlosses.gradient_penalty)(
            critic, jnp.asarray(real), jnp.asarray(fake), mode,
            jax.random.PRNGKey(16))
        return gp, vals

    (ref, vals), j_grads = jax.jit(jax.value_and_grad(j_gp, has_aux=True))(
        v["params"])
    assert jd.kinds == {"none": [], "wgan-gp": ["uniform"],
                        "dragan": ["uniform", "uniform"]}[mode]
    tm = models.PatchGAN(2, dim=4, n_downsamplings=2)
    tm.load_state_dict(convert.patchgan(v["params"], v["batch_stats"]))
    replay = jd.replay(vals)
    got = losses.gradient_penalty(lambda img: tm(img, update_stats=False),
                                  _t(real), _t(fake), mode, replay)
    assert replay.remaining == 0
    _close(got, ref, NET)
    if mode == "none":
        return
    # the penalty trains the critic: a double backward, as JAX's grad of
    # the penalty
    got.backward()
    j_grads = convert.patchgan(j_grads)
    _scaled({n: q.grad for n, q in tm.named_parameters()},
            {k: x.numpy() for k, x in j_grads.items()})
    with pytest.raises(ValueError, match="gp mode"):
        losses.gradient_penalty(tm, _t(real), _t(fake), "r1",
                                torch.Generator())


# --------------------------------------------------------------------------
# the complex layers
# --------------------------------------------------------------------------

def test_complex_activations_match_jax():
    z = _crand((2, 5, 5, 3), 17)
    z[0, 0, 0] = 0.0
    bias = _rand((3,), 18, 0.5)
    tz = torch.from_numpy(z)
    for name in ("crelu", "zrelu", "cardioid"):
        _close(getattr(models, name)(tz), getattr(jcx, name)(jnp.asarray(z)),
               1e-6)
    _close(models.modrelu(tz, _t(bias)), jcx.modrelu(jnp.asarray(z),
                                                     jnp.asarray(bias)), 1e-6)


def test_complex_max_pool_matches_jax_and_first_maximum_wins():
    z = _crand((2, 6, 8, 3), 19)
    # ties of |z| = 5: the first in the window's (dx, dy) order wins, the
    # left column's lower value before the right column's upper one
    z[0, 0:2, 0:2, 0] = [[0.5 + 0.0j, 3.0 + 4.0j], [5.0 + 0.0j, -5.0j]]
    z[0, 0:2, 2:4, 0] = [[5.0j, -5.0 + 0.0j], [0.5 + 0.0j, 3.0 + 4.0j]]
    ref = np.asarray(jcx.complex_max_pool_2x2(jnp.asarray(z)))
    got = models.complex_max_pool_2x2(
        torch.from_numpy(z).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got[0, 0, 0, 0] == ref[0, 0, 0, 0] == 5.0 + 0.0j
    assert got[0, 0, 1, 0] == ref[0, 0, 1, 0] == 5.0j
    np.testing.assert_array_equal(got, ref)


def test_complex_conv_transpose_and_batch_norm_match_jax():
    z = _crand((2, 8, 8, 3), 20)
    zt = torch.from_numpy(z).permute(0, 3, 1, 2)
    jc = jcx.ComplexConv(4, activation="modrelu")
    pc = _variables(jc, 20, jnp.asarray(z))["params"]
    tc = models.ComplexConv(3, 4, activation="modrelu")
    tc.load_state_dict(convert._complex_conv(pc, ""))
    _close(tc(zt).permute(0, 2, 3, 1), jc.apply({"params": pc},
                                                jnp.asarray(z)))
    jt = jcx.ComplexConvTranspose(5)
    pt = _variables(jt, 21, jnp.asarray(z))["params"]
    tt = models.ComplexConvTranspose(3, 5)
    tt.load_state_dict({f"{w}.{k}": (convert.conv_transpose_kernel(
        pt[w]["kernel"]) if k == "weight" else _t(pt[w]["bias"]))
        for w in ("w_real", "w_imag") for k in ("weight", "bias")})
    _close(tt(zt).permute(0, 2, 3, 1), jt.apply({"params": pt},
                                                jnp.asarray(z)))
    # the batch norm: Flax's initial statistics, a train step's output and
    # statistics, then eval on them
    jb = jcx.ComplexBatchNorm()
    init = jax.eval_shape(lambda: jb.init(jax.random.PRNGKey(0),
                                          jnp.asarray(z)))
    tb = models.ComplexBatchNorm(3)
    assert set(init["batch_stats"]) == set(dict(tb.named_buffers()))
    vb = _variables(jb, 22, jnp.asarray(z))
    tb.load_state_dict({**{k: _t(x) for k, x in vb["params"].items()},
                        **{k: _t(x) for k, x in vb["batch_stats"].items()}})
    ref, new = jb.apply(vb, jnp.asarray(z), True, mutable=["batch_stats"])
    _close(tb(zt, train=True).permute(0, 2, 3, 1), ref)
    for k, x in new["batch_stats"].items():
        _close(getattr(tb, k), x)
    ref_eval = jb.apply({"params": vb["params"], **new}, jnp.asarray(z),
                        False)
    _close(tb(zt, train=False).permute(0, 2, 3, 1), ref_eval)


@pytest.mark.parametrize("train", [True, False])
def test_pm_complex_matches_jax(train):
    z = _crand((2, 16, 16, 3), 23)
    jm = jcx.PMComplex(filters=4, num_layers=2)
    v = _variables(jm, 23, jnp.asarray(z))
    ref, new = jax.jit(lambda a: jm.apply(v, a, train, mutable=["batch_stats"]))(
        jnp.asarray(z))
    tm = models.PMComplex(3, filters=4, num_layers=2)
    tm.load_state_dict(convert.pm_complex(v["params"], v["batch_stats"], 2))
    got = tm(torch.from_numpy(z), train=train)
    assert got.dtype == torch.complex64 and got.shape == (2, 16, 16, 1)
    _close(got, ref, NET)
    stats = convert.pm_complex(v["params"], new["batch_stats"], 2)
    for name, buf in tm.named_buffers():
        _close(buf, stats[name])


# --------------------------------------------------------------------------
# the InceptionV3 features
# --------------------------------------------------------------------------

def _inception_variables():
    jm = jinc.InceptionV3Features()
    return jm, _variables(jm, 24, jnp.zeros((1, 75, 75, 3)))


def test_inception_features_match_jax():
    jm, v = _inception_variables()
    x = np.tanh(_rand((1, 75, 75, 3), 25))
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm = inception.InceptionV3Features()
    tm.load_state_dict(convert.inception_v3(v))
    with torch.no_grad():
        got = tm(_t(x))
    assert got.shape == (1, 2048) and ref.shape == (1, 2048)
    _scaled({"f": got}, {"f": ref})


def test_echoes_to_inception_input_matches_jax():
    x = _rand((1, 2, 20, 20, 2), 26, 0.5)
    ref = jinc.echoes_to_inception_input(jnp.asarray(x), size=75)
    got = inception.echoes_to_inception_input(_t(x), size=75)
    assert got.shape == (2, 75, 75, 3)
    _close(got, ref)


def test_init_inception_v3_random_or_npz(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(inception, "weights_path", lambda name: None)
    with caplog.at_level("WARNING"):
        model = inception.init_inception_v3()
    assert "RANDOM init" in caplog.text
    assert not any(q.requires_grad for q in model.parameters())
    again = inception.init_inception_v3()
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    # converted weights from an npz of "/"-joined Flax paths
    _, v = _inception_variables()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(v["params"])}
    np.savez(tmp_path / "inception_v3.npz", **flat)
    monkeypatch.setattr(inception, "weights_path",
                        lambda name: str(tmp_path / name))
    loaded = inception.init_inception_v3()
    want = convert.inception_v3(v)
    assert all(torch.equal(loaded.state_dict()[k], want[k]) for k in want)
