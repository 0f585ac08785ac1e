"""The PI-VAE/GAN trainer of the port vs the JAX package.

Module checks, each on numpy inputs from a seed with the Flax module's
weights (random, every leaf perturbed) carried across by
`ideal_gan_tpu_torch.convert`:
- Flax "SAME" padding (`models.SameConv2d`) against `flax.linen.Conv` for
  2×2 stride 1, 3×3 stride 2, 4×4 stride 2 and 4×4 stride 1 at even sizes;
  torch's `padding=k//2` is shown to disagree on each;
- the residual block, the interpolating upsample, the encoder (both heads)
  and the decoder; the vector quantizer (indices and perplexity exact);
  the Fourier layer;
- the PatchGAN with Flax's spectral norm: the logits, and u and σ after an
  updating call; a call without updating runs the power step all the same
  and writes nothing; torch's `spectral_norm` is shown to disagree;
- the five adversarial losses and the R1 penalty; the replay pool (exact);
  the phase-offset augmentation (at JAX's offset);
- the VGG19 trunk, the perceptual loss, the covariance map, and `resize_to`
  against `jax.image.resize(..., "lanczos3", antialias=True)` at 32→224 and
  192→224 (torch's antialiased bicubic is shown to disagree).

Step parity at the JAX suite's tiny config (tests/test_train_gan_ldm.py:
F=12, 2 levels, 1 residual block, encoded 12, D=8, 32², batch 2): one
g-step (JAX's latent noise passed in) in three modes, one JAX compile
each: pixel cycle ("pix"); VQ with the cGAN adversary and the VGG
perceptual cycle ("vq_cgan_vgg"; the VGG input resized to 48² in both
packages, so that the trunk stays small); and bf16; and one d-step on
JAX's generated echoes with the plain PatchGAN ("pix") and the cGAN one
("vq_cgan_vgg"). The weights are random values on the shapes of JAX's
`init_state` (traced, not run: the eager Flax init takes a minute). JAX's
gradients are read from its Adam state after the step (μ = (1 − β1)·g with
β1 = 0.5, exact in float32). The JAX runs are shared through a
module-level cache; torch runs on one thread.

Tolerances: module forwards 1e-4 of scale (float32, sums in other orders);
losses and metrics 2e-5 relative to max(|JAX|, 1); every gradient leaf
2e-2 of the global gradient scale (MODEL_PARITY.json `tolerances`); u and
σ after the d-step 1e-5; `resize_to` 2e-5 of scale from JAX and 1e-6
from the float64 resize (its docstring says why); the VQ indices and the
module's perplexity exact (the step's is a metric: other exp and log
implementations, 2e-5 relative like the others); the bf16 step by
`tests/test_torch_bf16.py`'s resolved-leaves rule and the loss and
bf16-applied rules of `test_bf16_g_step_within_gate`, with three controls.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu.data import ItemPool as JItemPool  # noqa: E402
from ideal_gan_tpu.data import random_phase_offset as j_phase_offset  # noqa: E402
from ideal_gan_tpu.eval import metrics as jmetrics  # noqa: E402
from ideal_gan_tpu.losses import adversarial_losses as j_adv  # noqa: E402
from ideal_gan_tpu.losses import r1_regularization as j_r1  # noqa: E402
from ideal_gan_tpu.models import blocks as jblocks  # noqa: E402
from ideal_gan_tpu.models import discriminator as jdisc  # noqa: E402
from ideal_gan_tpu.models import fourier as jfourier  # noqa: E402
from ideal_gan_tpu.models import vae as jvae  # noqa: E402
from ideal_gan_tpu.models import vq as jvq  # noqa: E402
from ideal_gan_tpu.train import gan as jgan  # noqa: E402
from ideal_gan_tpu_torch import convert, data, losses, models  # noqa: E402
from ideal_gan_tpu_torch.eval import metrics as tmetrics  # noqa: E402
from ideal_gan_tpu_torch.train import gan as tgan  # noqa: E402

from test_torch_bf16 import LEAF_TOL, MIN_RESOLVED, _resolved  # noqa: E402
from test_torch_models import flax_params, nchw, nhwc  # noqa: E402
from test_train_gan_ldm import mag_phase_batch, tiny_cfg  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

FWD, LOSS, GRAD, STATS = 1e-4, 2e-5, 2e-2, 1e-5
VGG_SIZE = 48
BF16_LOSS_ULPS, BF16_APPLIED = 1.0, 100.0


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _close(got, ref, tol=FWD):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-12), err


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,pad", [(2, 1, (0, 1)), (3, 2, (0, 1)),
                                          (4, 2, (1, 1)), (4, 1, (1, 2))])
def test_same_conv_pads_as_flax(k, stride, pad):
    assert models.same_padding(16, k, stride) == pad
    x = _rand((2, 16, 16, 3), k + stride)
    conv = fnn.Conv(5, (k, k), strides=stride)
    p = flax_params(conv, jnp.asarray(x), 3)
    ref = np.asarray(conv.apply({"params": p}, jnp.asarray(x)))
    port = models.SameConv2d(3, 5, k, stride=stride)
    port.load_state_dict(convert._conv(p, ""))
    with torch.no_grad():
        _close(nhwc(port(nchw(x))), ref, 1e-5)
        # torch's symmetric k//2 padding is not Flax's SAME here
        plain = torch.nn.Conv2d(3, 5, k, stride=stride, padding=k // 2)
        plain.load_state_dict(port.state_dict())
        out = nhwc(plain(nchw(x)))
    assert out.shape != ref.shape or np.abs(out - ref).max() > 1e-2


def test_residual_block_and_upsample():
    x = _rand((2, 8, 8, 6), 1)
    blk = jblocks.ResidualBlock()
    p = flax_params(blk, jnp.asarray(x), 4)
    ref = np.asarray(blk.apply({"params": p}, jnp.asarray(x)))
    port = models.ResidualBlock(6)
    port.load_state_dict(convert.conv_block(p, ""))
    up = jblocks.Upsample(4, method="interpol_conv")
    pu = flax_params(up, jnp.asarray(x), 5)
    ref_up = np.asarray(up.apply({"params": pu}, jnp.asarray(x)))
    port_up = models.Upsample(6, 4, method="interpol_conv")
    port_up.load_state_dict(convert._conv(pu["Conv_0"], "conv."))
    with torch.no_grad():
        _close(nhwc(port(nchw(x))), ref, 1e-5)
        _close(nhwc(port_up(nchw(x))), ref_up, 1e-5)


# --------------------------------------------------------------------------
# encoder, decoder, VQ, Fourier
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sd_out", [True, False])
def test_encoder(sd_out):
    x = _rand((2, 4, 16, 16, 2), 6, 0.5)
    enc = jvae.Encoder(encoded_dims=6, filters=4, num_layers=2,
                       num_res_blocks=1, sd_out=sd_out, ls_mean_activ="None")
    p = flax_params(enc, jnp.asarray(x), 7)
    ref = jax.jit(enc.apply)({"params": p}, jnp.asarray(x))
    port = models.Encoder(2, 6, filters=4, num_layers=2, num_res_blocks=1,
                          sd_out=sd_out)
    port.load_state_dict(convert.encoder(p, 2, 1))
    with torch.no_grad():
        out = port(_t(x))
    if sd_out:
        _close(out.loc, ref.loc)
        _close(out.scale, ref.scale)
    else:
        _close(out, ref)


def test_decoder():
    z = _rand((2, 4, 4, 5), 8)
    dec = jvae.Decoder(encoded_dims=5, n_out=2, filters=3, num_layers=2,
                       num_res_blocks=1, output_activation="none")
    p = flax_params(dec, jnp.asarray(z), 9)
    ref = jax.jit(dec.apply)({"params": p}, jnp.asarray(z))
    port = models.Decoder(5, 2, filters=3, num_layers=2, num_res_blocks=1,
                          output_activation="none")
    port.load_state_dict(convert.decoder(p, 2, 1))
    with torch.no_grad():
        _close(port(_t(z)), ref)


def test_vector_quantizer_indices_and_perplexity_exact():
    x = _rand((2, 4, 4, 6), 10)
    vq = jvq.VectorQuantizer(embedding_dim=6, num_embeddings=8,
                             commitment_cost=0.5)
    p = jax.jit(vq.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    out, aux = vq.apply({"params": p}, jnp.asarray(x),
                        mutable=["losses", "metrics"])
    idx = vq.apply({"params": p}, jnp.asarray(x),
                   method=jvq.VectorQuantizer.quantize_indices)
    port = models.VectorQuantizer(6, 8, 0.5)
    port.load_state_dict(convert.vq(p))
    got, loss, perp = port(_t(x))
    assert np.array_equal(port.quantize_indices(_t(x)).numpy(),
                          np.asarray(idx))
    assert float(perp) == float(aux["metrics"]["perplexity"][0])
    _close(got, out)
    assert abs(float(loss) - float(aux["losses"]["vq_loss"][0])) <= \
        LOSS * max(abs(float(aux["losses"]["vq_loss"][0])), 1.0)


def test_fourier_layer():
    x = _rand((2, 3, 8, 8, 2), 11)
    _close(models.fourier_layer(_t(x)),
           jfourier.fourier_layer(jnp.asarray(x)), 1e-5)


# --------------------------------------------------------------------------
# the discriminator and its losses
# --------------------------------------------------------------------------

def _patchgan(cgan=False, seed=12):
    x = _rand((2, 3, 16, 16, 2), seed, 0.5)
    extra = (jnp.asarray(x),) if cgan else ()
    disc = jdisc.PatchGAN(dim=4, cgan=cgan, multi_echo=True)
    variables = jax.jit(disc.init)(jax.random.PRNGKey(seed), jnp.asarray(x),
                                   *extra)
    p = flax_params(disc, jnp.asarray(x), seed, extra=extra)
    port = models.PatchGAN(2, dim=4, cgan=cgan, multi_echo=True)
    port.load_state_dict(convert.patchgan(p, variables["batch_stats"]))
    return x, disc, p, variables["batch_stats"], port


@pytest.mark.parametrize("cgan", [False, True])
def test_patchgan_flax_spectral_norm(cgan):
    x, disc, p, stats, port = _patchgan(cgan)
    x2 = (jnp.asarray(x[:, ::-1]),) if cgan else ()
    t2 = (_t(x[:, ::-1]),) if cgan else ()
    apply = jax.jit(disc.apply, static_argnames=("train", "mutable"))
    ref, mut = apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                     *x2, train=True, mutable=("batch_stats",))
    ref_eval = apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                     *x2, train=False)
    u0 = {k: v.clone() for k, v in port.stats().items()}
    with torch.no_grad():
        # no update: the power step runs (so the logits are the updating
        # call's), nothing is written
        _close(port(_t(x), *t2, update_stats=False), ref_eval)
        assert all(torch.equal(u0[k], v) for k, v in port.stats().items())
        _close(port(_t(x), *t2, update_stats=True), ref)
    new = mut["batch_stats"]
    for i, c in enumerate(port.convs):
        node = new[f"SpectralNorm_{i}"]
        _close(c.u, node[f"Conv_{i}/kernel/u"], STATS)
        _close(c.sigma, node[f"Conv_{i}/kernel/sigma"], STATS)
    # torch's own spectral norm (no power step in eval, (out, in·kh·kw)
    # layout, max(‖x‖, ε)) gives other logits from the same weights and u
    sn = models.PatchGAN(2, dim=4, cgan=cgan, multi_echo=True)
    sn.load_state_dict(convert.patchgan(p, stats))
    for c in sn.convs:
        torch.nn.utils.spectral_norm(c.conv)
        c.conv.weight_u.data.copy_(c.u[0])
    sn.eval()
    with torch.no_grad():
        h = torch.cat([_t(x), *t2], -1) if cgan else _t(x)
        h = h.reshape(-1, 16, 16, h.shape[-1]).permute(0, 3, 1, 2)
        leaky = models.get_activation("leaky_relu")
        h = leaky(sn.convs[0].conv(h))
        for i, norm in enumerate(sn.norms, start=1):
            h = leaky(norm(sn.convs[i].conv(h)))
        h = sn.convs[-1].conv(sn.attn(h))
    out = h.permute(0, 2, 3, 1).numpy()
    assert np.abs(out - np.asarray(ref_eval)).max() > 1e-3 * np.abs(
        np.asarray(ref_eval)).max()


@pytest.mark.parametrize("mode", ["gan", "hinge_v1", "hinge_v2", "lsgan",
                                  "wgan"])
def test_adversarial_losses(mode):
    r, f = _rand((2, 3, 3, 1), 13), _rand((2, 3, 3, 1), 14)
    jd, jg = j_adv(mode)
    td, tg = losses.adversarial_losses(mode)
    for a, b in zip(td(_t(r), _t(f)), jd(jnp.asarray(r), jnp.asarray(f))):
        assert abs(float(a) - float(b)) <= LOSS * max(abs(float(b)), 1.0)
    assert abs(float(tg(_t(f))) - float(jg(jnp.asarray(f)))) <= LOSS


def test_r1_regularization_double_backward():
    """R1 of the PatchGAN critic and its gradient with respect to the
    critic's parameters (the double backward)."""
    x, disc, p, stats, port = _patchgan()

    def j_loss(params):
        def critic(v):
            return disc.apply({"params": params, "batch_stats": stats}, v,
                              train=False)
        return j_r1(critic, jnp.asarray(x))

    val, grads = jax.jit(jax.value_and_grad(j_loss))(p)
    r1 = losses.r1_regularization(
        lambda v: port(v, update_stats=False), _t(x))
    r1.backward()
    assert abs(float(r1) - float(val)) <= LOSS * float(val)
    ref = convert.patchgan(jax.tree_util.tree_map(np.asarray, grads))
    # the logit conv's bias does not reach ∇ₓD: no gradient (JAX's zero)
    got = {n: torch.zeros_like(q) if q.grad is None else q.grad
           for n, q in port.named_parameters()}
    assert got["convs.4.conv.bias"].abs().max() == 0
    scale = max(float(v.abs().max()) for v in ref.values())
    worst = max(float((got[k] - v).abs().max()) for k, v in ref.items())
    assert worst <= GRAD * scale, worst


# --------------------------------------------------------------------------
# pool, augmentation, VGG and resize
# --------------------------------------------------------------------------

def test_item_pool_matches_jax():
    jp, tp = JItemPool(3, seed=5), data.ItemPool(3, seed=5)
    for i in range(6):
        batch = _rand((2, 2, 4, 4, 2), 20 + i)
        assert np.array_equal(tp(batch), jp(batch))
    assert np.array_equal(data.ItemPool(0)(batch), batch)


@pytest.mark.parametrize("unwrapped", [False, True])
def test_random_phase_offset_at_jax_offset(unwrapped):
    A, B, _ = mag_phase_batch(nb=2, h=8, w=8)
    B = B.copy()
    B[:, 1:, ..., 1] *= 20.0  # phases beyond ±π, so the wrap acts
    key = jax.random.PRNGKey(3)
    off = float(jax.random.uniform(key, (), minval=-np.pi / 2,
                                   maxval=np.pi / 2))
    ja, jb = jax.jit(j_phase_offset, static_argnames="unwrapped")(
        key, jnp.asarray(A), jnp.asarray(B), unwrapped=unwrapped)
    ta, tb = data.random_phase_offset(None, _t(A), _t(B),
                                      unwrapped=unwrapped, offset=off)
    _close(ta, ja, 1e-5)
    _close(tb, jb, 1e-5)
    gen = torch.Generator().manual_seed(0)
    ra, _ = data.random_phase_offset(gen, _t(A), _t(B))
    assert not torch.allclose(ra, _t(A))


def test_vgg_trunk_and_perceptual_loss():
    vgg = jmetrics.VGG19Features()
    x = _rand((2, 32, 32, 3), 15, 50.0)
    variables = jax.jit(vgg.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    port = tmetrics.VGG19Features()
    port.load_state_dict(convert.vgg19(variables))
    apply = jax.jit(vgg.apply)
    ref = apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_t(x))
        for g, r in zip(got, ref):
            _close(nhwc(g), r)
        y = _rand((1, 2, 16, 16, 2), 16, 0.5)
        inp = tmetrics.echoes_to_vgg_input(_t(y), size=32)
        _close(inp, jmetrics.echoes_to_vgg_input(jnp.asarray(y), size=32),
               1e-5)
        fb = port(inp)
    ref_b = apply(variables, jmetrics.echoes_to_vgg_input(
        jnp.asarray(y), size=32))
    loss = float(tmetrics.perceptual_cosine_loss(got, fb))
    want = float(jmetrics.perceptual_cosine_loss(ref, ref_b))
    assert abs(loss - want) <= LOSS * max(abs(want), 1.0)
    z = _rand((3, 2, 2, 3), 17)
    _close(tmetrics.covariance_map(_t(z)),
           jmetrics.covariance_map(jnp.asarray(z)), 1e-5)
    assert tmetrics.feature_source() == jmetrics.feature_source()


def _lanczos3_f64(n_in, n_out):
    """The textbook antialiased Lanczos-3 resize along one axis in float64:
    output o samples the input at (o + ½)·n_in/n_out − ½, with the kernel
    sinc(x)·sinc(x/3) on |x| < 3 stretched by max(n_in/n_out, 1), each
    output's weights normalized to sum to 1."""
    s = max(n_in / n_out, 1.0)
    c = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    d = (c[None, :] - np.arange(n_in)[:, None]) / s
    w = np.where(np.abs(d) < 3, np.sinc(d) * np.sinc(d / 3), 0.0)
    return w / w.sum(axis=0, keepdims=True)


@pytest.mark.parametrize("size_in", [32, 192])
def test_resize_to_matches_jax_lanczos3(size_in):
    """Against `jax.image.resize` within 2e-5 of scale, and against the
    float64 resize within 1e-6: JAX's float32 weights lie up to 1.1e-5
    from the exact ones, which puts its 192→224 output 1.4e-5 of scale from
    float64, while the port's weights are built in float64."""
    x = _rand((2, size_in, size_in, 2), size_in)
    ref = np.asarray(jmetrics.resize_to(jnp.asarray(x), 224))
    w = _lanczos3_f64(size_in, 224)
    exact = np.einsum("nhwc,ho,wp->nopc", x.astype(np.float64), w, w,
                      optimize=True)
    got = tmetrics.resize_to(_t(x), 224)
    _close(got, ref, 2e-5)
    _close(got, exact, 1e-6)
    # torch's antialiased bicubic is another resize
    bic = torch.nn.functional.interpolate(
        nchw(x), size=(224, 224), mode="bicubic", antialias=True,
        align_corners=False)
    assert np.abs(nhwc(bic) - ref).max() > 1e-2 * np.abs(ref).max()


# --------------------------------------------------------------------------
# the trainer's configuration
# --------------------------------------------------------------------------

def test_filter_list_and_encoded_size():
    cfg = tiny_cfg(n_G_filt_list="12,16,24")
    assert tgan.parse_filt_list(cfg) == jgan.parse_filt_list(cfg)
    m = tgan.build_models(cfg)
    assert m.enc.down[1].out_channels == 24
    assert m.dec_mag.up[0].conv.out_channels == 5
    assert m.dec_ff.head.in_channels == 3
    with pytest.raises(ValueError, match="divisible by 3"):
        tgan.build_models(tiny_cfg(encoded_size=256))
    with pytest.raises(ValueError, match="n_downsamplings"):
        tgan.build_models(tiny_cfg(n_G_filt_list="12,16"))


# --------------------------------------------------------------------------
# step parity
# --------------------------------------------------------------------------

MODES = {
    "pix": dict(),
    "vq_cgan_vgg": dict(VQ_encoder=True, VQ_num_embed=8, adv_train=True,
                        cGAN=True, A_loss="VGG"),
    "bf16": dict(bf16=True),
}
_JAX = {}


def _grad_tree(opt_state, beta_1):
    """The gradient of a one-step optax Adam state: μ / (1 − β1)."""
    mu = opt_state[0].mu
    return jax.tree_util.tree_map(
        lambda m: np.asarray(m, np.float32) / (1.0 - beta_1), mu)


def _fill(tree, seed):
    """Random values for a tree of shapes (JAX's init, traced only: an
    eager Flax init of these nets takes a minute): kernels N(0, 1/fan_in),
    the decoders' heads a tenth of that, so that the decoded maps stay in
    the range of real ones (at He scale the phase rows reach ±6, i.e. 4π·6
    rad in the synthesis, which turns the encoder's float32 rounding, 6e-6
    of scale in both packages, into 1e-4 of the loss, and bf16's into the
    whole gradient), biases 0.05·N(0, 1), norm scales 1 + 0.1·N(0, 1), γ
    0.7, the codebook U(±√(3/D)), the spectral norm's u N(0, 1) and σ 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = jax.tree_util.keystr(path), sds.shape
        if name.endswith("/u']"):
            v = rng.normal(size=shape)
        elif name.endswith("/sigma']"):
            v = np.ones(shape)
        elif "gamma" in name:
            v = np.full(shape, 0.7)
        elif "codebook" in name:
            b = (3.0 / shape[0]) ** 0.5
            v = rng.uniform(-b, b, shape)
        elif "scale" in name:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2:
            v = rng.normal(size=shape) / np.prod(shape[:-1]) ** 0.5
            if "dec_" in name and "Conv_2" in name:
                v = 0.1 * v
        else:
            v = 0.05 * rng.normal(size=shape)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _jax_run(mode):
    """JAX's g-step (and d-step with the adversary) in `mode`: loss,
    metrics, gradients, the generated echoes and the noise, the d-step's
    metrics, gradients and statistics, and the initial weights. Modes that
    differ only in dtype draw the same weights."""
    if mode in _JAX:
        return _JAX[mode]
    cfg = tiny_cfg(**MODES[mode])
    models_j = jgan.build_models(cfg)
    vgg = None
    if cfg["A_loss"] == "VGG":
        vgg = jgan.init_vgg19()
    A, B, te = mag_phase_batch()
    A = A + (1e-3 * np.random.default_rng(3).normal(size=A.shape)).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgan, "echoes_to_vgg_input", lambda x: jmetrics
                   .echoes_to_vgg_input(x, size=VGG_SIZE))
        g_step, d_step, txs = jgan.make_train_steps(cfg, models_j, vgg)
        shapes = jax.eval_shape(
            lambda k, a: jgan.init_state(cfg, models_j, txs, k, a),
            jax.random.PRNGKey(0), A)
        params_g = _fill(shapes.params_g, 1)
        params_d = _fill(shapes.params_d, 2)
        d_stats = _fill(shapes.d_stats, 3)
        state = jgan.GANState(params_g, txs[0].init(params_g), params_d,
                              d_stats, txs[1].init(params_d),
                              jnp.zeros((), jnp.int32))
        init = jax.tree_util.tree_map(np.asarray,
                                      (params_g, params_d, d_stats))
        key = jax.random.PRNGKey(5)
        h = 32 // 2 ** cfg["n_downsamplings"]
        eps = np.asarray(jax.random.normal(
            key, (2, h, h, cfg["encoded_size"])), np.float32)
        new, metrics, fake = g_step(state, (jnp.asarray(A), jnp.asarray(B),
                                            jnp.asarray(te)), key)
        out = dict(cfg=cfg, init=init, A=A, B=B, te=np.asarray(te), eps=eps,
                   vgg=None if vgg is None else jax.tree_util.tree_map(
                       np.asarray, vgg[1]),
                   loss=float(metrics["G_loss"]),
                   metrics={k: float(v) for k, v in metrics.items()},
                   grads=_grad_tree(new.opt_g, cfg["beta_1"]),
                   fake=np.asarray(fake))
        if cfg["VQ_encoder"]:
            enc, vq = models_j[0], models_j[5]

            def indices(p, a):
                return vq.apply({"params": p["vq"]},
                                enc.apply({"params": p["enc"]}, a),
                                method=type(vq).quantize_indices)

            out["vq_indices"] = np.asarray(jax.jit(indices)(
                params_g, jnp.asarray(A)))
        if not cfg["bf16"]:
            # the d-step (built whatever adv_train says) on the g-step's
            # echoes: the plain PatchGAN in "pix", the cGAN one in
            # "vq_cgan_vgg"
            new_d, d_metrics = d_step(new, jnp.asarray(A), fake)
            out.update(d_metrics={k: float(v) for k, v in d_metrics.items()},
                       d_grads=_grad_tree(new_d.opt_d, cfg["beta_1"]),
                       d_stats=jax.tree_util.tree_map(np.asarray,
                                                      new_d.d_stats))
    _JAX[mode] = out
    return out


def _port_models(run):
    cfg = run["cfg"]
    m = tgan.build_models(cfg)
    params_g, params_d, d_stats = run["init"]
    sds = convert.gan(params_g, params_d, d_stats, cfg["n_downsamplings"],
                      cfg["n_res_blocks"])
    for name, sd in sds.items():
        getattr(m, name).load_state_dict(sd)
    vgg = None
    if run["vgg"] is not None:
        vgg = tmetrics.VGG19Features().requires_grad_(False)
        vgg.load_state_dict(convert.vgg19(run["vgg"]))
    return m, vgg


def _port_vq_indices(run):
    m, _ = _port_models(run)
    with torch.no_grad():
        return m.vq.quantize_indices(m.enc(_t(run["A"]))).numpy()


def _port_g_step(run, monkeypatch):
    cfg = run["cfg"]
    monkeypatch.setattr(tgan, "echoes_to_vgg_input", lambda x: tmetrics
                        .echoes_to_vgg_input(x, size=VGG_SIZE))
    m, vgg = _port_models(run)
    m.disc.requires_grad_(False)
    loss, metrics, fake = tgan.make_g_loss_fn(cfg, m, vgg)(
        _t(run["A"]), _t(run["B"]), _t(run["te"]), _t(run["eps"]))
    loss.backward()
    grads = {name: {k: p.grad for k, p in getattr(m, name).named_parameters()
                    if p.grad is not None} for name in tgan.G_NETS}
    return m, float(loss), {k: float(v) for k, v in metrics.items()}, \
        grads, fake


def _ref_grads(run, grads=None):
    cfg = run["cfg"]
    g = run["grads"] if grads is None else grads
    return convert.gan(g, run["init"][1], None, cfg["n_downsamplings"],
                       cfg["n_res_blocks"])


def _assert_grads(got, ref):
    scale = max(float(v.abs().max()) for sd in ref.values()
                for v in sd.values())
    worst = 0.0
    for name, sd in ref.items():
        for k, v in sd.items():
            g = got[name].get(k)
            g = torch.zeros_like(v) if g is None else g
            worst = max(worst, float((g - v).abs().max()))
    assert worst <= GRAD * scale, (worst, scale)


def _assert_metrics(got, ref):
    for k, v in ref.items():
        assert abs(got[k] - v) <= LOSS * max(abs(v), 1.0), (k, got[k], v)


@pytest.mark.parametrize("mode", ["pix", "vq_cgan_vgg"])
def test_g_step_matches_jax(mode, monkeypatch):
    run = _jax_run(mode)
    _, loss, metrics, grads, fake = _port_g_step(run, monkeypatch)
    assert abs(loss - run["loss"]) <= LOSS * max(abs(run["loss"]), 1.0)
    _assert_metrics(metrics, run["metrics"])
    if mode == "vq_cgan_vgg":
        assert np.array_equal(_port_vq_indices(run), run["vq_indices"])
    ref = _ref_grads(run)
    del ref["disc"]
    _assert_grads(grads, ref)
    _close(fake, run["fake"])


@pytest.mark.parametrize("mode", ["pix", "vq_cgan_vgg"])
def test_d_step_matches_jax(mode):
    """The d-step on JAX's generated echoes: loss, metrics, every gradient
    leaf (the R1 double backward included), and u and σ after it."""
    run = _jax_run(mode)
    m, _ = _port_models(run)
    loss, metrics = tgan.make_d_loss_fn(run["cfg"], m.disc)(
        _t(run["A"]), _t(run["fake"]))
    loss.backward()
    _assert_metrics({k: float(v) for k, v in metrics.items()},
                    run["d_metrics"])
    ref = convert.patchgan(run["d_grads"])
    _assert_grads({"disc": {k: p.grad for k, p in m.disc.named_parameters()}},
                  {"disc": ref})
    for i, c in enumerate(m.disc.convs):
        node = run["d_stats"][f"SpectralNorm_{i}"]
        _close(c.u, node[f"Conv_{i}/kernel/u"], STATS)
        _close(c.sigma, node[f"Conv_{i}/kernel/sigma"], STATS)


def _flat(loss, grads, like):
    """(loss, {"net.leaf": gradient}) over the generator's leaves of `like`
    (a converted JAX gradient), a leaf without a port gradient as zero."""
    return loss, {f"{n}.{k}": np.asarray(
        (grads[n].get(k, torch.zeros_like(v)) if grads is not like else v)
        .detach(), np.float32)
        for n, sd in like.items() if n != "disc" for k, v in sd.items()}


def _bf16_failures(port, ref, port32, wit):
    """The rules of the bf16 gate (module docstring) that the port's bf16
    step `port` breaks against JAX's bf16 step `ref`, with the port's and
    JAX's float32 steps as witnesses; each run is (loss, {leaf: grad})."""
    out = []
    if abs(port[0] - ref[0]) > BF16_LOSS_ULPS * 2.0 ** -8 * abs(ref[0]):
        out.append("loss")
    resolved = _resolved(ref, wit)
    if len(resolved) < MIN_RESOLVED or any(
            np.abs(port[1][k] - ref[1][k]).max() > LEAF_TOL * s
            for k, s in resolved.items()):
        out.append("resolved leaves")
    scale = max(float(np.abs(v).max()) for v in wit[1].values())

    def dist(a, b):
        return max(float(np.abs(a[1][k] - b[1][k]).max())
                   for k in b[1]) / scale

    if dist(port, port32) < BF16_APPLIED * max(dist(port32, wit), 1e-12):
        out.append("bf16 applied")
    return out


def test_bf16_g_step_within_gate(monkeypatch):
    """The bf16 g-step (pixel cycle, no adversary) against JAX's bf16
    g-step, with the float32 steps of both ("pix": the same weights, batch
    and noise) as witnesses. test_torch_bf16's resolved-leaves rule holds
    as it is (43 of the leaves resolve here, the decoders'); its loss and
    bf16-applied references do not carry over to this net: JAX's bf16 moves
    the loss only 5.9e-7 from float32 because its two cycle terms move in
    opposite directions, and its head-bias gradients lie up to 0.48 of the
    gradient scale from float32 (bf16 sums over the image), where the
    port's lie 8e-4. So the loss is held to BF16_LOSS_ULPS bf16 ulps of
    JAX's bf16 loss, and bf16 is applied if the port's bf16 step lies at
    least BF16_APPLIED times farther from its own float32 step than that
    lies from JAX's. The controls must fail: the port's float32 step (bf16
    applied), its bf16 gradient zeroed and sign-flipped (resolved
    leaves)."""
    run, f32 = _jax_run("bf16"), _jax_run("pix")
    like = {n: sd for n, sd in _ref_grads(run).items() if n != "disc"}
    ref = _flat(run["loss"], like, like)
    wit_like = {n: sd for n, sd in _ref_grads(f32).items() if n != "disc"}
    wit = _flat(f32["loss"], wit_like, wit_like)
    _, loss, _, grads, fake = _port_g_step(run, monkeypatch)
    port = _flat(loss, grads, like)
    _, loss32, _, grads32, _ = _port_g_step(f32, monkeypatch)
    port32 = _flat(loss32, grads32, like)
    assert fake.dtype == torch.float32
    assert _bf16_failures(port, ref, port32, wit) == []
    zero = (port[0], {k: np.zeros_like(v) for k, v in port[1].items()})
    flip = (port[0], {k: -v for k, v in port[1].items()})
    for control in (port32, zero, flip):
        assert _bf16_failures(control, ref, port32, wit), \
            "a control passed the bf16 gate"
