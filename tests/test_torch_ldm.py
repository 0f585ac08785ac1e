"""The latent-diffusion (PI-LDM) family of the port vs the JAX package.

Inputs come from numpy seeds; Flax weights (random values on the shapes of
the Flax inits, traced with `jax.eval_shape`, not run) go across by
`ideal_gan_tpu_torch.convert`; random draws go across as values: JAX's
draws are rebuilt with its own key splitting (the step's `k1, k2 =
split(key)`, the samplers' `k0, kloop = split(key)`, `split(kloop, n)`) and
passed to the port's functions.

- Schedules: linear and cosine, bit for bit.
- Blocks: the sinusoidal embedding, the channel LayerNorm, ResnetBlock
  (with and without the time FiLM and the 1×1 projection), LinearAttention,
  Attention, ClassConditioning; `ConvTranspose(4, 4, stride 2, "SAME")`
  against `flax.linen.ConvTranspose`, which the unflipped kernel fails.
- `DenoiseUNet` at the JAX suite's tiny config (tests/test_train_gan_ldm.py:
  T=8, F=8, dim_mults (1, 2), in_res 8, 6 channels), without and with
  class conditioning, and once at full width (F=64, (1, 2, 4), in_res 12,
  258 channels, batch 1); without classes the planes are silu(bias), and a
  denoiser without them fails.
- Diffusion: `forward_noise`, the DDPM and DDIM reverse steps (the DDIM one
  with the reference's α at t − 1, which the ᾱ form fails) and both chains
  (`train.ldm.sample_latents`) against JAX's on JAX's draws.
- Training: the ε-MSE step's loss and every gradient leaf against JAX's
  jitted step at its (t, noise) (gradients read from its one-step Adam
  state: μ = (1 − β1)·g, β1 = 0.9), one Adam step against optax's on the
  same gradients, and `latent_std` against JAX's.
- Generation: `generate_dataset` with the GAN tests' tiny config
  (tests/test_train_gan_ldm.py::tiny_cfg), VAE and VQ.
- Metrics: FID, MMD, SSIM, and MS-SSIM at 176².
- The three CLIs end to end on a tiny `train_gan` run, with resume and
  preemption (`tests/test_torch_smoke_ldm.py` rehearses the chip phase).

Tolerances: forwards, chains and generated samples 1e-4 of scale (float32,
sums in other orders); losses 2e-5 relative to max(|JAX|, 1); gradient
leaves 2e-2 of the gradient scale (MODEL_PARITY.json `tolerances`); the
reverse steps and the metrics 1e-5 (of scale, or relative); the Adam step
1e-6 absolute (one float32 ulp of weights near 4). One JAX compile per
mode, shared through a module cache; torch runs on one thread.
"""

import os
import signal

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import diffusion as jdm  # noqa: E402
from ideal_gan_tpu.eval import metrics as jmetrics  # noqa: E402
from ideal_gan_tpu.models import ldm as jldm  # noqa: E402
from ideal_gan_tpu.train import gan as jgan  # noqa: E402
from ideal_gan_tpu.train import ldm as jl  # noqa: E402
from ideal_gan_tpu_torch import convert, diffusion  # noqa: E402
from ideal_gan_tpu_torch.eval import metrics as tmetrics  # noqa: E402
from ideal_gan_tpu_torch.models import ldm as tldm  # noqa: E402
from ideal_gan_tpu_torch.train import gan as tgan  # noqa: E402
from ideal_gan_tpu_torch.train import ldm as tl  # noqa: E402

from test_torch_gan import _fill as _fill_gan  # noqa: E402
from test_torch_models import nchw, nhwc  # noqa: E402
from test_train_gan_ldm import mag_phase_batch, tiny_cfg  # noqa: E402

FWD, LOSS, GRAD, STEP, ADAM = 1e-4, 2e-5, 2e-2, 1e-5, 1e-6
TINY = dict(n_timesteps=8, n_ldm_filters=8, dim_mults=(1, 2), in_res=8,
            epochs=2, infer_steps=4)
CH, NB = 6, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _close(got, ref, tol=FWD):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-12), err


def _fill(tree, seed):
    """Random values on a tree of shapes: kernels and embeddings N(0,
    1/fan_in), LayerNorm and GroupNorm scales 1 + 0.1·N(0, 1), biases
    0.05·N(0, 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = jax.tree_util.keystr(path), sds.shape
        if name.endswith(("['g']", "['scale']")):
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name.endswith(("['b']", "['bias']")):
            v = 0.05 * rng.normal(size=shape)
        else:
            v = rng.normal(size=shape) / np.prod(shape[:-1]) ** 0.5
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _flax(module, seed, *args):
    """(filled params of `module` at the call `args`, jitted apply)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return _fill(shapes["params"], seed), jax.jit(module.apply)


# --------------------------------------------------------------------------
# schedules and the blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,steps", [("linear", 8), ("linear", 200),
                                        ("cosine", 200)])
def test_schedules_bit_for_bit(kind, steps):
    j = getattr(jdm, f"{kind}_beta_schedule")(steps)
    t = getattr(diffusion, f"{kind}_beta_schedule")(steps)
    assert t.timesteps == j.timesteps == steps
    for a, b in zip(t, j):
        assert a.dtype == torch.float32
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_sinusoidal_embedding_layer_norm_and_class_plane():
    t = np.array([0, 3, 199], np.int32)
    _close(tldm.sinusoidal_pos_emb(torch.from_numpy(t), 64),
           jldm.sinusoidal_pos_emb(jnp.asarray(t), 64), 1e-6)
    x = _rand((2, 5, 5, 12), 1, 3.0)
    ln = jldm._LayerNorm()
    p, apply = _flax(ln, 2, x)
    port = tldm.LayerNorm(12)
    port.load_state_dict(convert._ldm_layer_norm(p, ""))
    _close(nhwc(port(nchw(x))), apply({"params": p}, x), 1e-5)
    emb = _rand((2, 16), 3)
    cc = jldm.ClassConditioning(6)
    p, apply = _flax(cc, 4, emb)
    port = tldm.ClassConditioning(16, 6)
    port.load_state_dict(convert._dense(p["Dense_0"], "dense."))
    _close(nhwc(port(_t(emb))), apply({"params": p}, emb), 1e-5)


@pytest.mark.parametrize("time_emb,cin", [(True, 8), (True, 12),
                                          (False, 12)])
def test_resnet_block(time_emb, cin):
    x, t = _rand((2, 6, 6, cin), 5), _rand((2, 32), 6)
    blk = jldm.ResnetBlock(8, groups=4)
    args = (x, t) if time_emb else (x,)
    p, apply = _flax(blk, 7, *args)
    port = tldm.ResnetBlock(cin, 8, 32 if time_emb else None, groups=4)
    port.load_state_dict(convert._resnet_block(p, ""))
    assert (port.res_conv is None) == (cin == 8)
    with torch.no_grad():
        out = port(nchw(x), _t(t) if time_emb else None)
    _close(nhwc(out), apply({"params": p}, *args))


@pytest.mark.parametrize("linear", [True, False])
def test_attentions(linear):
    x = _rand((2, 4, 6, 16), 8)
    mod = (jldm.LinearAttention if linear else jldm.Attention)(16)
    p, apply = _flax(mod, 9, x)
    port = (tldm.LinearAttention if linear else tldm.Attention)(16)
    port.load_state_dict(convert._attention(p, ""))
    with torch.no_grad():
        _close(nhwc(port(nchw(x))), apply({"params": p}, x))


def test_conv_transpose_flip():
    """`flax.linen.ConvTranspose(4, 4, stride 2, "SAME")` equals
    `conv_transpose2d(stride=2, padding=1)` on the flipped kernel (the
    converter's); the kernel as stored (the naive transpose) fails."""
    x = _rand((2, 3, 3, 5), 10)
    ct = fnn.ConvTranspose(4, (4, 4), strides=(2, 2))
    p, apply = _flax(ct, 11, x)
    ref = np.asarray(apply({"params": p}, x))
    port = torch.nn.ConvTranspose2d(5, 4, 4, stride=2, padding=1)
    port.load_state_dict({"weight": convert.conv_transpose_kernel(
        p["kernel"]), "bias": _t(p["bias"])})
    with torch.no_grad():
        _close(nhwc(port(nchw(x))), ref, 1e-5)
        naive = torch.nn.functional.conv_transpose2d(
            nchw(x), _t(np.transpose(p["kernel"], (2, 3, 0, 1))),
            _t(p["bias"]), stride=2, padding=1)
    assert np.abs(nhwc(naive) - ref).max() > 1e-2 * np.abs(ref).max()


# --------------------------------------------------------------------------
# the denoiser, the diffusion functions and the step (one JAX compile a
# mode)
# --------------------------------------------------------------------------

_JAX = {}


def _cfg(class_cond=False, **over):
    return dict(jl.DEFAULTS, **{**TINY, **over}, class_cond=class_cond)


def _keys(key, n):
    """The samplers' draws: x_init from k0, one z a step from
    split(kloop, n)."""
    k0, kloop = jax.random.split(key)
    shape = (NB, 8, 8, CH)
    return (np.asarray(jax.random.normal(k0, shape)),
            [np.asarray(jax.random.normal(k, shape))
             for k in jax.random.split(kloop, n)])


def _jax_run(class_cond):
    """JAX's train step at the tiny config (loss, gradients, the Adam step's
    params), the denoiser's forward at a fixed (x, t, labels), and, without
    classes, the DDPM and DDIM chains; all in one jitted program."""
    if class_cond in _JAX:
        return _JAX[class_cond]
    cfg = _cfg(class_cond)
    model = jl.build_model(cfg, CH)
    sched = jl.build_schedule(cfg)
    step, tx = jl.make_train_step(cfg, model, sched, None)
    shapes = jax.eval_shape(
        lambda k: jl.init_state(cfg, model, tx, k, (NB, 8, 8, CH)),
        jax.random.PRNGKey(0))
    params = _fill(shapes.params, 20 + class_cond)
    z = _rand((NB, 8, 8, CH), 21)
    x = _rand((NB, 8, 8, CH), 22)
    labels = np.array([1, 3], np.int32)
    tt = np.array([2, 7], np.int32)
    key, skey = jax.random.PRNGKey(5), jax.random.PRNGKey(6)

    def run(params, z, labels, x, tt):
        state = jl.LDMState(params, tx.init(params), jnp.zeros((), jnp.int32))
        new, metrics = step(state, (z, labels), key)
        out = dict(loss=metrics["loss"], new_params=new.params,
                   mu=new.opt_state[0].mu,
                   fwd=model.apply({"params": params}, x, tt, labels))
        if not class_cond:
            for method in ("ddpm", "ddim"):
                out[method] = jl.sample_latents(
                    cfg, model, params, sched, skey, NB, (8, 8), CH, 1.3,
                    method=method)
        return out

    out = jax.tree_util.tree_map(np.asarray, jax.jit(run)(
        params, z, labels, x, tt))
    k1, k2 = jax.random.split(key)
    t = np.asarray(jdm.sample_timesteps(k1, NB, cfg["n_timesteps"]))
    noise = np.asarray(jax.random.normal(k2, z.shape))
    out.update(cfg=cfg, params=params, z=z, x=x, labels=labels, tt=tt, t=t,
               noise=noise, ddpm_draws=_keys(skey, cfg["n_timesteps"]),
               ddim_draws=_keys(skey, cfg["infer_steps"]))
    _JAX[class_cond] = out
    return out


def _port_model(run, n_levels=2, channels=CH):
    cfg = run["cfg"]
    model = tl.build_model(cfg, channels)
    model.load_state_dict(convert.denoise_unet(run["params"], n_levels))
    return model


def _lt(a):
    return torch.from_numpy(np.array(a)).long()


@pytest.mark.parametrize("class_cond", [False, True])
def test_denoiser_forward(class_cond):
    run = _jax_run(class_cond)
    model = _port_model(run)
    assert (model.embed is None) != class_cond
    with torch.no_grad():
        _close(model(_t(run["x"]), _lt(run["tt"]), _lt(run["labels"])),
               run["fwd"])


def test_class_planes_without_classes(monkeypatch):
    """Without `num_classes` each level still concatenates silu(Dense(0)),
    the bias plane: the parameters are there, and a denoiser whose planes
    are zeros (no class conditioning at all) disagrees with Flax."""
    run = _jax_run(False)
    assert all(f"ClassConditioning_{i}" in run["params"] for i in range(4))
    model = _port_model(run)
    args = (_t(run["x"]), _lt(run["tt"]), _lt(run["labels"]))
    with torch.no_grad():
        _close(model(*args), run["fwd"])
        monkeypatch.setattr(tldm.ClassConditioning, "forward",
                            lambda self, emb: emb.new_zeros(
                                (emb.shape[0], 1, self.res, self.res)))
        naive = model(*args).numpy()
    assert np.abs(naive - run["fwd"]).max() > 1e-2 * np.abs(run["fwd"]).max()


def test_denoiser_forward_full_width():
    cfg = dict(jl.DEFAULTS, in_res=12)
    model = jl.build_model(cfg, 258)
    x = _rand((1, 12, 12, 258), 23)
    t, lab = np.array([137], np.int32), np.zeros((1,), np.int32)
    p, apply = _flax(model, 24, x, t, lab)
    ref = apply({"params": p}, x, t, lab)
    port = tl.build_model(cfg, 258)
    port.load_state_dict(convert.denoise_unet(p, 3))
    with torch.no_grad():
        _close(port(_t(x), _lt(t), _lt(lab)), ref)


def test_forward_noise_and_reverse_steps():
    sched_j = jdm.linear_beta_schedule(200)
    sched = diffusion.linear_beta_schedule(200)
    x, eps = _rand((3, 4, 4, 5), 30), _rand((3, 4, 4, 5), 31)
    t = np.array([0, 57, 199], np.int32)
    key = jax.random.PRNGKey(7)
    ref, noise = jdm.forward_noise(key, jnp.asarray(x), jnp.asarray(t),
                                   sched_j)
    got, _ = diffusion.forward_noise(_t(x), _lt(t), sched, _t(noise))
    _close(got, ref, STEP)
    z = np.asarray(jax.random.normal(key, x.shape))
    for step_t in (0, 1, 120, 199):
        _close(diffusion.ddpm_reverse_step(_t(x), _t(eps), step_t, sched,
                                           _t(z)),
               jdm.ddpm_reverse_step(key, jnp.asarray(x), jnp.asarray(eps),
                                     step_t, sched_j), STEP)
        for sigma in (0.0, 0.3):
            _close(diffusion.ddim_reverse_step(_t(x), _t(eps), step_t,
                                               sigma, sched, _t(z)),
                   jdm.ddim_reverse_step(key, jnp.asarray(x),
                                         jnp.asarray(eps), step_t, sigma,
                                         sched_j), STEP)
    t_b = diffusion.sample_timesteps(1000, 8, torch.Generator().manual_seed(0))
    assert t_b.dtype == torch.long and 0 <= int(t_b.min()) \
        and int(t_b.max()) == 7


def test_ddim_step_takes_alpha_not_alpha_bar():
    """The reference's DDIM step reads α at t − 1; the textbook step (ᾱ at
    t − 1) disagrees with JAX's."""
    sched_j = jdm.linear_beta_schedule(200)
    sched = diffusion.linear_beta_schedule(200)
    x, eps = _rand((2, 4, 4, 3), 32), _rand((2, 4, 4, 3), 33)
    key = jax.random.PRNGKey(8)
    ref = np.asarray(jdm.ddim_reverse_step(key, jnp.asarray(x),
                                           jnp.asarray(eps), 150, 0.0,
                                           sched_j))
    z = _t(np.asarray(jax.random.normal(key, x.shape)))
    _close(diffusion.ddim_reverse_step(_t(x), _t(eps), 150, 0.0, sched, z),
           ref, STEP)
    textbook = sched._replace(alpha=sched.alpha_bar)
    naive = diffusion.ddim_reverse_step(_t(x), _t(eps), 150, 0.0, textbook,
                                        z).numpy()
    assert np.abs(naive - ref).max() > 1e-2 * np.abs(ref).max()
    assert diffusion.ddim_timesteps(200, 50)[:3] == [199, 195, 191]
    assert diffusion.ddim_timesteps(8, 3) == [7, 5, 3]


@pytest.mark.parametrize("method", ["ddpm", "ddim"])
def test_chains_on_jax_draws(method):
    run = _jax_run(False)
    model = _port_model(run)
    x_init, zs = run[f"{method}_draws"]
    got = tl.sample_latents(run["cfg"], model, tl.build_schedule(run["cfg"]),
                            NB, (8, 8), CH, 1.3, method=method,
                            x_init=_t(x_init), zs=[_t(z) for z in zs])
    _close(got, run[method])


@pytest.mark.parametrize("class_cond", [False, True])
def test_train_step_loss_and_gradients(class_cond):
    run = _jax_run(class_cond)
    model = _port_model(run)
    step, tx = tl.make_train_step(run["cfg"], model,
                                  tl.build_schedule(run["cfg"]))
    state = tl.LDMState(model, tx(list(model.parameters())))
    state, metrics = step(state, (_t(run["z"]), _lt(run["labels"])),
                          t=_lt(run["t"]), noise=_t(run["noise"]))
    loss = float(metrics["loss"])
    assert abs(loss - float(run["loss"])) <= LOSS * max(abs(float(
        run["loss"])), 1.0)
    assert state.step == 1 and metrics["G_loss"] is metrics["loss"]
    ref = convert.denoise_unet(jax.tree_util.tree_map(
        lambda m: m / (1.0 - run["cfg"]["beta_1"]), run["mu"]), 2)
    got = {k: p.grad for k, p in model.named_parameters()}
    scale = max(float(v.abs().max()) for v in ref.values())
    worst = max(float((got[k] - v).abs().max()) for k, v in ref.items())
    assert worst <= GRAD * scale, (worst, scale)
    # without classes the class planes' Dense kernels see zeros: no
    # gradient, in JAX as here; every other leaf has one
    zero = {k for k, g in got.items() if float(g.abs().max()) == 0}
    assert zero == set() if class_cond else zero == {
        k for k in got if k.endswith("cond.dense.weight")}
    assert all(float(ref[k].abs().max()) == 0 for k in zero)


def test_adam_step_matches_optax():
    """The port's Adam on JAX's gradients takes optax's step."""
    run = _jax_run(False)
    model = _port_model(run)
    _, tx = tl.make_train_step(run["cfg"], model,
                               tl.build_schedule(run["cfg"]))
    opt = tx(list(model.parameters()))
    grads = convert.denoise_unet(jax.tree_util.tree_map(
        lambda m: m / (1.0 - run["cfg"]["beta_1"]), run["mu"]), 2)
    for k, p in model.named_parameters():
        p.grad = grads[k].clone()
    opt.step()
    ref = convert.denoise_unet(run["new_params"], 2)
    for k, p in model.named_parameters():
        assert float((p.detach() - ref[k]).abs().max()) <= ADAM, k


def test_latent_std_matches_jax():
    batches = [_rand((4, 3, 3, 6), 40 + i, 2.0) + 0.5 for i in range(3)]
    batches.append(_rand((1, 3, 3, 6), 44, 2.0))
    want = jl.latent_std(lambda a: a, iter(batches))
    got = tl.latent_std(lambda a: a, (_t(b) for b in batches))
    assert abs(got - want) <= STEP * want
    allz = np.concatenate([b.ravel() for b in batches]).astype(np.float64)
    assert abs(got - allz.std()) <= 1e-12 * allz.std()


# --------------------------------------------------------------------------
# generation with the tiny GAN
# --------------------------------------------------------------------------

_GEN = {}


def _jax_generate():
    """JAX's `generate_dataset` in VAE and VQ mode (one jitted program) with
    the GAN tests' tiny config (the VQ config's weights: the encoder is not
    run), a
    T=4 LDM and z_std 1.7, and its draws."""
    if _GEN:
        return _GEN
    cfgs = {vq: tiny_cfg(VQ_encoder=vq, VQ_num_embed=8) for vq in (0, 1)}
    models_j = {vq: jgan.build_models(c) for vq, c in cfgs.items()}
    _, _, txs = jgan.make_train_steps(cfgs[1], models_j[1])
    A, _, _ = mag_phase_batch()
    shapes = jax.eval_shape(
        lambda k, a: jgan.init_state(cfgs[1], models_j[1], txs, k, a),
        jax.random.PRNGKey(0), A)
    params_g = _fill_gan(shapes.params_g, 1)
    cfg = _cfg(n_timesteps=4, infer_steps=2)
    model = jl.build_model(cfg, cfgs[1]["encoded_size"])
    lat = (NB, 8, 8, cfgs[1]["encoded_size"])
    p, _ = _flax(model, 50, np.zeros(lat, np.float32),
                 np.zeros((NB,), np.int32), np.zeros((NB,), np.int32))
    sched = jl.build_schedule(cfg)
    key = jax.random.PRNGKey(9)
    out = jax.jit(lambda pg, pl: {vq: jl.generate_dataset(
        cfg, cfgs[vq], models_j[vq], pg, model, pl, sched, key,
        n_samples=NB, latent_hw=(8, 8), z_std=1.7) for vq in (0, 1)})(
            params_g, p)
    k0, kloop = jax.random.split(jax.random.split(key)[0])
    _GEN.update(
        cfgs=cfgs, cfg=cfg, p=p, out=jax.tree_util.tree_map(np.asarray, out),
        sds=convert.gan(params_g, _fill_gan(shapes.params_d, 2),
                        _fill_gan(shapes.d_stats, 3),
                        cfgs[1]["n_downsamplings"], cfgs[1]["n_res_blocks"]),
        x_init=np.asarray(jax.random.normal(k0, lat)),
        zs=[np.asarray(jax.random.normal(k, lat))
            for k in jax.random.split(kloop, 4)])
    return _GEN


@pytest.mark.parametrize("vq", [False, True])
def test_generate_dataset(vq):
    run = _jax_generate()
    gcfg, cfg = run["cfgs"][vq], run["cfg"]
    tm = tgan.build_models(gcfg)
    for name in ("dec_ff", "dec_mag", "dec_pha", "vq"):
        getattr(tm, name).load_state_dict(run["sds"][name])
    port = tl.build_model(cfg, gcfg["encoded_size"])
    port.load_state_dict(convert.denoise_unet(run["p"], 2))
    got_a, got_m = tl.generate_dataset(
        cfg, gcfg, tm, port, tl.build_schedule(cfg), NB, (8, 8), 1.7,
        x_init=_t(run["x_init"]), zs=[_t(z) for z in run["zs"]])
    assert got_a.shape == (NB, 6, 32, 32, 2) and got_m.shape == (NB, 3, 32,
                                                                 32, 2)
    acqs, maps = run["out"][vq]
    _close(got_m, maps)
    _close(got_a, acqs)
    other = run["out"][not vq][1]
    assert np.abs(got_m.numpy() - other).max() > 1e-3  # the VQ acted


# --------------------------------------------------------------------------
# the generative metrics
# --------------------------------------------------------------------------

def test_fid_and_mmd():
    real, fake = _rand((40, 6), 60), _rand((40, 6), 61, 1.3) + 0.2
    acc_j, acc_t = jmetrics.FIDAccumulator(), tmetrics.FIDAccumulator()
    for sl in (slice(0, 25), slice(25, 40)):
        acc_j.update(real[sl], fake[sl])
        acc_t.update(_t(real[sl]), _t(fake[sl]))
    want = acc_j.result()
    assert abs(acc_t.result() - want) <= STEP * abs(want)
    # a singular covariance takes the ε branch in both
    sing = np.outer(np.arange(4.0), np.arange(4.0))
    mu = np.arange(4.0)
    assert abs(tmetrics.frechet_distance(mu, sing, mu + 1, sing)
               - jmetrics.frechet_distance(mu, sing, mu + 1, sing)) <= 1e-9
    a, b = _rand((5, 3, 7, 7), 62), _rand((5, 3, 7, 7), 63) + 0.1
    want = float(jmetrics.mmd_linear(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(tmetrics.mmd_linear(_t(a), _t(b))) - want) <= \
        STEP * max(abs(want), 1.0)


@pytest.mark.parametrize("size", [32, 176])
def test_ssim_and_ms_ssim(size):
    rng = np.random.default_rng(size)
    a = rng.uniform(0, 1, (3, size, size, 1)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    # jitted: one compile instead of one per operation
    sj, csj = jax.jit(jmetrics.ssim, static_argnames="return_cs")(
        a, b, return_cs=True)
    st, cst = tmetrics.ssim(_t(a), _t(b), return_cs=True)
    _close(st, sj, STEP)
    _close(cst, csj, STEP)
    if size >= 176:
        _close(tmetrics.ms_ssim(_t(a), _t(b)), jax.jit(jmetrics.ms_ssim)(a, b),
               STEP)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

LDM_FLAGS = ["--n_timesteps", "8", "--n_ldm_filters", "8", "--dim_mults",
             "[1,2]", "--class_cond", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def gan_run(tmp_path_factory):
    from ideal_gan_tpu_torch.cli import train_gan
    out = tmp_path_factory.mktemp("ldm_cli")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_gan.main([
            "--dataset", "t-gan", "--synthetic", "8", "--data_size", "32",
            "--n_G_filters", "12", "--n_downsamplings", "2",
            "--n_res_blocks", "1", "--encoded_size", "12", "--batch_size",
            "4", "--epochs", "1", "--A_loss", "MSE", "--device", "cpu",
            "--output_base", str(out)])
    finally:
        torch.set_num_threads(n)
    return out


def test_cli_train_ldm_resume_and_preemption(gan_run, monkeypatch, capsys):
    from ideal_gan_tpu_torch.cli import train_ldm
    from ideal_gan_tpu_torch.utils.summary import read_scalars
    exp = gan_run / "t-gan"
    labels = gan_run / "labels.csv"
    labels.write_text("grade\n0\n1\n2\n3\n1\n")
    argv = ["--dataset", "t-ldm", "--experiment_dir", str(exp),
            "--synthetic", "8", "--batch_size", "4", "--epoch_ckpt", "1",
            "--labels_file", str(labels),
            "--output_base", str(gan_run), *LDM_FLAGS]
    res = train_ldm.main(argv + ["--epochs", "1"])
    out = capsys.readouterr().out
    assert "restored PI-VAE checkpoint" in out and "z_std = " in out
    # z_std over the cohort's latents, encoded again, in float64
    from ideal_gan_tpu_torch.cli.common import load_cohorts, load_settings
    gcfg = load_settings(exp).backfill(tgan.DEFAULTS)
    encode = tl.make_encode(tl.load_gan(gcfg, exp, "cpu"), False)
    acqs, _, _ = load_cohorts(gcfg.overlay({"synthetic": 8}))
    lat = torch.cat([encode(_t(acqs[i:i + 4])) for i in (0, 4)]).double()
    assert lat.shape == (8, 8, 8, 12)
    assert abs(res["z_std"] - float(lat.std(unbiased=False))) <= \
        1e-12 * res["z_std"]
    assert (exp / "checkpoints_ldm" / "ckpt-1.pt").exists()
    assert (gan_run / "t-ldm" / "settings_ldm.yml").exists()
    # a preemption signal in epoch 2 checkpoints it and stops
    real_step, sent = tl.make_train_step, []

    def make_step(*a, **k):
        step, tx = real_step(*a, **k)

        def signalled(*sa, **sk):
            if not sent:  # once: a second signal kills the run
                sent.append(os.kill(os.getpid(), signal.SIGTERM))
            return step(*sa, **sk)
        return signalled, tx

    monkeypatch.setattr(tl, "make_train_step", make_step)
    res = train_ldm.main(argv + ["--epochs", "5"])
    assert res["preempted"] and [e["epoch"] for e in res["epochs"]] == [2]
    assert "preempted: checkpointed epoch 2, exiting" in \
        capsys.readouterr().out
    monkeypatch.setattr(tl, "make_train_step", real_step)
    res = train_ldm.main(argv + ["--epochs", "3"])
    assert "resumed from epoch 2" in capsys.readouterr().out
    assert [e["epoch"] for e in res["epochs"]] == [3]
    assert res["state"].step == 6
    assert np.isfinite(res["epochs"][-1]["loss"])
    ckpt = torch.load(exp / "checkpoints_ldm" / "ckpt-3.pt",
                      weights_only=True)
    assert ckpt["z_std"] == res["z_std"] and "state" in ckpt
    # summaries every 20 steps: none in runs of at most 2 steps each
    assert read_scalars(str(gan_run / "t-ldm" / "summaries" /
                            "train_ldm")) == {}


def test_cli_gen_and_metrics(gan_run, monkeypatch, capsys):
    from ideal_gan_tpu_torch.cli import (gen_ldm_dataset, test_genmetrics,
                                         train_ldm)
    from ideal_gan_tpu_torch.data.records import read_shards
    exp = gan_run / "t-gan"
    if not (exp / "checkpoints_ldm").exists():
        train_ldm.main(["--dataset", "t-ldm", "--experiment_dir", str(exp),
                        "--synthetic", "8", "--batch_size", "4", "--epochs",
                        "1", "--output_base", str(gan_run), *LDM_FLAGS])
    res = gen_ldm_dataset.main([
        "--dataset", "t-gen", "--experiment_dir", str(exp), "--n_samples",
        "3", "--sample_batch", "2", "--infer_steps", "4", "--method", "ddim",
        "--output_base", str(gan_run), *LDM_FLAGS])
    assert len(res["shards"]) == 2
    acqs, maps = read_shards(res["shards"])
    assert acqs.shape == (3, 6, 32, 32, 2) and maps.shape == (3, 3, 32, 32,
                                                              2)
    assert np.isfinite(acqs).all() and np.isfinite(maps).all()
    # --write_dicom 1 (ported): one volume a sample beside the shards
    res = gen_ldm_dataset.main([
        "--dataset", "t-gen-dcm", "--experiment_dir", str(exp),
        "--n_samples", "1", "--infer_steps", "4", "--method", "ddim",
        "--write_dicom", "1", "--output_base", str(gan_run), *LDM_FLAGS])
    vdir = gan_run / "t-gen-dcm" / "generated" / "out_dicom" / \
        "Volunteer-000"
    assert sorted(p.name for p in vdir.iterdir()) == ["MultiEcho", "PDFF",
                                                       "R2s"]
    assert (vdir / "MultiEcho" / "ME_s00.dcm").exists()
    # the VGG input at 32², its FID features from the first block (the
    # default taps' 1472² covariance takes the host's sqrtm 3–4 s)
    monkeypatch.setattr(test_genmetrics, "echoes_to_vgg_input",
                        lambda x: tmetrics.echoes_to_vgg_input(x, size=32))
    monkeypatch.setattr(test_genmetrics, "init_vgg19",
                        lambda: tmetrics.init_vgg19(taps=(1,)))
    r = test_genmetrics.main([
        "--dataset", "t-metrics", "--experiment_dir", str(exp),
        "--synthetic", "8", "--n_samples", "4", "--sample_batch", "2",
        "--use_ldm", "1", "--infer_steps", "4",
        "--output_base", str(gan_run), *LDM_FLAGS])
    assert all(np.isfinite(r[k]) for k in ("FID", "MMD", "SSIM_pairs"))
    assert "MS_SSIM_pairs" not in r  # 32 px < 176
    assert f"features: {tmetrics.feature_source()}" in \
        capsys.readouterr().out


def test_read_labels_xlsx_and_csv(tmp_path):
    from ideal_gan_tpu_torch.cli.train_ldm import read_labels
    from ideal_gan_tpu_torch.eval.export import XlsxWriter
    w = XlsxWriter(str(tmp_path / "l.xlsx"))
    ws = w.add_worksheet("grades")
    for i, row in enumerate([["grade"], [2], [1], [3]]):
        ws.write_row(i, row)
    w.close()
    assert read_labels(str(tmp_path / "l.xlsx"), 5).tolist() == [2, 1, 3, 0,
                                                                  0]
    (tmp_path / "l.csv").write_text("grade,x\n1,0\n2,0\n3,0\n")
    assert read_labels(str(tmp_path / "l.csv"), 2).tolist() == [1, 2]
