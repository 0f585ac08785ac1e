"""The port's model modules vs the JAX package's Flax modules on the same
numpy inputs and the same weights (random Flax parameters, every leaf
perturbed so that norm scales, biases and the attention γ are non-zero,
converted by `ideal_gan_tpu_torch.convert`).

Tolerance rtol 1e-5 / atol 1e-5 for single blocks: float32 on both sides,
convolution sums in different orders. The whole UNets get rtol / atol 1e-4:
about twenty layers of those sums, and at 32 px the bottleneck's instance
norms normalize 2×2 values per channel, where Flax's E[x²]−E[x]² variance
and torch's two-pass variance round differently (measured up to 5.9e-5).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu.models import attention as jatt  # noqa: E402
from ideal_gan_tpu.models import blocks as jblocks  # noqa: E402
from ideal_gan_tpu.models import convlstm as jlstm  # noqa: E402
from ideal_gan_tpu.train import unsup as junsup  # noqa: E402
from ideal_gan_tpu_torch import convert, models  # noqa: E402
from ideal_gan_tpu_torch.train import unsup as tunsup  # noqa: E402


def flax_params(module, x, seed, noise=0.1):
    """Initialized Flax params with every leaf perturbed by `noise`·N(0, 1)
    (γ set to 0.7)."""
    params = module.init(jax.random.PRNGKey(seed), x)["params"]
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return np.full(leaf.shape, 0.7, np.float32)
        return (np.asarray(leaf)
                + noise * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(perturb, params)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_conv_block():
    x = _rand((2, 16, 16, 3), 1)
    jm = jblocks.ConvBlock(6)
    p = flax_params(jm, jnp.asarray(x), 1)
    tm = models.ConvBlock(3, 6)
    tm.load_state_dict(convert.conv_block(p, ""))
    np.testing.assert_allclose(nhwc(tm(nchw(x))),
                               np.asarray(jm.apply({"params": p}, x)),
                               rtol=1e-5, atol=1e-5)


def test_upsample_flips_transpose_kernel():
    x = _rand((2, 8, 8, 6), 2)
    jm = jblocks.Upsample(5)
    p = flax_params(jm, jnp.asarray(x), 2)
    tm = models.Upsample(6, 5)
    tm.load_state_dict(convert.upsample(p, ""))
    got = nhwc(tm(nchw(x)))
    assert got.shape == (2, 16, 16, 5)
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": p}, x)),
                               rtol=1e-5, atol=1e-5)


def test_self_attention():
    x = _rand((2, 8, 8, 16), 3)
    jm = jatt.SelfAttention()
    p = flax_params(jm, jnp.asarray(x), 3)
    tm = models.SelfAttention(16)
    tm.load_state_dict(convert.self_attention(p, ""))
    assert float(tm.gamma.detach()) == pytest.approx(0.7)
    np.testing.assert_allclose(nhwc(tm(nchw(x))),
                               np.asarray(jm.apply({"params": p}, x)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin", [1, 2])
def test_convlstm_module(cin):
    x = 0.5 * _rand((2, 3, 16, 16, cin), 4 + cin)
    jm = jlstm.ConvLSTM(filters=8)
    p = flax_params(jm, jnp.asarray(x), 4 + cin)
    tm = models.ConvLSTM(cin, 8)
    tm.load_state_dict(convert.convlstm(p, ""))
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 8, 16, 16) and got.is_contiguous()
    np.testing.assert_allclose(nhwc(got),
                               np.asarray(jm.apply({"params": p}, x)),
                               rtol=1e-5, atol=1e-5)


def _unet_pair(which, filters=4):
    cfg = dict(junsup.DEFAULTS, n_G_filters=filters)
    jnet = dict(zip(("fm", "r2"), junsup.build_models(cfg)))[which]
    tnet = dict(zip(("fm", "r2"), tunsup.build_models(cfg)))[which]
    cin = 2 if which == "fm" else 1
    x = 0.5 * _rand((2, 3, 32, 32, cin), 7 if which == "fm" else 8)
    p = flax_params(jnet, jnp.asarray(x), 9)
    return jnet, tnet, p, x


@pytest.mark.parametrize("which", ["fm", "r2"])
def test_unet_build_models(which):
    jnet, tnet, p, x = _unet_pair(which)
    tnet.load_state_dict(convert.unet(p))
    ref = np.asarray(jnet.apply({"params": p}, jnp.asarray(x)))
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert got.shape == ref.shape == (2, 1, 32, 32, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_convert_npz_roundtrip(tmp_path):
    _, tnet, p, _ = _unet_pair("fm")
    flat = {jax.tree_util.keystr(k, simple=True, separator="/"): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(p)}
    np.savez(tmp_path / "w.npz", **flat)
    direct = convert.unet(p)
    loaded = convert.unet(convert.load_npz(tmp_path / "w.npz"))
    assert set(direct) == set(loaded) == set(tnet.state_dict())
    for k in direct:
        assert torch.equal(direct[k], loaded[k]), k


def test_unported_unet_options_raise():
    with pytest.raises(NotImplementedError):
        models.UNet(2, bayesian=True)
    with pytest.raises(NotImplementedError):
        models.UNet(2, me_layer=False)
    with pytest.raises(NotImplementedError):
        models.Norm(4, "batch_norm")
