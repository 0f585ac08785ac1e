"""The port's kernel entry points on CPU tensors (their plain versions) vs
the JAX package's Pallas kernels in interpret mode and its references.

Tolerances: rtol 1e-4 / atol 1e-5 for the fit (the JAX package's own kernel
tolerance), 5e-4 / 5e-5 over 12 echoes (its recurrence tolerance), PDFF
within 3e-3 for bf16 echoes (bench.py's gate); rtol 1e-5 / atol 1e-5 for
the ConvLSTM forward.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.ops import pallas_convlstm as jpc  # noqa: E402
from ideal_gan_tpu.ops import pallas_ideal as jpi  # noqa: E402
from ideal_gan_tpu_torch import ops  # noqa: E402

from test_torch_physics import make_maps, nonuniform_te, uniform_te  # noqa: E402


def _fit_inputs(te, h=16, w=128, seed=7):
    maps = make_maps(nb=te.shape[0], h=h, w=w, seed=seed)
    acqs = np.array(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))
    return acqs, maps[:, 2:3]


def _pdff(rre, rim):
    w = np.abs(rre[:, 0] + 1j * rim[:, 0])
    f = np.abs(rre[:, 1] + 1j * rim[:, 1])
    return f / np.maximum(w + f, 1e-6)


FIT_CASES = {
    # name: (te, uniform_te flag, rtol, atol)
    "uniform": (lambda: uniform_te(6, 2), None, 1e-4, 1e-5),
    "nonuniform": (lambda: nonuniform_te(6, 2), None, 1e-4, 1e-5),
    "12echo_forced_uniform": (lambda: uniform_te(12, 2), True, 5e-4, 5e-5),
}


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_rho_fused_matches_pallas(case):
    make_te, flag, rtol, atol = FIT_CASES[case]
    te = make_te()
    acqs, pm = _fit_inputs(te)
    got = ops.fit_rho_fused(torch.from_numpy(acqs), torch.from_numpy(pm),
                            torch.from_numpy(te), uniform_te=flag)
    ref = jpi.fit_rho_fused(jnp.asarray(acqs), jnp.asarray(pm),
                            jnp.asarray(te), uniform_te=flag)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_fit_rho_planar_matches_pallas(case):
    make_te, flag, rtol, atol = FIT_CASES[case]
    te = make_te()
    acqs, pm = _fit_inputs(te, seed=8)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in
         (acqs[..., 0], acqs[..., 1], pm[:, 0, ..., 0], pm[:, 0, ..., 1])]
    got = ops.fit_rho_planar(*t, torch.from_numpy(te), uniform_te=flag)
    ref = jpi.fit_rho_planar(*[jnp.asarray(x.numpy()) for x in t],
                             jnp.asarray(te), uniform_te=flag)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("out_bf16", [False, True])
def test_fit_rho_planar_bf16_echoes(out_bf16):
    te = uniform_te(6, 2)
    acqs, pm = _fit_inputs(te, seed=9)
    s = [torch.from_numpy(np.ascontiguousarray(acqs[..., i])) for i in (0, 1)]
    phi = torch.from_numpy(np.ascontiguousarray(pm[:, 0, ..., 0]))
    r2s = torch.from_numpy(np.ascontiguousarray(pm[:, 0, ..., 1]))
    te_t = torch.from_numpy(te)
    out_t = torch.bfloat16 if out_bf16 else torch.float32
    got = ops.fit_rho_planar(s[0].bfloat16(), s[1].bfloat16(), phi, r2s,
                             te_t, out_dtype=out_t)
    ref = jpi.fit_rho_planar(
        jnp.asarray(s[0].numpy()).astype(jnp.bfloat16),
        jnp.asarray(s[1].numpy()).astype(jnp.bfloat16),
        jnp.asarray(phi.numpy()), jnp.asarray(r2s.numpy()), jnp.asarray(te),
        out_dtype=jnp.bfloat16 if out_bf16 else jnp.float32)
    got_f = [g.float().numpy() for g in got]
    ref_f = [np.asarray(r, np.float32) for r in ref]
    for g, r, gt in zip(got, got_f, ref_f):
        assert g.dtype == out_t
        if out_bf16:
            # both round the same f32 accumulator to bf16; an accumulator
            # sitting on a rounding boundary may land one bf16 ulp apart
            np.testing.assert_allclose(r, gt, rtol=2 ** -7, atol=1e-5)
        else:
            np.testing.assert_allclose(r, gt, rtol=1e-4, atol=1e-5)
    f32 = ops.fit_rho_planar(s[0], s[1], phi, r2s, te_t)
    dev = np.abs(_pdff(*got_f) - _pdff(*[x.numpy() for x in f32])).max()
    assert dev < 3e-3


def test_precompute_fit_matrices_matches_pallas():
    te = nonuniform_te(6, 2)
    mp, te_flat = ops.precompute_fit_matrices(torch.from_numpy(te))
    rmp, rte = jpi.precompute_fit_matrices(jnp.asarray(te))
    np.testing.assert_allclose(mp.numpy(), np.asarray(rmp), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(te_flat.numpy(), np.asarray(rte))


def _lstm_inputs(nb=2, ne=3, h=16, w=16, cin=2, f=8, seed=21):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, ne, h, w, cin)).astype(np.float32) * 0.5
    k = (rng.normal(size=(3, 3, cin + f, 4 * f)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(4 * f,)) * 0.1).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("ne", [3, 6])
@pytest.mark.parametrize("f", [6, 8])
@pytest.mark.parametrize("cin", [1, 2])
def test_convlstm_forward_matches_pallas(cin, f, ne):
    x, k, b = _lstm_inputs(ne=ne, cin=cin, f=f, seed=cin * 100 + f + ne)
    got = ops.convlstm_forward(*map(torch.from_numpy, (x, k, b)))
    assert tuple(got.shape) == (2, 16, 16, f)
    jx, jk, jb = map(jnp.asarray, (x, k, b))
    ref_kernel = jpc.convlstm_pallas(jx, jk, jb, interpret=True)
    ref_plain, _ = jpc._jnp_reference(jx, jk, jb, "leaky_relu", "sigmoid")
    for ref in (ref_kernel, ref_plain):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("cin,f,ne", [(1, 6, 1), (3, 6, 3)])
def test_convlstm_forward_matches_pallas_odd_channels(cin, f, ne):
    """The plain version (what `convlstm_forward` takes for CPU tensors)
    against the Pallas kernel at the shapes the CUDA kernel pads: C =
    Cin+F not a multiple of 8 and F not a multiple of 4, at ne 1 (no state
    ever) and 3. The card tests hold the kernel itself at such shapes."""
    x, k, b = _lstm_inputs(ne=ne, cin=cin, f=f, seed=cin * 10 + ne)
    got = ops.convlstm_forward(*map(torch.from_numpy, (x, k, b)))
    ref = jpc.convlstm_pallas(*map(jnp.asarray, (x, k, b)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_convlstm_reference_tanh_cell():
    x, k, b = _lstm_inputs(seed=5)
    got = ops.convlstm_reference(*map(torch.from_numpy, (x, k, b)),
                                 activation="tanh")
    ref, _ = jpc._jnp_reference(*map(jnp.asarray, (x, k, b)), "tanh",
                                "sigmoid")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
