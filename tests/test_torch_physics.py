"""PyTorch port physics vs the JAX package on the same numpy inputs.

Tolerance rtol 1e-4 / atol 1e-5: the JAX package's own kernel tolerance
(tests/test_pallas_kernels.py). Both sides compute in complex64.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu_torch import physics as tph  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def make_maps(nb=2, h=16, w=16, seed=1):
    """(nb, 3, h, w, 2) water/fat/(φ, R2*) maps, as tests/test_physics.py."""
    rng = np.random.default_rng(seed)
    water = rng.uniform(0.1, 0.7, (nb, h, w)) * np.exp(
        1j * rng.uniform(-1, 1, (nb, h, w)))
    fat = rng.uniform(0.0, 0.5, (nb, h, w)) * np.exp(
        1j * rng.uniform(-1, 1, (nb, h, w)))
    phi = rng.uniform(-0.3, 0.3, (nb, h, w))
    r2s = rng.uniform(0.0, 0.5, (nb, h, w))
    rows = [np.stack([water.real, water.imag], -1),
            np.stack([fat.real, fat.imag], -1),
            np.stack([phi, r2s], -1)]
    return np.stack(rows, axis=1).astype(np.float32)


def nonuniform_te(ne, nb, seed=3):
    """A jittered TE train (nb, ne, 1), the same for every row."""
    rng = np.random.default_rng(seed)
    steps = 1.6e-3 + 1e-3 * rng.uniform() + 1e-4 * rng.normal(size=ne - 1)
    te = 1.0e-3 + np.concatenate([[0.0], np.cumsum(steps)])
    return np.broadcast_to(te.astype(np.float32)[None, :, None],
                           (nb, ne, 1)).copy()


def uniform_te(ne, nb, field=1.5):
    return np.array(jph.te_train_for_field(ne, bs=nb, field=field))


TE_CASES = {
    "uniform6": lambda nb: uniform_te(6, nb),
    "uniform3T": lambda nb: uniform_te(6, nb, field=3.0),
    "nonuniform6": lambda nb: nonuniform_te(6, nb),
    "uniform12": lambda nb: uniform_te(12, nb),
}


@pytest.mark.parametrize("field", [1.5, 3.0])
@pytest.mark.parametrize("ne", [3, 6, 12])
def test_te_train(ne, field):
    np.testing.assert_array_equal(
        tph.te_train_for_field(ne, 2, field).numpy(),
        np.asarray(jph.te_train_for_field(ne, 2, field)))


@pytest.mark.parametrize("species", ["WATER_FAT_7PEAK", "FATTY_ACID_9PEAK"])
@pytest.mark.parametrize("case", sorted(TE_CASES))
def test_model_matrix(case, species):
    te = TE_CASES[case](2)
    got = tph.model_matrix(torch.from_numpy(te), 1.5,
                           getattr(tph, species)).numpy()
    ref = np.asarray(jph.model_matrix(jnp.asarray(te), 1.5,
                                      getattr(jph, species)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(TE_CASES))
def test_pinv_normal(case):
    te = TE_CASES[case](2)
    m = np.array(jph.model_matrix(jnp.asarray(te)))
    got = tph.pinv_normal(torch.from_numpy(m)).numpy()
    ref = np.asarray(jph.pinv_normal(jnp.asarray(m)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    eye = np.broadcast_to(np.eye(m.shape[-1]), (len(m),) + (m.shape[-1],) * 2)
    np.testing.assert_allclose(got @ m, eye, atol=1e-4)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_small_inv(n):
    rng = np.random.default_rng(n)
    a = (rng.normal(size=(3, n, n)) + 1j * rng.normal(size=(3, n, n))
         + 3 * np.eye(n)).astype(np.complex64)
    got = tph.small_inv(torch.from_numpy(a)).numpy()
    ref = np.asarray(jph.matrix.small_inv(jnp.asarray(a)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(TE_CASES))
def test_synthesize(case):
    maps = make_maps(seed=4)
    te = TE_CASES[case](2)
    got = tph.synthesize(torch.from_numpy(maps), torch.from_numpy(te))
    ref = jph.synthesize(jnp.asarray(maps), jnp.asarray(te))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", sorted(TE_CASES))
def test_fit_rho(case):
    maps = make_maps(seed=5)
    te = TE_CASES[case](2)
    acqs = np.array(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))
    pm = maps[:, 2:3]
    got = tph.fit_rho(torch.from_numpy(acqs), torch.from_numpy(pm),
                      torch.from_numpy(te))
    ref = jph.fit_rho(jnp.asarray(acqs), jnp.asarray(pm), jnp.asarray(te))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    # the fit inverts the forward model
    np.testing.assert_allclose(got.numpy(), maps[:, :2], atol=1e-4)


def test_fit_rho_unported_branches_raise():
    maps = make_maps()
    te = torch.from_numpy(uniform_te(6, 2))
    acqs = tph.synthesize(torch.from_numpy(maps), te)
    pm = torch.from_numpy(maps[:, 2:3])
    # every branch is ported now and none raises (against JAX:
    # tests/test_torch_compat.py): the demodulated echoes come back beside
    # ρ, and a bipolar row of zeros changes nothing
    rho, demod = tph.fit_rho(acqs, pm, te, acq_demod=True)
    assert torch.equal(rho, tph.fit_rho(acqs, pm, te))
    assert demod.shape == acqs.shape and bool(torch.isfinite(demod).all())
    bipolar = torch.cat([pm, pm, pm, torch.zeros_like(pm)], dim=1)
    np.testing.assert_allclose(
        tph.fit_rho(acqs, bipolar, te, phase_constraint=True).numpy(),
        tph.fit_rho(acqs, pm, te, phase_constraint=True).numpy(),
        rtol=RTOL, atol=ATOL)
