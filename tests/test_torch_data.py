"""The port's data layer vs the JAX package: the HDF5 cohort loaders, the
layout converters, 2-D phase unwrapping and `cli.common.load_cohorts` over
a `--dataset_dir` (that importing the port does not import h5py is
checked with its other imports, tests/test_torch_infer.py).

The HDF5 files are written here with h5py in the reference layout:
`Acquisitions` (n, H, W, 2·ne) with re/im interleaved, `OutMaps` (n, H, W,
6) = [Wr, Wi, Fr, Fi, R2*, FM] and `TEs` (n, ne), with an all-zero slice
and two patients of seven slices (a protocol change inside each). Both
packages' loaders are numpy on the same file, so they are held to exact
equality; the layouts (torch against jnp) and the unwrap (the same numpy
code) to 1e-6.
"""

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu.cli import common as jcommon  # noqa: E402
from ideal_gan_tpu.data import hdf5 as jhdf5  # noqa: E402
from ideal_gan_tpu.data import layouts as jlayouts  # noqa: E402
from ideal_gan_tpu.data import unwrap as junwrap  # noqa: E402
from ideal_gan_tpu_torch import data as tdata  # noqa: E402
from ideal_gan_tpu_torch.cli import common as tcommon  # noqa: E402

N, H, W, NE = 14, 16, 16, 6
ZERO_SLICE = 9
# (TE1, ΔTE) per slice: each patient of 7 starts in the original protocol,
# then switches to another one
PROTOCOLS = [(0.0013, 0.0021)] * 4 + [(0.0014, 0.0022)] * 3 \
    + [(0.0013, 0.0021)] * 5 + [(0.0012, 0.0020)] * 2


def write_cohort(path, n=N, h=H, w=W, seed=0):
    """A cohort in the reference layout; returns its arrays."""
    rng = np.random.default_rng(seed)
    acqs = rng.normal(size=(n, h, w, 2 * NE)).astype(np.float32)
    maps = rng.normal(size=(n, h, w, 6)).astype(np.float32)
    tes = np.stack([te1 + dte * np.arange(NE) for te1, dte in
                    PROTOCOLS[:n]]).astype(np.float32)
    if n > ZERO_SLICE:
        acqs[ZERO_SLICE] = 0.0
        maps[ZERO_SLICE] = 0.0
    with h5py.File(path, "w") as f:
        f.create_dataset("Acquisitions", data=acqs)
        f.create_dataset("OutMaps", data=maps)
        f.create_dataset("TEs", data=tes)
    return acqs, maps, tes


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "cohort.hdf5"
    write_cohort(path)
    return str(path)


def assert_same(got, ref):
    """Exact equality of two `Hdf5Data`s (None fields included)."""
    for field in ("acqs", "maps", "tes"):
        g, r = getattr(got, field), getattr(ref, field)
        assert (g is None) == (r is None), field
        if r is not None:
            assert g.dtype == r.dtype, field
            np.testing.assert_array_equal(g, r, err_msg=field)


LOAD_OPTIONS = {
    "defaults": {},
    "range": dict(start=2, end=11),
    "range_past_end": dict(start=5, end=2000, te_data=True),
    "custom_list": dict(custom_list=[0, 3, ZERO_SLICE, 12]),
    "num_slice_list": dict(num_slice_list=[7, 7]),
    "keep_zeros": dict(remove_zeros=False, te_data=True),
    "complex_te": dict(complex_data=True, te_data=True),
    "fewer_echoes": dict(ech_idx=8, te_data=True, mebcrn=True),
    "mebcrn": dict(mebcrn=True, te_data=True),
    "mag_and_phase": dict(mebcrn=True, mag_and_phase=True),
    "mag_and_phase_unwrap": dict(mebcrn=True, mag_and_phase=True,
                                 unwrap=True),
    "maps_only": dict(acqs_data=False, mebcrn=True),
}


@pytest.mark.parametrize("name", sorted(LOAD_OPTIONS))
def test_load_hdf5_matches_jax(cohort, name):
    kw = {"ech_idx": 2 * NE, **LOAD_OPTIONS[name]}
    got = tdata.load_hdf5(cohort, **kw)
    assert_same(got, jhdf5.load_hdf5(cohort, **kw))
    if kw.get("remove_zeros", True):
        assert np.sum(got.maps != 0, axis=tuple(range(1, got.maps.ndim))
                      ).all()


@pytest.mark.parametrize("target", [(0.0014, 0.0022), (0.0012, 0.0020),
                                    (0.0030, 0.0010)])
def test_group_tes_matches_jax(cohort, target):
    d = tdata.load_hdf5(cohort, ech_idx=2 * NE, te_data=True, mebcrn=True,
                        remove_zeros=False)
    got = tdata.group_tes(d.acqs, d.maps, d.tes, *target)
    ref = jhdf5.group_tes(d.acqs, d.maps, d.tes, *target)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert len(got[0]) > 0


def test_iterate_hdf5_matches_jax(cohort, tmp_path):
    second = tmp_path / "second.hdf5"
    write_cohort(second, n=6, seed=5)
    # the first range wraps around: slices 8–13 (the zero slice 9 is
    # skipped), then 0–2
    paths, lims = [cohort, str(second)], [(8, 3), (1, 5)]
    got = list(tdata.iterate_hdf5(paths, 2 * NE, lims))
    ref = list(jhdf5.iterate_hdf5(paths, 2 * NE, lims))
    assert len(got) == len(ref) == 5 + 3 + 4
    for (g_im, g_out), (r_im, r_out) in zip(got, ref):
        np.testing.assert_array_equal(g_im, r_im)
        np.testing.assert_array_equal(g_out, r_out)


def test_map_helpers_match_jax():
    rng = np.random.default_rng(2)
    out_maps = rng.normal(size=(3, H, W, 6)).astype(np.float32)
    out_maps[1] = 0.0
    acqs = rng.normal(size=(3, H, W, 2 * NE)).astype(np.float32)
    for unwrap in (False, True):
        np.testing.assert_array_equal(
            tdata.mag_phase_maps(out_maps, unwrap=unwrap),
            jhdf5.mag_phase_maps(out_maps, unwrap=unwrap))
    np.testing.assert_array_equal(tdata.complex_maps_mebcrn(out_maps),
                                  jhdf5.complex_maps_mebcrn(out_maps))
    np.testing.assert_array_equal(tdata.acqs_mebcrn(acqs),
                                  jhdf5.acqs_mebcrn(acqs))


def test_unwrap_matches_jax():
    """A smooth phase ramp wrapped into (−π, π], unwrapped by both."""
    yy, xx = np.mgrid[0:24, 0:20]
    true = np.stack([0.5 * xx + 0.3 * yy, 0.2 * xx - 0.4 * yy + 1.0])
    wrapped = np.angle(np.exp(1j * true)).astype(np.float32)
    got = tdata.unwrap_slices(wrapped)
    np.testing.assert_allclose(got, junwrap.unwrap_slices(wrapped),
                               rtol=1e-6, atol=1e-6)
    assert got.shape == (2, 24, 20, 1)
    # residue-free: the unwrapped phase is the ramp up to one 2π offset
    d = got[..., 0] - true
    np.testing.assert_allclose(d - d.mean(axis=(1, 2), keepdims=True), 0,
                               atol=1e-4)
    np.testing.assert_allclose(
        tdata.unwrap_phase_2d(wrapped[0]), junwrap.unwrap_phase_2d(
            wrapped[0]), rtol=1e-6, atol=1e-6)


def _layout_cases():
    rng = np.random.default_rng(7)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "acqs_from_mebcrn": (jlayouts.acqs_from_mebcrn,
                             tdata.acqs_from_mebcrn, r(2, NE, 8, 6, 2), {}),
        "acqs_to_mebcrn": (jlayouts.acqs_to_mebcrn, tdata.acqs_to_mebcrn,
                           r(2, 8, 6, 2 * NE), {}),
        "maps_from_mebcrn": (jlayouts.maps_from_mebcrn,
                             tdata.maps_from_mebcrn, r(2, 3, 8, 6, 2), {}),
        "maps_from_mebcrn_mag_phase": (jlayouts.maps_from_mebcrn,
                                       tdata.maps_from_mebcrn,
                                       r(2, 2, 8, 6, 3),
                                       dict(mag_and_phase=True, c_pha=2.0)),
        "maps_to_mebcrn_WF": (jlayouts.maps_to_mebcrn, tdata.maps_to_mebcrn,
                              r(2, 8, 6, 2), dict(mode="WF")),
        "maps_to_mebcrn_PM": (jlayouts.maps_to_mebcrn, tdata.maps_to_mebcrn,
                              r(2, 8, 6, 2), dict(mode="PM")),
        "maps_to_mebcrn_WF-PM": (jlayouts.maps_to_mebcrn,
                                 tdata.maps_to_mebcrn, r(2, 8, 6, 4),
                                 dict(mode="WF-PM")),
        "maps_to_mebcrn_All": (jlayouts.maps_to_mebcrn,
                               tdata.maps_to_mebcrn, r(2, 8, 6, 6),
                               dict(mode="All")),
        "mag_phase_to_complex_mebcrn": (jlayouts.mag_phase_to_complex_mebcrn,
                                        tdata.mag_phase_to_complex_mebcrn,
                                        r(2, 3, 8, 6, 2), {}),
    }


@pytest.mark.parametrize("name", sorted(_layout_cases()))
def test_layouts_match_jax(name):
    jfn, tfn, x, kw = _layout_cases()[name]
    got = tfn(torch.from_numpy(x), **kw)
    ref = np.asarray(jfn(jnp.asarray(x), **kw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_layouts_round_trip_and_reject_unknown_mode():
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(2, NE, 4, 4, 2)).astype(np.float32))
    assert torch.equal(tdata.acqs_to_mebcrn(tdata.acqs_from_mebcrn(x)), x)
    maps = x[:, :3]
    assert torch.equal(tdata.maps_to_mebcrn(tdata.maps_from_mebcrn(maps)),
                       maps)
    with pytest.raises(ValueError, match="mode"):
        tdata.maps_to_mebcrn(x[:, 0], mode="nope")


@pytest.mark.parametrize("mebcrn, mag_and_phase",
                         [(True, False), (True, True), (False, False)])
def test_load_cohorts_matches_jax(tmp_path, mebcrn, mag_and_phase):
    """Two of the three cohort names under --dataset_dir, in the JAX
    package's order; the absent one is skipped."""
    write_cohort(tmp_path / "INTArest_GC_16_complex_2D.hdf5", seed=1)
    write_cohort(tmp_path / "Attilio_GC_16_complex_2D.hdf5", n=5, seed=2)
    write_cohort(tmp_path / "Volunteers_GC_32_complex_2D.hdf5", n=3,
                 h=32, w=32, seed=3)  # another size: not read
    cfg = dict(dataset_dir=str(tmp_path), data_size=16, n_echoes=NE,
               synthetic=0)
    got = tcommon.load_cohorts(cfg, mebcrn=mebcrn,
                               mag_and_phase=mag_and_phase)
    ref = jcommon.load_cohorts(cfg, mebcrn=mebcrn,
                               mag_and_phase=mag_and_phase)
    assert len(got[0]) == N - 1 + 5
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_load_cohorts_without_files_raises(tmp_path):
    cfg = dict(dataset_dir=str(tmp_path), data_size=16, synthetic=0)
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        tcommon.load_cohorts(cfg)
