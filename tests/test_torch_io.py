"""The port's scanner-file layer vs the JAX package: DICOM and NIfTI readers,
writers and series loaders (`data/dicom.py`, `data/dicom_native.py`,
`data/nifti.py`), `cli.train_unsup` from series folders, `cli.infer
--export dicom` and `gen_ldm_dataset --write_dicom`.

Both packages' codecs are numpy on the same files, so everything is held
to exact equality (`np.array_equal`, dtypes too) except the UIDs, which
`generate_uid` takes from the clock. The JAX loaders build their paths from
whole path strings (the NIfTI `_e` split), so they are called from inside
the test directory on relative folders.
"""

import ctypes
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ideal_gan_tpu.data import dicom as jdcm  # noqa: E402
from ideal_gan_tpu.data import dicom_native as jnat  # noqa: E402
from ideal_gan_tpu.data import nifti as jnif  # noqa: E402
from ideal_gan_tpu_torch.cli import infer, train_unsup  # noqa: E402
from ideal_gan_tpu_torch.data import dicom as tdcm  # noqa: E402
from ideal_gan_tpu_torch.data import dicom_native as tnat  # noqa: E402
from ideal_gan_tpu_torch.data import nifti as tnif  # noqa: E402

PACKAGES = {"jax": (jdcm, jnif), "torch": (tdcm, tnif)}
# the clock's UIDs and the meta group's length, which counts them
UID_TAGS = {(0x0002, 0x0000), (0x0002, 0x0003), (0x0008, 0x0018),
            (0x0020, 0x000D), (0x0020, 0x000E), (0x0020, 0x0052)}
H = W = 32  # the UNets' four levels need 32²


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tags(path, dcm):
    return {k: v for k, v in dcm.read_dicom(str(path)).items()
            if k not in UID_TAGS}


def write_series(folder, dcm, n_sl=3, ne=3, private=True, seed=0,
                 incomplete=True):
    """A Philips MECSE series with `dcm`'s writer: magnitude and phase per
    slice and echo (the private component and rescale tags with
    `private`), and a last slice missing its last echo (dropped by the
    loader) with `incomplete`. Returns the stored uint16 images."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    stored = rng.integers(0, 4000, (n_sl + 1, ne, 2, H, W)).astype(np.uint16)
    for k in range(n_sl + int(incomplete)):
        for e in range(ne - (k == n_sl)):
            for c, comp in enumerate("MP"):
                ds = dcm.gen_ds(k)
                if private:
                    ds[(0x2005, 0x1011)] = ("LO", comp)
                    ds[(0x2005, 0x100D)] = ("DS", "0.0" if comp == "M"
                                            else "2000.0")
                    ds[(0x2005, 0x100E)] = ("DS", "1.0" if comp == "M"
                                            else "700.0")
                ds.EchoNumbers = e + 1
                ds.EchoTrainLength = ne
                ds.ImagePositionPatient = f"0\\0\\{1.5 * k:.2f}"
                ds.Columns = W
                ds.Rows = H
                ds.PixelData = stored[k, e, c].tobytes()
                ds.save_as(os.path.join(folder, f"s{k}_e{e}_{comp}.dcm"))
    return stored


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_dicom_files_cross_read(tmp_path, writer, reader):
    wd, rd = PACKAGES[writer][0], PACKAGES[reader][0]
    img = np.random.default_rng(1).uniform(-0.2, 1.2, (W, H)).astype(
        np.float32)
    for r2s in (False, True):
        name = "R2s" if r2s else "PDFF"
        for d, pkg in ((tmp_path / "w", wd), (tmp_path / "ref", rd)):
            pkg.write_dicom(pkg.gen_ds(7, "m001", r2s=r2s),
                            np.clip(img, 0, 1), str(d), name, level=3,
                            slices=5)
        path = tmp_path / "w" / f"{name}_s03.dcm"
        got = _tags(path, rd)
        assert got == _tags(tmp_path / "ref" / f"{name}_s03.dcm", rd)
        assert got == _tags(path, wd)
        assert float(got[(0x0028, 0x1053)]) == (0.78 if r2s else 0.4)
        assert got[(0x0010, 0x0010)] == "Volunteer^007^-m001"
        want = (np.clip(img, 0, 1) * 255).astype(np.uint16)
        np.testing.assert_array_equal(rd.pixel_array(got), want)
    # MECSE files with the private tags: every non-UID tag and the pixels
    write_series(tmp_path / "wser", wd, incomplete=False)
    write_series(tmp_path / "rser", rd, incomplete=False)
    for f in sorted(os.listdir(tmp_path / "wser")):
        got = _tags(tmp_path / "wser" / f, rd)
        assert got == _tags(tmp_path / "rser" / f, rd)
        assert got[(0x2005, 0x1011)] in ("M", "P")


@pytest.mark.parametrize("private", [True, False])
@pytest.mark.parametrize("backend", ["python", "native"])
def test_dicom_series_equals_jax(tmp_path, backend, private):
    write_series(tmp_path / "ser", tdcm, private=private)
    folder = str(tmp_path / "ser")
    got = tdcm.load_dicom_series(folder, backend=backend)
    assert tdcm.LAST_BACKEND == backend
    if backend == "python":
        ref = jdcm.load_dicom_series(folder, backend="python")
    else:
        ref = jnat.load_dicom_series_native(folder)
        assert ref is not None, "the JAX package's parser did not build"
    assert got.dtype == ref.dtype == np.float32 and got.shape == (3, 3, H,
                                                                  W, 2)
    np.testing.assert_array_equal(got, ref)
    if private:  # both walks agree where the private tags are present
        np.testing.assert_array_equal(
            got, tdcm.load_dicom_series(folder, backend="python"
                                        if backend == "native" else "native"))
    tdcm.load_dicom_series(folder)
    assert tdcm.LAST_BACKEND == "native"


def test_native_parser_struct_matches_python_walk(tmp_path):
    """The ctypes struct against a parse of the same file by the Python
    walk (rows ≠ cols, so a swapped field shows)."""
    assert ctypes.sizeof(tnat._DicomInfo) == 64
    assert tnat._DicomInfo.pixels.offset == 48
    ds = tdcm.gen_ds(1)
    ds.EchoNumbers = 3
    ds.EchoTrainLength = 6
    ds.ImagePositionPatient = "0\\0\\2.5"
    ds[(0x2005, 0x1011)] = ("LO", "P")
    ds[(0x2005, 0x100D)] = ("DS", "10.0")
    ds[(0x2005, 0x100E)] = ("DS", "2.0")
    img = np.arange(6 * 10, dtype=np.uint16).reshape(6, 10)
    ds.Columns, ds.Rows = 6, 10
    ds.PixelData = img.tobytes()
    path = str(tmp_path / "t.dcm")
    ds.save_as(path)
    meta, px = tnat.parse_dicom_native(path)
    tags = tdcm.read_dicom(path)
    assert meta == dict(
        rows=tags[(0x0028, 0x0010)], cols=tags[(0x0028, 0x0011)],
        echo_num=int(tags[(0x0018, 0x0086)]),
        echo_train=int(tags[(0x0018, 0x0091)]),
        slice_pos=float(tags[(0x0020, 0x0032)].split("\\")[-1]),
        rescale_i=float(tags[(0x2005, 0x100D)]),
        rescale_s=float(tags[(0x2005, 0x100E)]),
        component=tags[(0x2005, 0x1011)])
    np.testing.assert_array_equal(px.reshape(6, 10), tdcm.pixel_array(tags))
    # the build goes to the port's _build/, named by the source's hash
    assert tnat.lib_path().parent.name == "_build"
    assert tnat.lib_path().exists()
    assert tnat.SOURCE.name == "dicom_parser.cc"


def test_native_backend_raises_and_auto_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnat, "SOURCE", bad)
    monkeypatch.setattr(tnat, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "_error", None)
    write_series(tmp_path / "ser", tdcm)
    with pytest.raises(RuntimeError, match="bad.cc"):
        tdcm.load_dicom_series(str(tmp_path / "ser"), backend="native")
    assert not tnat.native_available()
    got = tdcm.load_dicom_series(str(tmp_path / "ser"))
    assert tdcm.LAST_BACKEND == "python"
    np.testing.assert_array_equal(
        got, jdcm.load_dicom_series(str(tmp_path / "ser"), backend="python"))
    with pytest.raises(ValueError):
        tdcm.load_dicom_series(str(tmp_path / "ser"), backend="pydicom")


@pytest.mark.parametrize("suffix", [".nii.gz", ".nii"])
def test_nifti_volumes_cross_read(tmp_path, suffix):
    vol = np.random.default_rng(2).normal(size=(7, 5, 4, 3)).astype(
        np.float32)
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        path = str(tmp_path / f"{writer}{suffix}")
        PACKAGES[writer][1].write_nifti(path, vol)
        back = PACKAGES[reader][1].read_nifti(path)
        assert back.dtype == np.float32
        np.testing.assert_array_equal(back, vol)
    # the same bytes whatever the writer (gzip level aside)
    if suffix == ".nii":
        assert (tmp_path / f"jax{suffix}").read_bytes() == \
            (tmp_path / f"torch{suffix}").read_bytes()


def write_bids(folder, ne=6, x=10, y=8, z=3, seed=3):
    """A BIDS multi-echo set with JAX's writer, plus files the loader
    passes over (`real`, `imaginary`, `Eq`)."""
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)
    for e in range(ne):
        base = os.path.join(folder, f"scan_e{e + 1}")
        mag = rng.uniform(0.0, 1.0, (x, y, z)).astype(np.float32)
        mag[:2] = 0.01  # under the mean-magnitude mask
        jnif.write_nifti(f"{base}.nii.gz", mag)
        jnif.write_nifti(f"{base}_ph.nii.gz",
                         rng.uniform(-3, 3, (x, y, z)).astype(np.float32))
        with open(f"{base}.json", "w") as f:
            json.dump({"EchoTrainLength": ne, "EchoTime": 1.3 + 2.1 * e}, f)
    for extra in ("scan_real", "scan_imaginary", "scanEq"):
        jnif.write_nifti(os.path.join(folder, f"{extra}.nii.gz"),
                         np.zeros((x, y, z), np.float32))


@pytest.mark.parametrize("half", [True, False])
def test_nifti_series_equals_jax(tmp_path, monkeypatch, half):
    monkeypatch.chdir(tmp_path)
    write_bids("subj")
    got = tnif.load_nifti_series("subj", half_echoes=half)
    ref = jnif.load_nifti_series("subj", half_echoes=half)
    assert got.dtype == ref.dtype == np.float32
    assert got.shape == (3, 3 if half else 6, 8, 10, 2)
    np.testing.assert_array_equal(got, ref)
    # the port splits the file name, not the path: a folder named with
    # "_e" (where JAX's loader finds no files) loads the same set
    os.rename("subj", "sub_e1")
    np.testing.assert_array_equal(
        tnif.load_nifti_series(str(tmp_path / "sub_e1"), half_echoes=half),
        got)


@pytest.mark.parametrize("kind", ["DICOM", "NIFTI"])
def test_train_unsup_from_series_folders(tmp_path, monkeypatch, one_thread,
                                         kind):
    from ideal_gan_tpu.cli import train_unsup as jtrain_unsup
    monkeypatch.chdir(tmp_path)
    data = tmp_path / "data"
    for s in range(2):
        if kind == "DICOM":
            write_series(str(data / f"sub{s}"), tdcm, n_sl=2, ne=6, seed=s)
        else:
            write_bids(str(data / f"sub{s}"), ne=12, x=H, y=W, z=2, seed=s)
    res = train_unsup.main([
        "--train_data", kind, "--dataset_dir", str(data), "--data_size",
        str(H), "--batch_size", "2", "--n_G_filters", "4", "--epochs", "1",
        "--device", "cpu", "--output_base", str(tmp_path / "out")])
    acqs, te = res["cohort"]
    ref_acqs, ref_maps, ref_te = jtrain_unsup._load_series_folders(
        {"train_data": kind, "dataset_dir": "data"})
    assert acqs.shape == (4, 6, H, W, 2)
    np.testing.assert_array_equal(acqs, ref_acqs)
    np.testing.assert_array_equal(te, np.asarray(ref_te))
    assert te.dtype == np.float32 and not ref_maps.any()
    ep = res["epochs"][-1]
    assert ep["steps"] == 2 and np.isfinite(ep["A2B2A_cycle_loss"])


def test_infer_exports_dicom(tmp_path, one_thread):
    from ideal_gan_tpu.cli import infer as jinfer
    maps = infer.main(["--model_sel", "AI-DEAL", "--device", "cpu",
                       "--synthetic", "3", "--data_size", "32",
                       "--infer_batch", "2", "--export", "dicom,npz",
                       "--method_prefix", "m007",
                       "--output_base", str(tmp_path)])
    out = tmp_path / "infer"
    with np.load(out / "maps_pred.npz") as npz:
        np.testing.assert_array_equal(npz["maps"], maps)
        pdff = npz["pdff"]
    jinfer.export_dicom(tmp_path / "jax", {"method_prefix": "m007"},
                        jinfer._display_planes(maps))
    for j in range(3):
        for series, plane in (("PDFF", pdff[j]), ("R2s", maps[j, 2, ..., 1])):
            rel = f"Volunteer-{j:03d}/{series}/{series}_s00.dcm"
            want = (np.clip(plane, 0, 1) * 255).astype(np.uint16)
            for dcm in (tdcm, jdcm):
                got = dcm.pixel_array(dcm.read_dicom(
                    str(out / "out_dicom" / rel)))
                np.testing.assert_array_equal(got, want)
            assert _tags(out / "out_dicom" / rel, tdcm) == _tags(
                tmp_path / "jax" / "out_dicom" / rel, tdcm)


def test_gen_ldm_dataset_writes_dicom(tmp_path, one_thread):
    from ideal_gan_tpu_torch.cli import gen_ldm_dataset, train_gan
    from ideal_gan_tpu_torch.data.records import read_shards
    from ideal_gan_tpu_torch.eval.roi import maps_to_display
    train_gan.main([
        "--dataset", "gan", "--synthetic", "2", "--data_size", "16",
        "--n_G_filters", "4", "--n_downsamplings", "2", "--n_res_blocks",
        "1", "--encoded_size", "6", "--batch_size", "2", "--epochs", "1",
        "--A_loss", "MSE", "--device", "cpu", "--output_base",
        str(tmp_path)])
    res = gen_ldm_dataset.main([
        "--experiment_dir", str(tmp_path / "gan"), "--dataset", "gen",
        "--n_samples", "3", "--sample_batch", "2", "--n_timesteps", "4",
        "--n_ldm_filters", "8", "--dim_mults", "[1,2]", "--write_dicom", "1",
        "--method_prefix", "m009", "--device", "cpu", "--output_base",
        str(tmp_path)])
    acqs, maps = read_shards(res["shards"])
    pdff = maps_to_display(maps)[0]
    mag0 = np.hypot(acqs[:, 0, ..., 0], acqs[:, 0, ..., 1])
    root = tmp_path / "gen" / "generated" / "out_dicom"
    for j in range(3):
        vdir = root / f"Volunteer-{j:03d}"
        # the JAX CLI's block (gen_ldm_dataset.py:74-88) on the same arrays
        jdir = tmp_path / "jax" / f"Volunteer-{j:03d}"
        jdcm.write_map_series(jdir, j, pdff[j], maps[j, 2, ..., 1], "m009")
        jdcm.write_dicom(jdcm.gen_ds(j, "m009"), np.clip(mag0[j], 0, 1),
                         str(jdir / "MultiEcho"), "ME", level=0, slices=1)
        for series, fname, plane in (("PDFF", "PDFF_s00.dcm", pdff[j]),
                                     ("R2s", "R2s_s00.dcm",
                                      maps[j, 2, ..., 1]),
                                     ("MultiEcho", "ME_s00.dcm", mag0[j])):
            got = tdcm.read_dicom(str(vdir / series / fname))
            np.testing.assert_array_equal(
                tdcm.pixel_array(got),
                (np.clip(plane, 0, 1) * 255).astype(np.uint16))
            assert _tags(vdir / series / fname, tdcm) == _tags(
                jdir / series / fname, tdcm)
