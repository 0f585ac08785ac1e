"""The AI-DEAL serving slice of the port as a whole vs the JAX package, the
port's CLI, its device rule and its import hygiene.

The slice comparison mirrors `ideal_gan_tpu/cli/roi_analysis.py`'s AI-DEAL
closure (g_fm on the echoes, g_r2 on their magnitudes, `physics.fit_rho`,
maps concatenated) on the same synthetic acquisitions and converted weights.
Weights: Flax init perturbed by 0.02·N(0, 1). Tolerances: the nets' (φ, R2*)
maps to rtol / atol 1e-4 (tests/test_torch_models.py); the fit turns a
field-map difference dφ into a phase error up to 2π·te·fm_sc·dφ ≈ 22·dφ rad
at the last echo, so ρ is held to atol 5e-3; PDFF = |F|/|W+F| to 5e-3 where
|W+F| > 0.05, since it is ill-conditioned where random nets make the fitted
water and fat cancel (measured up to 2.1e-3 over three weight seeds).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.train import unsup as junsup  # noqa: E402
from ideal_gan_tpu_torch.cli import common, infer, roi_analysis  # noqa: E402

from test_torch_models import flax_params  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
NPZ_KEYS = {"maps", "pdff", "r2s_hz", "field_hz", "slices_per_s"}


def _flat(tree, prefix):
    return {prefix + jax.tree_util.keystr(k, simple=True, separator="/"):
            np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_aideal_slice_matches_jax(tmp_path):
    acqs, _, te = (np.array(x) for x in j_synthetic(3, h=32, w=32, ne=6))
    g_fm, g_r2 = junsup.build_models(dict(junsup.DEFAULTS, n_G_filters=4))
    a = jnp.asarray(acqs)
    a_abs = jnp.sqrt(jnp.sum(jnp.square(a), axis=-1, keepdims=True))
    p_fm = flax_params(g_fm, a[:1], 11, noise=0.02)
    p_r2 = flax_params(g_r2, a_abs[:1], 12, noise=0.02)
    fm = g_fm.apply({"params": p_fm}, a)
    r2 = g_r2.apply({"params": p_r2}, a_abs)
    pm0 = jnp.concatenate([fm, r2], axis=-1)
    rho = jph.fit_rho(a, pm0, jnp.asarray(te))
    ref = np.asarray(jnp.concatenate([rho, pm0], axis=1))

    weights = tmp_path / "aideal.npz"
    np.savez(weights, **_flat(p_fm, "params_fm/"), **_flat(p_r2, "params_r2/"))
    cfg = dict(infer.DEFAULTS, model_sel="AI-DEAL", weights=str(weights))
    run = roi_analysis.make_infer_run(cfg, acqs, device="cpu")
    # batch 2 over 3 slices: the last chunk is padded, then trimmed
    maps, rho_var = roi_analysis._per_slice(run, acqs, te, 2, device="cpu")
    assert maps.shape == ref.shape == (3, 3, 32, 32, 2)
    assert rho_var.shape == (3, 4, 32, 32, 1) and not rho_var.any()
    np.testing.assert_allclose(maps[:, 2], ref[:, 2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(maps, ref, atol=5e-3)
    pdff, _, _ = infer.maps_to_display(maps)
    pdff_ref, _, _ = infer.maps_to_display(ref)
    stable = np.abs((ref[:, 0, ..., 0] + ref[:, 1, ..., 0])
                    + 1j * (ref[:, 0, ..., 1] + ref[:, 1, ..., 1])) > 0.05
    assert stable.mean() > 0.5
    np.testing.assert_allclose(pdff[stable], pdff_ref[stable], atol=5e-3)


@pytest.mark.parametrize("field", [1.5, 3.0])
def test_synthetic_dataset_matches_jax(field):
    got = common.synthetic_dataset(2, h=32, w=32, ne=6, field=field)
    ref = j_synthetic(2, h=32, w=32, ne=6, field=field)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-5)


def test_cli_writes_npz(tmp_path, capsys):
    maps = infer.main(["--device", "cpu", "--synthetic", "2", "--data_size",
                       "32", "--infer_batch", "2", "--output_base",
                       str(tmp_path)])
    assert maps.shape == (2, 3, 32, 32, 2) and np.isfinite(maps).all()
    with np.load(tmp_path / "infer" / "maps_pred.npz") as npz:
        assert set(npz.files) == NPZ_KEYS
        np.testing.assert_array_equal(npz["maps"], maps)
    assert "slices/s steady-state" in capsys.readouterr().out


def test_cli_rejects_unported_paths(tmp_path):
    base = ["--device", "cpu", "--synthetic", "1", "--data_size", "32",
            "--output_base", str(tmp_path)]
    # DICOM export is ported (tests/test_torch_io.py); a format that
    # neither package writes still exits
    for extra in (["--model_sel", "GraphCuts"], ["--export", "tiff"]):
        with pytest.raises(SystemExit):
            infer.main(base + extra)


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        roi_analysis.make_infer_run(dict(infer.DEFAULTS), None)
    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--synthetic", "1", "--data_size", "32",
                    "--output_base", str(tmp_path)])


def test_port_imports_no_jax():
    code = """
import importlib, pkgutil, sys
import ideal_gan_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "ideal_gan_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax", "ideal_gan_tpu",
                                    "h5py", "yaml", "tensorboardX",
                                    "matplotlib"))
assert not bad, bad
for n in ("ideal_gan_tpu_torch.cli.train_unsup",
          "ideal_gan_tpu_torch.cli.train_teaug",
          "ideal_gan_tpu_torch.cli.train_sup",
          "ideal_gan_tpu_torch.train.sup",
          "ideal_gan_tpu_torch.data.records",
          "ideal_gan_tpu_torch.models.unet",
          "ideal_gan_tpu_torch.convert",
          "ideal_gan_tpu_torch.train.teaug",
          "ideal_gan_tpu_torch.cli.train_mag",
          "ideal_gan_tpu_torch.train.mag",
          "ideal_gan_tpu_torch.prob",
          "ideal_gan_tpu_torch.prob.distributions",
          "ideal_gan_tpu_torch.ops.ideal",
          "ideal_gan_tpu_torch.train.common",
          "ideal_gan_tpu_torch.losses.regs",
          "ideal_gan_tpu_torch.data.augment",
          "ideal_gan_tpu_torch.data.hdf5",
          "ideal_gan_tpu_torch.data.layouts",
          "ideal_gan_tpu_torch.data.unwrap",
          "ideal_gan_tpu_torch.utils.checkpoint",
          "ideal_gan_tpu_torch.physics.uncertainty",
          "ideal_gan_tpu_torch.losses.heteroscedastic",
          "ideal_gan_tpu_torch.train.single",
          "ideal_gan_tpu_torch.cli.train_single",
          "ideal_gan_tpu_torch.utils.config",
          "ideal_gan_tpu_torch.utils.summary",
          "ideal_gan_tpu_torch.utils.preempt",
          "ideal_gan_tpu_torch.utils.serialization",
          "ideal_gan_tpu_torch.utils.timer",
          "ideal_gan_tpu_torch.eval.roi",
          "ideal_gan_tpu_torch.eval.export",
          "ideal_gan_tpu_torch.eval.samples",
          "ideal_gan_tpu_torch.eval.tracker",
          "ideal_gan_tpu_torch.eval.stats",
          "ideal_gan_tpu_torch.cli.roi_realphantom",
          "ideal_gan_tpu_torch.cli.phantom_parity",
          "ideal_gan_tpu_torch.cli.stats_analysis",
          "ideal_gan_tpu_torch.models.bayes",
          "ideal_gan_tpu_torch.models.complexnn",
          "ideal_gan_tpu_torch.models.discriminator",
          "ideal_gan_tpu_torch.models.vae",
          "ideal_gan_tpu_torch.losses.gan",
          "ideal_gan_tpu_torch.prob.noise",
          "ideal_gan_tpu_torch.eval.inception",
          "ideal_gan_tpu_torch.cli.test_gradients",
          "ideal_gan_tpu_torch.utils.nans"):
    assert n in names, n
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True)
    assert int(out.stdout.strip()) >= 30
