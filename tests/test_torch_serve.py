"""Serving what the port trains, vs the JAX package: the phase-constrained
map fit, the VET-Net serving closure, the train → `infer --experiment_dir`
round trip of each trained family, and `--map`.

Tolerances:
- `phase_constraint_matrix` rtol 1e-5 / atol 1e-6 (a 2×2 closed-form
  inverse in float32);
- `fit_rho(phase_constraint=True)` 1e-5 + 1e-4·|ref|, the fit's own
  tolerance (tests/test_torch_ops.py), where the shared phase is well
  posed: the phase is ½·angle(Σ_s ρ_s·(H⁺ρ)_s), which is ill-conditioned
  where that sum is ≈ 0, and any two float32 versions can differ there by
  up to |ρ|; compared where |Σ| > 1e-3 of its largest value, a share the
  test reports and bounds;
- the VET-Net closure: its (φ, R2*) rtol / atol 1e-4 (about twenty
  layers of float32 sums in another order, tests/test_torch_teaug.py); its
  ρ against the JAX fit of the port's own (φ, R2*) at the fit's tolerance,
  and against the JAX composition at 5e-3 (the AI-DEAL slice's tolerance,
  tests/test_torch_infer.py: the fit turns a field-map difference dφ into
  a phase error of up to 2π·te·fm_sc·dφ ≈ 22·dφ at the last echo), both
  where the shared phase is well posed. The nets' head kernels are scaled
  by 0.1: with He-normal heads at F=4 and four levels, the heads'
  pre-activations reach ~14 and float32 leaves both packages 1e-4–1e-3
  from float64 (JAX 9.6e-4, the port 6.3e-4 at seed 9); scaled, both lie
  within 1.3e-4 of it over three seeds (the port within 8.5e-5);
- the round trips: the served maps against the restored nets run by hand
  on the same chunks, 1e-6 (the same CPU code).
"""

import shutil
from functools import partial

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.models import VETNet as JVETNet  # noqa: E402
from ideal_gan_tpu.physics import matrix as jmx  # noqa: E402
from ideal_gan_tpu_torch import ops, physics  # noqa: E402
from ideal_gan_tpu_torch.cli import (common, infer, roi_analysis,  # noqa: E402
                                     train_mag, train_teaug, train_unsup)
from ideal_gan_tpu_torch.data import (acqs_from_mebcrn,  # noqa: E402
                                      maps_from_mebcrn)
from ideal_gan_tpu_torch.physics import matrix as tmx  # noqa: E402
from ideal_gan_tpu_torch.prob import Rician  # noqa: E402
from ideal_gan_tpu_torch.train import mag, teaug, unsup  # noqa: E402
from ideal_gan_tpu_torch.utils import Checkpoint, Config  # noqa: E402

from test_torch_infer import _flat  # noqa: E402
from test_torch_physics import TE_CASES, make_maps  # noqa: E402

# the TE trains of the fit tests: 6 echoes at both fields, and jittered
FIT_TE = ("nonuniform6", "uniform3T", "uniform6")
from test_torch_teaug import _random_params  # noqa: E402

F_SMALL, SIZE, NE = 4, 32, 6
SMALL = ["--device", "cpu", "--data_size", str(SIZE), "--n_G_filters",
         str(F_SMALL), "--batch_size", "2", "--epochs", "1"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_fit_pc = jax.jit(partial(jph.fit_rho, phase_constraint=True))


@jax.jit
def _phase_sum(a, p, t):
    rho = jph.fit_rho(a, p, t)
    c = (rho[..., 0] + 1j * rho[..., 1]).reshape(rho.shape[0], rho.shape[1],
                                                  -1)
    m = jmx.model_matrix(t)
    h = jmx.phase_constraint_matrix(m, jmx.pinv_normal(m))
    return jnp.abs(jnp.sum(c * (h @ c), axis=1)).reshape(
        rho.shape[:1] + rho.shape[2:4])


def phase_sum(acqs, pm, te):
    """|Σ_s ρ_s·(H⁺ρ)_s| per voxel (nb, H, W) from the JAX package's
    unconstrained fit: the sum whose angle is twice the shared phase."""
    return np.asarray(_phase_sum(jnp.asarray(acqs), jnp.asarray(pm),
                                 jnp.asarray(te)))


def well_posed(acqs, pm, te):
    s = phase_sum(acqs, pm, te)
    return s > 1e-3 * s.max()


# --------------------------------------------------------------------------
# the phase-constrained fit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", FIT_TE)
def test_phase_constraint_matrix_matches_jax(case):
    te = TE_CASES[case](2)
    m = tmx.model_matrix(_t(te))
    got = tmx.phase_constraint_matrix(m, tmx.pinv_normal(m))
    jm = jmx.model_matrix(jnp.asarray(te))
    ref = jmx.phase_constraint_matrix(jm, jmx.pinv_normal(jm))
    assert got.dtype == torch.complex64 and got.shape == (2, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", FIT_TE)
def test_fit_rho_phase_constraint_matches_jax(case):
    """Water and fat with phases of their own, fitted at field maps 0.02
    off the truth: the LS ρ of the two species differ in phase, which the
    constraint replaces by one shared phase."""
    maps = make_maps(h=24, w=24, seed=6)
    te = TE_CASES[case](2)
    acqs = np.array(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))
    pm = maps[:, 2:3] + 0.02 * np.random.default_rng(7).normal(
        size=maps[:, 2:3].shape).astype(np.float32)
    got = physics.fit_rho(_t(acqs), _t(pm), _t(te),
                          phase_constraint=True).numpy()
    ref = np.asarray(_fit_pc(jnp.asarray(acqs), jnp.asarray(pm),
                             jnp.asarray(te)))
    ok = well_posed(acqs, pm, te)
    share = float(ok.mean())
    print(f"phase well posed at {share:.4f} of the voxels")
    assert share > 0.95
    err = np.abs(got - ref).max(axis=(1, 4))
    tol = (1e-5 + 1e-4 * np.abs(ref)).min(axis=(1, 4))
    assert (err <= tol)[ok].all()
    # water and fat share one phase: ρ_w·conj(ρ_f) is real
    w, f = got[:, 0, ..., 0] + 1j * got[:, 0, ..., 1], \
        got[:, 1, ..., 0] + 1j * got[:, 1, ..., 1]
    np.testing.assert_allclose(np.imag(w * np.conj(f)), 0, atol=1e-5)


def test_fit_rho_phase_constraint_recovers_shared_phase_maps():
    """On the synthetic cohort water and fat share a phase, so the
    constrained fit at the true field map inverts the forward model."""
    acqs, maps, te = (np.array(x) for x in j_synthetic(2, h=16, w=16,
                                                       ne=NE))
    got = physics.fit_rho(_t(acqs), _t(maps[:, 2:3]), _t(te),
                          phase_constraint=True)
    np.testing.assert_allclose(got.numpy(), maps[:, :2], atol=1e-4)


# --------------------------------------------------------------------------
# the VET-Net serving closure
# --------------------------------------------------------------------------

def test_vetnet_serving_matches_jax(tmp_path):
    """`--weights` (Flax `params/...`) through the port's closure against
    the JAX package's VET-Net branch: model.apply, then the plain
    phase-constrained fit."""
    acqs, _, te = (np.array(x) for x in j_synthetic(3, h=SIZE, w=SIZE,
                                                     ne=NE))
    jm = JVETNet(me_layer=True, te_input=True, filters=F_SMALL)
    p = _random_params(jm, 5, jnp.asarray(acqs[:1]),
                       jnp.asarray(te[:1, :, 0]))
    for dec in ("dec_r2", "dec_fm"):
        p[dec]["Conv_0"]["kernel"] = p[dec]["Conv_0"]["kernel"] * 0.1

    @jax.jit
    def compose(params, a, t):
        pm = jm.apply({"params": params}, a, t[..., 0])
        return jnp.concatenate([_fit_pc(a, pm, t), pm], axis=1)

    ref = np.asarray(compose(p, jnp.asarray(acqs), jnp.asarray(te)))
    weights = tmp_path / "vetnet.npz"
    np.savez(weights, **_flat(p, "params/"))
    cfg = dict(infer.DEFAULTS, weights=str(weights))
    _, tcfg = roi_analysis.load_vetnet(cfg, "cpu")
    assert (tcfg["n_G_filters"], tcfg["te_input"], tcfg["FM_SelfAttention"],
            tcfg["R2_SelfAttention"]) == (F_SMALL, True, True, False)
    run = roi_analysis.make_infer_run(cfg, acqs, device="cpu")
    # batch 2 over 3 slices: the last chunk is padded, then trimmed
    maps, var = roi_analysis._per_slice(run, acqs, te, 2, device="cpu")
    assert maps.shape == ref.shape == (3, 3, SIZE, SIZE, 2)
    assert var.shape == (3, 4, SIZE, SIZE, 1) and not var.any()
    np.testing.assert_allclose(maps[:, 2], ref[:, 2], rtol=1e-4, atol=1e-4)
    ok = well_posed(acqs, ref[:, 2:3], te)
    share = float(ok.mean())
    print(f"phase well posed at {share:.4f} of the voxels")
    assert share > 0.5
    rho_own = np.asarray(_fit_pc(jnp.asarray(acqs),
                                 jnp.asarray(maps[:, 2:3]), jnp.asarray(te)))
    err = np.abs(maps[:, :2] - rho_own).max(axis=(1, 4))
    assert (err <= (1e-5 + 1e-4 * np.abs(rho_own)).min(axis=(1, 4)))[ok].all()
    assert (np.abs(maps[:, :2] - ref[:, :2]).max(axis=(1, 4)) <= 5e-3)[
        ok].all()


# --------------------------------------------------------------------------
# train → infer --experiment_dir
# --------------------------------------------------------------------------

def write_hdf5_cohort(path, n=2):
    """The synthetic cohort written in the reference HDF5 layout."""
    acqs, maps, te = common.synthetic_dataset(n, h=SIZE, w=SIZE, ne=NE,
                                              seed=3)
    with h5py.File(path, "w") as f:
        f.create_dataset("Acquisitions",
                         data=acqs_from_mebcrn(_t(acqs)).numpy())
        f.create_dataset("OutMaps", data=maps_from_mebcrn(_t(maps)).numpy())
        f.create_dataset("TEs", data=te[..., 0])


def _serve(exp, out, *extra, model_sel="VET-Net"):
    """`cli.infer` on the experiment `exp`, one chunk of 2 slices."""
    return infer.main(["--device", "cpu", "--model_sel", model_sel,
                       "--experiment_dir", str(exp), "--data_size",
                       str(SIZE), "--infer_batch", "2", "--output_base",
                       str(out), *extra])


def _run(cfg, acqs, te):
    """The serving closure of `cfg` on the CPU over the slices."""
    run = roi_analysis.make_infer_run(cfg, acqs, device="cpu")
    return roi_analysis._per_slice(run, acqs, te, 2, device="cpu")[0]


def _seeded(exp, tmp, cfg, acqs, te):
    """The maps of the seeded initial weights at the experiment's settings
    (its settings.yml without its checkpoints)."""
    tmp.mkdir()
    shutil.copy(exp / "settings.yml", tmp)
    return _run(dict(cfg, experiment_dir=str(tmp)), acqs, te)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The nets here are tiny: under the Tier-1 command's parallel workers
    torch's thread pool costs more time than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def teaug_experiment(tmp_path_factory):
    """VET-Net trained for one step on an HDF5 cohort read through
    --dataset_dir, and that cohort."""
    root = tmp_path_factory.mktemp("teaug")
    write_hdf5_cohort(root / "INTArest_GC_32_complex_2D.hdf5")
    out = train_teaug.main(SMALL + ["--dataset_dir", str(root),
                                    "--output_base", str(root / "run")])
    assert out["state"].step == 1
    acqs, _, te = common.load_cohorts(dict(infer.DEFAULTS,
                                           dataset_dir=str(root),
                                           data_size=SIZE))
    return root, root / "run" / teaug.DEFAULTS["dataset"], acqs, te


def test_teaug_round_trip_serves_the_checkpoint(teaug_experiment, tmp_path,
                                                capsys):
    root, exp, acqs, te = teaug_experiment
    maps = _serve(exp, tmp_path / "s", "--dataset_dir", str(root))
    assert "serving the epoch-1 checkpoint" in capsys.readouterr().out
    model = teaug.build_model(dict(teaug.DEFAULTS, n_G_filters=F_SMALL))
    model.load_state_dict(Checkpoint(exp / "checkpoints").restore()["model"])
    with torch.no_grad():
        pm = model.eval()(_t(acqs), _t(te[..., 0]))
        rho = physics.fit_rho(_t(acqs), pm, _t(te), phase_constraint=True)
    np.testing.assert_allclose(maps, torch.cat([rho, pm], 1).numpy(),
                               rtol=1e-6, atol=1e-6)
    cfg = dict(infer.DEFAULTS, experiment_dir=str(exp))
    seeded = _seeded(exp, tmp_path / "seeded", cfg, acqs, te)
    assert "serving seeded random weights" in capsys.readouterr().out
    assert np.abs(maps - seeded).max() > 1e-3


def test_unsup_round_trip_serves_fm_offset(tmp_path):
    out = train_unsup.main(SMALL + ["--synthetic", "2", "--learn_fm_offset",
                                    "true", "--output_base",
                                    str(tmp_path / "run")])
    fm_offset = float(out["state"].fm_offset)
    assert fm_offset != 0.0
    exp = tmp_path / "run" / unsup.DEFAULTS["dataset"]
    maps = _serve(exp, tmp_path / "s", "--synthetic", "2",
                  model_sel="AI-DEAL")
    acqs, _, te = common.synthetic_dataset(2, h=SIZE, w=SIZE, ne=NE)
    state = Checkpoint(exp / "checkpoints").restore()
    g_fm, g_r2 = unsup.build_models(dict(unsup.DEFAULTS,
                                         n_G_filters=F_SMALL))
    g_fm.load_state_dict(state["g_fm"])
    g_r2.load_state_dict(state["g_r2"])
    a, t = _t(acqs), _t(te)
    with torch.no_grad():
        pm = torch.cat([g_fm.eval()(a) + fm_offset,
                        g_r2.eval()(a.square().sum(-1, True).sqrt())],
                       dim=-1)
        rho = ops.fit_rho_fused(a, pm, t)
    np.testing.assert_allclose(maps, torch.cat([rho, pm], 1).numpy(),
                               rtol=1e-6, atol=1e-6)
    cfg = dict(infer.DEFAULTS, model_sel="AI-DEAL", experiment_dir=str(exp))
    seeded = _seeded(exp, tmp_path / "seeded", cfg, acqs, te)
    assert np.abs(maps - seeded).max() > 1e-3


def test_mag_round_trip_serves_the_checkpoint(tmp_path):
    train_mag.main(SMALL + ["--synthetic", "2", "--output_base",
                            str(tmp_path / "run")])
    exp = tmp_path / "run" / mag.DEFAULTS["dataset"]
    maps = _serve(exp, tmp_path / "s", "--synthetic", "2", model_sel="Mag")
    acqs, _, te = common.synthetic_dataset(2, h=SIZE, w=SIZE, ne=NE)
    model = mag.build_model(dict(mag.DEFAULTS, n_G_filters=F_SMALL))
    model.load_state_dict(Checkpoint(exp / "checkpoints").restore()["model"])
    a_mag = _t(acqs).square().sum(-1, keepdim=True).sqrt()
    with torch.no_grad():
        r2 = model.eval()(a_mag, _t(te[..., 0]))
        assert not isinstance(r2, Rician)
        rho = ops.cse_mag_fused(a_mag, r2, _t(te)).rho
    np.testing.assert_allclose(maps[:, :2, ..., 0], rho[..., 0].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(maps[:, 2, ..., 1], r2[:, 0, ..., 0].numpy(),
                               rtol=1e-6, atol=1e-6)
    cfg = dict(infer.DEFAULTS, model_sel="Mag", experiment_dir=str(exp))
    seeded = _seeded(exp, tmp_path / "seeded", cfg, acqs, te)
    assert np.abs(maps - seeded).max() > 1e-3


def test_experiment_settings_take_the_family_keys_only(tmp_path):
    Config({"n_G_filters": 8, "device": "cuda", "output_dir": "elsewhere",
            "FM_SelfAttention": False, "unknown": 1}).save(
                tmp_path / "settings.yml")
    got = roi_analysis.experiment_settings(
        dict(experiment_dir=str(tmp_path)), teaug.DEFAULTS)
    assert got == dict(teaug.DEFAULTS, n_G_filters=8,
                       FM_SelfAttention=False)
    assert common.load_settings(tmp_path)["device"] == "cuda"
    with pytest.raises(FileNotFoundError):
        common.load_settings(tmp_path / "absent")
    # a directory with neither settings nor checkpoints: the defaults, no
    # checkpoint, and nothing created
    empty = dict(experiment_dir=str(tmp_path / "absent"))
    assert roi_analysis.experiment_settings(empty, mag.DEFAULTS) \
        == mag.DEFAULTS
    assert roi_analysis.restore_checkpoint(empty) is None
    assert not (tmp_path / "absent").exists()


def test_map_selects_the_same_maps(teaug_experiment):
    """`--map` R2s and Water serve the PDFF maps, as in the JAX package,
    and so does PDFF-var outside the AI-DEAL branch (VET-Net here); the
    GraphCuts selector is not served (it consumes precomputed maps)."""
    _, exp, acqs, te = teaug_experiment
    cfg = dict(infer.DEFAULTS, experiment_dir=str(exp))
    served = {m: _run(dict(cfg, map=m), acqs, te)
              for m in ("PDFF", "R2s", "Water", "PDFF-var")}
    np.testing.assert_array_equal(served["R2s"], served["PDFF"])
    np.testing.assert_array_equal(served["Water"], served["PDFF"])
    np.testing.assert_array_equal(served["PDFF-var"], served["PDFF"])
    with pytest.raises(SystemExit, match="GraphCuts"):
        roi_analysis.make_infer_run(dict(cfg, model_sel="GraphCuts"), acqs,
                                    "cpu")
