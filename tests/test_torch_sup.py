"""The supervised family of the port vs the JAX package: the legacy-layout
nets (`UNet(me_layer=False)`, `VETNet(me_layer=False)`, `MDWFNet` with and
without its "dense_l1" TE input), `train.sup`'s generator selection, loss,
metrics and gradients, the generated-shard records, the 2D-Net, U-Net and
MDWF serving closures, and the port's `train_sup` CLI with a train → serve
round trip.

Inputs are made with numpy from a seed and handed to both packages; model
weights are Flax parameters with every leaf drawn at random (the
TEEncoders' and the MDWF Dense's biases spread, `test_torch_teaug.
_random_params`), converted by `ideal_gan_tpu_torch.convert`, which also
maps gradient trees. Nets have 2 levels of F=4 at 32² (the loss cases
build both packages' `build_model` nets with `num_layers=2`); the serving
closures run the JAX package's own `make_infer_run` at its 4 levels, at
64² so that no instance norm sees only 2×2 values. Tolerances:
- the nets' outputs rtol / atol 1e-4 and their parameter gradients to
  1e-3 of the global gradient scale (about twenty layers of float32 sums
  in another order; tests/test_torch_models.py, test_torch_teaug.py);
- the sup loss and every metric rtol 2e-5, its gradients to 1e-3 of
  scale;
- the serving maps rtol / atol 1e-4; the 2D-Net's ρ against the JAX fit
  of the port's own (φ, R2*) at the fit's tolerance, rtol 1e-4 / atol
  1e-5 (tests/test_torch_ops.py), since the fit turns a (φ, R2*)
  difference into up to e^{R2*·r2_sc·te}·2π·te·fm_sc times that in ρ, and
  the JAX package's initial 2D-Net reaches R2* 4.6 and φ 18;
- the records exactly (the same numpy code on the same files).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.cli import roi_analysis as jroi  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.data import layouts as jlayouts  # noqa: E402
from ideal_gan_tpu.data import records as jrecords  # noqa: E402
from ideal_gan_tpu.models import MDWFNet as JMDWFNet  # noqa: E402
from ideal_gan_tpu.models import UNet as JUNet  # noqa: E402
from ideal_gan_tpu.models import VETNet as JVETNet  # noqa: E402
from ideal_gan_tpu.train import sup as jsup  # noqa: E402
from ideal_gan_tpu.utils import Config  # noqa: E402
from ideal_gan_tpu_torch import convert, models, ops  # noqa: E402
from ideal_gan_tpu_torch.cli import (common, infer, roi_analysis,  # noqa: E402
                                     train_sup)
from ideal_gan_tpu_torch.data import layouts, records  # noqa: E402
from ideal_gan_tpu_torch.train import sup as tsup  # noqa: E402
from ideal_gan_tpu_torch.utils import Checkpoint, Config  # noqa: E402

from test_torch_infer import _flat  # noqa: E402
from test_torch_teaug import _grads, _random_params, _worst_grad  # noqa: E402

F_SMALL, LAYERS, SIZE, NE = 4, 2, 32, 6
SMALL = ["--device", "cpu", "--data_size", str(SIZE), "--n_G_filters",
         str(F_SMALL), "--batch_size", "2"]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The nets here are tiny: under the Tier-1 command's parallel workers
    torch's thread pool costs more time than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cohort():
    """Two synthetic slices (acquisitions, maps, TE train) at 32²."""
    return tuple(np.array(a) for a in j_synthetic(2, h=SIZE, w=SIZE, ne=NE))


def _net_parity(jm, p, tm, to_sd, args):
    """Forward and parameter gradients of the Flax net `jm` (params `p`)
    and the port's `tm` (loaded through `to_sd`) on the same inputs."""
    def j_loss(params):
        out = jm.apply({"params": params}, *map(jnp.asarray, args))
        return jnp.mean(jnp.square(out - 0.3)), out

    (_, ref), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(p)
    tm.load_state_dict(to_sd(p))
    out = tm(*map(_t, args))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-4,
                               atol=1e-4)
    torch.mean(torch.square(out - 0.3)).backward()
    assert _worst_grad(_grads(tm), to_sd(j_grads)) <= 1e-3
    return out


# --------------------------------------------------------------------------
# the legacy-layout nets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout,act,n_out", [("4d", "relu", 2),
                                              ("4d", "tanh", 4),
                                              ("5d", "sigmoid", 1)])
def test_unet_without_convlstm_matches_flax(cohort, layout, act, n_out):
    acqs = cohort[0]
    x = np.array(jlayouts.acqs_from_mebcrn(jnp.asarray(acqs))) \
        if layout == "4d" else acqs
    jm = JUNet(n_out=n_out, me_layer=False, filters=F_SMALL,
               num_layers=LAYERS, output_activation=act)
    p = _random_params(jm, 11, jnp.asarray(x[:1]))
    tm = models.UNet(x.shape[-1], n_out=n_out, me_layer=False,
                     filters=F_SMALL, num_layers=LAYERS,
                     output_activation=act)
    assert tm.lstm is None
    out = _net_parity(jm, p, tm, functools.partial(convert.unet,
                                                   num_layers=LAYERS), (x,))
    assert out.shape == x.shape[:-1] + (n_out,)


@pytest.mark.parametrize("layout", ["4d", "5d"])
def test_vetnet_without_convlstm_matches_flax(cohort, layout):
    """The two-decoder PM generator without the ConvLSTM: [R2*, FM]
    channel-last (the ME form's order is [FM, R2*])."""
    acqs = cohort[0]
    x = np.array(jlayouts.acqs_from_mebcrn(jnp.asarray(acqs))) \
        if layout == "4d" else acqs
    jm = JVETNet(me_layer=False, te_input=False, n_out=1, filters=F_SMALL,
                 num_layers=LAYERS)
    p = _random_params(jm, 12, jnp.asarray(x[:1]))
    tm = models.VETNet(x.shape[-1], me_layer=False, filters=F_SMALL,
                       num_layers=LAYERS)
    out = _net_parity(jm, p, tm, functools.partial(convert.vetnet,
                                                   num_layers=LAYERS), (x,))
    assert out.shape == x.shape[:-1] + (2,)


@pytest.mark.parametrize("te_input", [True, False])
def test_mdwfnet_matches_flax(cohort, te_input):
    """MDWF-Net's three decoders [|W|, |F|, R2*, FM]; with te_input the
    "dense_l1" TE mode (a Dense + ReLU of the TE vector added at level
    1)."""
    acqs = cohort[0]
    x = np.array(jlayouts.acqs_from_mebcrn(jnp.asarray(acqs)))
    te_vec = np.array(cohort[2][..., 0]) * np.array([[1.0], [30.0]],
                                                    np.float32)
    jm = JMDWFNet(filters=F_SMALL, num_layers=LAYERS, te_input=te_input,
                  wf_self_attention=True)
    p = _random_params(jm, 13, jnp.asarray(x[:1]), jnp.asarray(te_vec[:1]))
    assert ("Dense_0" in p["_SharedEncoder_0"]) == te_input
    tm = models.MDWFNet(2 * NE, filters=F_SMALL, num_layers=LAYERS,
                        te_input=te_input, n_echoes=NE,
                        wf_self_attention=True)
    out = _net_parity(jm, p, tm, functools.partial(convert.mdwfnet,
                                                   num_layers=LAYERS),
                      (x, te_vec))
    assert out.shape == (2, SIZE, SIZE, 4)
    with pytest.raises(ValueError, match="legacy"):
        tm(_t(acqs), _t(te_vec))


def test_converter_counts_every_leaf(cohort):
    jm = JMDWFNet(filters=F_SMALL, num_layers=LAYERS, te_input=True)
    x = np.array(jlayouts.acqs_from_mebcrn(jnp.asarray(cohort[0][:1])))
    p = _random_params(jm, 14, jnp.asarray(x), jnp.asarray(cohort[2][:1,
                                                                    :, 0]))
    p["dec_wf"]["stray"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="Flax leaves"):
        convert.mdwfnet(p, LAYERS)


# --------------------------------------------------------------------------
# generator selection and the loss
# --------------------------------------------------------------------------

SUP_CASES = {
    "multi-decod-WF": dict(G_model="multi-decod", out_vars="WF"),
    "multi-decod-PM": dict(G_model="multi-decod", out_vars="PM",
                           R2_TV_weight=1e-3, FM_L1_weight=1e-2),
    "multi-decod-WF-PM": dict(G_model="multi-decod", out_vars="WF-PM",
                              sigma_noise=0.05, FM_TV_weight=1e-3,
                              R2_L1_weight=1e-2),
    "U-Net-WF": dict(G_model="U-Net", out_vars="WF", sigma_noise=0.05),
    "U-Net-WFc": dict(G_model="U-Net", out_vars="WFc"),
    "U-Net-PM": dict(G_model="U-Net", out_vars="PM", R2_TV_weight=1e-3,
                     FM_TV_weight=1e-3, R2_L1_weight=1e-2,
                     FM_L1_weight=1e-2),
    "U-Net-WF-PM": dict(G_model="U-Net", out_vars="WF-PM",
                        FM_TV_weight=1e-3, FM_L1_weight=1e-2),
    # a TE protocol other than the default: A resynthesized from B
    "U-Net-PM-resynthesis": dict(G_model="U-Net", out_vars="PM",
                                 TE1=0.0014, dTE=0.0022, sigma_noise=0.05,
                                 R2_TV_weight=1e-3),
}


def _j_nets(cfg):
    return jsup.build_model(cfg).clone(num_layers=LAYERS)


@pytest.fixture
def two_level_port(monkeypatch):
    """`train.sup.build_model` choosing among 2-level nets."""
    for name in ("UNet", "VETNet", "MDWFNet"):
        monkeypatch.setattr(tsup, name, functools.partial(
            getattr(models, name), num_layers=LAYERS))


def _to_sd(cfg, tree, num_layers=LAYERS):
    if cfg["G_model"] == "U-Net":
        return convert.unet(tree, num_layers)
    if cfg["out_vars"] == "WF-PM":
        return convert.mdwfnet(tree, num_layers)
    return convert.vetnet(tree, num_layers)


@pytest.mark.parametrize("case", SUP_CASES)
def test_build_model_matches_jax(case):
    """The net each setting selects, at the published depth: the same
    parameter tree (every Flax leaf at its converted shape) and head."""
    cfg = dict(jsup.DEFAULTS, n_G_filters=F_SMALL, **SUP_CASES[case])
    x = jnp.zeros((1, SIZE, SIZE, 2 * NE))
    shapes = jax.eval_shape(jsup.build_model(cfg).init,
                            jax.random.PRNGKey(0), x)["params"]
    want = _to_sd(cfg, jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes), 4)
    got = tsup.build_model(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} \
        == {k: tuple(v.shape) for k, v in want.items()}


def test_build_model_errors():
    for over in (dict(G_model="multi-decod", out_vars="WFc"),
                 dict(G_model="MEBCRN")):
        cfg = dict(tsup.DEFAULTS, **over)
        with pytest.raises(NameError):
            jsup.build_model(cfg)
        with pytest.raises(NameError):
            tsup.build_model(cfg)
    # bf16 and remat are ported: the same state-dict names
    small = dict(tsup.DEFAULTS, n_G_filters=4)
    keys = set(tsup.build_model(small).state_dict())
    for over in (dict(bf16=True), dict(remat=True), dict(microbatch=2)):
        assert set(tsup.build_model(dict(small, **over))
                   .state_dict()) == keys


@pytest.mark.parametrize("case", SUP_CASES)
def test_sup_loss_matches_jax(cohort, two_level_port, case):
    acqs, maps, te = cohort
    cfg = dict(jsup.DEFAULTS, n_G_filters=F_SMALL, **SUP_CASES[case])
    jm = _j_nets(cfg)
    x = jlayouts.acqs_from_mebcrn(jnp.asarray(acqs[:1]))
    p = _random_params(jm, 21, x)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, (2, SIZE, SIZE, 2 * NE)))
    (j_val, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        jsup.make_loss_fn(cfg, jm), has_aux=True))(
            p, jnp.asarray(acqs), jnp.asarray(maps), jnp.asarray(te), key)

    tm = tsup.build_model(cfg)
    tm.load_state_dict(_to_sd(cfg, p))
    loss, metrics = tsup.make_loss_fn(cfg, tm)(_t(acqs), _t(maps), _t(te),
                                               _t(noise))
    loss.backward()
    assert set(metrics) == set(j_metrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(j_metrics[k]), rtol=2e-5, atol=1e-7,
                                   err_msg=k)
    assert abs(float(loss.detach()) - float(j_val)) \
        / max(abs(float(j_val)), 1.0) <= 2e-5
    assert float(j_val) > 0
    assert _worst_grad(_grads(tm), _to_sd(cfg, j_grads)) <= 1e-3


def test_sup_train_and_eval_steps_on_cpu(cohort):
    acqs, maps, te = (_t(a) for a in cohort)
    cfg = dict(tsup.DEFAULTS, G_model="U-Net", out_vars="PM",
               n_G_filters=F_SMALL, epochs=2, lr=2e-3, sigma_noise=0.05)
    model = tsup.build_model(cfg)
    step, tx = tsup.make_train_step(cfg, model)
    evaluate = tsup.make_eval_step(cfg, model)
    state = tsup.init_state(cfg, model, tx, torch.Generator().manual_seed(0),
                            "cpu")
    first = evaluate(state, (acqs, maps, te), torch.Generator().manual_seed(1))
    assert not any(q.grad is not None for q in model.parameters())
    losses = []
    for _ in range(5):
        state, m = step(state, (acqs, maps, te),
                        torch.Generator().manual_seed(1))
        losses.append(float(m["G_loss"]))
    assert state.step == state.opt.count == 5
    assert losses[-1] < losses[0]
    assert float(first["G_loss"]) == pytest.approx(losses[0], rel=1e-6)
    assert set(first) == set(m)


# --------------------------------------------------------------------------
# records
# --------------------------------------------------------------------------

def test_records_match_jax(tmp_path):
    rng = np.random.default_rng(31)
    arrays = [(rng.normal(size=(n, NE, 8, 8, 2)).astype(np.float32),
               rng.normal(size=(n, 3, 8, 8, 2)).astype(np.float32))
              for n in (3, 2)]
    assert jrecords.write_shard(tmp_path / "LDM_ds_0", *arrays[0]) \
        == records.write_shard(tmp_path / "j" / "LDM_ds_0", *arrays[0]) \
        .replace("/j/", "/")
    records.write_shard(tmp_path / "LDM_ds_1.npz", *arrays[1])
    (tmp_path / "other.npz").write_bytes(
        (tmp_path / "LDM_ds_1.npz").read_bytes())
    shards = records.list_shards(str(tmp_path), prefix="LDM_ds")
    assert shards == jrecords.list_shards(str(tmp_path), prefix="LDM_ds")
    assert len(shards) == 2
    got, want = records.read_shards(shards), jrecords.read_shards(shards)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], np.concatenate(
        [arrays[0][0], arrays[1][0]]))
    for (ga, gm), (wa, wm) in zip(records.iter_shards(shards),
                                  jrecords.iter_shards(shards)):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gm, wm)
    real = (arrays[1][0] + 1, arrays[1][1] + 1)
    for n in (0, 1, 5):
        for g, w in zip(records.mix_partial_real(*got, *real, n),
                        jrecords.mix_partial_real(*got, *real, n)):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

SERVE_SETTINGS = {"2D-Net": {}, "U-Net": {"out_vars": "WF-PM"},
                  "MDWF": {}}


@pytest.mark.parametrize("sel", SERVE_SETTINGS)
def test_sup_serving_matches_jax(tmp_path, sel):
    """The JAX package's `make_infer_run` of the selector on an experiment
    without a checkpoint (its settings at F=4; it serves the initial
    weights of `PRNGKey(0)`), and the port's closure on those weights
    (`--weights`)."""
    acqs, _, te = (np.array(a) for a in j_synthetic(3, h=64, w=64, ne=NE))
    exp = tmp_path / "exp"
    Config(dict(n_G_filters=F_SMALL, **SERVE_SETTINGS[sel])).save(
        exp / "settings.yml")
    cfg = dict(jroi.DEFAULTS, model_sel=sel, experiment_dir=str(exp))
    j_run = jroi.make_infer_run(cfg, acqs)
    ref = np.asarray(j_run(jnp.asarray(acqs), jnp.asarray(te))[0])

    # the weights that closure serves
    scfg = dict(jsup.DEFAULTS, n_G_filters=F_SMALL)
    scfg.update({"2D-Net": dict(G_model="U-Net", out_vars="PM"),
                 "U-Net": dict(G_model="U-Net", out_vars="WF-PM"),
                 "MDWF": dict(out_vars="WF-PM")}[sel])
    jm = jsup.build_model(scfg)
    _, tx = jsup.make_train_step(scfg, jm)
    p = jsup.init_state(scfg, jm, tx, jax.random.PRNGKey(0),
                        acqs[:1]).params
    weights = tmp_path / "w.npz"
    np.savez(weights, **_flat(p, "params/"))

    pcfg = dict(infer.DEFAULTS, model_sel=sel, weights=str(weights))
    _, got_cfg = roi_analysis.load_sup_model(pcfg, "cpu")
    assert (got_cfg["G_model"], got_cfg["out_vars"], got_cfg["n_G_filters"]) \
        == (scfg["G_model"], scfg["out_vars"], F_SMALL)
    run = roi_analysis.make_infer_run(pcfg, acqs, device="cpu")
    # batch 2 over 3 slices: the last chunk is padded, then trimmed
    maps, var = roi_analysis._per_slice(run, acqs, te, 2, device="cpu")
    assert maps.shape == ref.shape == (3, 3, 64, 64, 2)
    assert var.shape == (3, 4, 64, 64, 1) and not var.any()
    assert np.abs(ref).max() > 0.1
    if sel != "2D-Net":
        np.testing.assert_allclose(maps, ref, rtol=1e-4, atol=1e-4)
        return
    # the net's (φ, R2*); then the fit, against the JAX fit of the port's
    # own (φ, R2*) at the fit's tolerance: at this initialization R2* reaches
    # 4.6 (900 s⁻¹) and φ 18, where e^{R2*·te} and the phase amplify the
    # nets' 5e-5 difference up to 2e-2 in ρ
    np.testing.assert_allclose(maps[:, 2], ref[:, 2], rtol=1e-4, atol=1e-4)
    own = np.asarray(jph.fit_rho(jnp.asarray(acqs), jnp.asarray(maps[:, 2:3]),
                                 jnp.asarray(te)))
    np.testing.assert_allclose(maps[:, :2], own, rtol=1e-4, atol=1e-5)


def test_graphcuts_raises():
    with pytest.raises(SystemExit, match="GraphCuts"):
        roi_analysis.make_infer_run(dict(infer.DEFAULTS,
                                         model_sel="GraphCuts"), None, "cpu")


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_2d_net_round_trip_serves_the_checkpoint(tmp_path, capsys):
    """train_sup (U-Net, PM, resynthesis at another TE protocol) → `infer
    --model_sel 2D-Net --experiment_dir`, which serves the run's newest
    checkpoint: the restored net and the fit by hand on the same slices."""
    out = train_sup.main(SMALL + [
        "--synthetic", "6", "--G_model", "U-Net", "--out_vars", "PM",
        "--TE1", "0.0014", "--dTE", "0.0022", "--epochs", "1",
        "--output_base", str(tmp_path / "run")])
    assert out["state"].step == 2  # 2 of the 6 slices held out
    exp = tmp_path / "run" / tsup.DEFAULTS["dataset"]
    maps = infer.main(["--device", "cpu", "--model_sel", "2D-Net",
                       "--experiment_dir", str(exp), "--synthetic", "2",
                       "--data_size", str(SIZE), "--infer_batch", "2",
                       "--output_base", str(tmp_path / "s")])
    assert "serving the epoch-1 checkpoint" in capsys.readouterr().out
    acqs, _, te = common.synthetic_dataset(2, h=SIZE, w=SIZE, ne=NE)
    model = tsup.build_model(dict(tsup.DEFAULTS, G_model="U-Net",
                                  out_vars="PM", n_G_filters=F_SMALL))
    model.load_state_dict(Checkpoint(exp / "checkpoints").restore()["model"])
    a = _t(acqs)
    with torch.no_grad():
        out = model.eval()(layouts.acqs_from_mebcrn(a))
        pm = layouts.maps_to_mebcrn(torch.cat(
            [out[..., :1], (out[..., 1:] - 0.5) * 2], -1), mode="PM")
        rho = ops.fit_rho_fused(a, pm, _t(te))
    np.testing.assert_allclose(maps, torch.cat([rho, pm], 1).numpy(),
                               rtol=1e-6, atol=1e-6)
    seeded = tmp_path / "seeded"
    seeded.mkdir()
    (seeded / "settings.yml").write_text((exp / "settings.yml").read_text())
    run = roi_analysis.make_infer_run(
        dict(infer.DEFAULTS, model_sel="2D-Net", experiment_dir=str(seeded)),
        acqs, "cpu")
    seeded_maps = roi_analysis._per_slice(run, acqs, te, 2, "cpu")[0]
    assert np.abs(maps - seeded_maps).max() > 1e-3


def test_cli_validation_checkpoints_and_resumes(tmp_path, capsys):
    base = SMALL + ["--synthetic", "6", "--output_base", str(tmp_path)]
    out = train_sup.main(base + ["--epochs", "1"])
    # 6 slices > 2 batches: 2 held out, 4 left for 2 steps
    assert out["state"].step == 2
    ep = out["epochs"][0]
    assert ep["steps"] == 2 and set(ep["val"]) >= {"G_loss", "WF_loss"}
    assert all(np.isfinite(v) for v in ep["val"].values())
    ckdir = tmp_path / tsup.DEFAULTS["dataset"] / "checkpoints"
    saved = Checkpoint(ckdir).restore(1)
    again = train_sup.main(base + ["--epochs", "2"])
    assert [e["epoch"] for e in again["epochs"]] == [2]
    assert again["state"].opt.count == saved["opt"]["count"] + 2
    text = capsys.readouterr().out
    assert "resumed from epoch 1" in text
    assert "epoch 2/2 G_loss=" in text and "val_G_loss=" in text
    settings = Config.load(tmp_path / "WF-sup" / "settings.yml")
    assert settings["G_model"] == "multi-decod"


def test_cli_trains_on_generated_shards(tmp_path):
    """--DL_gen: npz shards of mag/phase maps, converted to complex rows."""
    acqs, maps, _ = common.synthetic_dataset(4, h=SIZE, w=SIZE, ne=NE)
    rng = np.random.default_rng(4)
    mp = rng.uniform(0.0, 1.0, maps.shape).astype(np.float32)
    records.write_shard(tmp_path / "gen" / "LDM_ds_0", acqs, mp)
    out = train_sup.main(SMALL + ["--DL_gen", "true", "--DL_gen_dir",
                                  str(tmp_path / "gen"), "--epochs", "1",
                                  "--output_base", str(tmp_path)])
    assert out["state"].step == 2
    assert np.isfinite(out["epochs"][0]["G_loss"])
    with pytest.raises(FileNotFoundError, match="shards"):
        train_sup.main(SMALL + ["--DL_gen", "true", "--DL_gen_dir",
                                str(tmp_path / "none"), "--output_base",
                                str(tmp_path)])


def test_cli_rejects_unported_settings(tmp_path):
    """bf16, remat and microbatch are ported; a microbatch that does not
    divide the batch is rejected, as in the JAX package."""
    with pytest.raises(ValueError, match="divisible"):
        train_sup.main(SMALL + ["--synthetic", "2", "--output_base",
                                str(tmp_path), "--microbatch", "3"])


def test_cli_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_sup.main(["--synthetic", "2", "--data_size", "32",
                        "--batch_size", "2", "--n_G_filters", "4",
                        "--output_base", str(tmp_path)])
    model = tsup.build_model(dict(tsup.DEFAULTS, n_G_filters=4))
    _, tx = tsup.make_train_step(tsup.DEFAULTS, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsup.init_state(tsup.DEFAULTS, model, tx, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        roi_analysis.make_infer_run(dict(infer.DEFAULTS, model_sel="2D-Net"),
                                    None)
