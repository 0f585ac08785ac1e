"""The port's ROI evaluation against the JAX package's on the same inputs:
`eval.roi` and `eval.export` (exact: the same numpy arithmetic), the
ROI picker driven by fake events, `eval.stats` and `cli.stats_analysis`
(exact), `cli.roi_analysis.main` and `cli.roi_realphantom.main` on a
synthetic 32² cohort (the JAX CLI's seeded AI-DEAL weights carried across
with `--weights`; workbooks read back by `read_xlsx`, held to 1e-4 PDFF),
`cli.infer --export png` (the same pixels), and the port's phantom check
on the CPU against `tools/phantom_parity.py`'s per-vial medians (1e-5)
and `PHANTOM_PARITY.json` (5e-4, the chip gate).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import optax  # noqa: E402

from ideal_gan_tpu.cli import infer as jinfer  # noqa: E402
from ideal_gan_tpu.cli import roi_analysis as jroi_cli  # noqa: E402
from ideal_gan_tpu.cli import roi_realphantom as jphantom_cli  # noqa: E402
from ideal_gan_tpu.cli import stats_analysis as jstats_cli  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synth  # noqa: E402
from ideal_gan_tpu.eval import export as jexport  # noqa: E402
from ideal_gan_tpu.eval import roi as jroi  # noqa: E402
from ideal_gan_tpu.eval import stats as jstats  # noqa: E402
from ideal_gan_tpu.eval.tracker import IndexTracker as JTracker  # noqa: E402
from ideal_gan_tpu.train import unsup as junsup  # noqa: E402
from ideal_gan_tpu_torch.cli import infer, roi_analysis  # noqa: E402
from ideal_gan_tpu_torch.cli import phantom_parity as pp  # noqa: E402
from ideal_gan_tpu_torch.cli import roi_realphantom, stats_analysis  # noqa: E402
from ideal_gan_tpu_torch.eval import export, roi, stats  # noqa: E402
from ideal_gan_tpu_torch.eval.tracker import NO_ROI, IndexTracker  # noqa: E402
from ideal_gan_tpu_torch.utils import Config  # noqa: E402

from test_torch_infer import _flat  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PDFF_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maps(n=3, h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 3, h, w, 2)).astype(np.float32)
    m[0, :2, :3] = 0.0  # |W+F| = 0 voxels
    return m


def _crops(path, n=3, seed=1, two=True):
    rng = np.random.default_rng(seed)
    c1 = rng.integers(0, 10, size=(n, 2))
    c2 = [tuple(c) if (two and i != 1) else NO_ROI
          for i, c in enumerate(rng.integers(0, 10, size=(n, 2)))]
    export.save_crops(str(path), np.arange(n), c1, c2)
    return path


@pytest.mark.parametrize("disc", [False, True])
def test_roi_functions_match_jax(tmp_path, disc):
    maps = _maps()
    got, want = roi.maps_to_display(maps, disc), jroi.maps_to_display(maps,
                                                                      disc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    pdff = got[0]
    crops = str(_crops(tmp_path / "c.npy"))
    for stat in ("median", "mean"):
        assert roi.roi_stats(pdff, crops, stat) == \
            roi.ROIResult(**vars(jroi.roi_stats(pdff, crops, stat)))
    assert roi.roi_median(pdff[0], 3, 4, 5) == jroi.roi_median(pdff[0], 3, 4,
                                                               5)
    assert roi.roi_mean(pdff[2], 1, 2) == jroi.roi_mean(pdff[2], 1, 2)
    # the phantom pipelines: 2 slices of 4 vial ROIs, the last 3
    export.save_crops(str(tmp_path / "v.npy"), [0, 0, 0, 0, 1, 1, 1],
                      [(0, 0), (4, 4), (8, 2), (2, 9), (1, 1), (5, 5),
                       (9, 9)], [NO_ROI] * 7)
    v = str(tmp_path / "v.npy")
    per, bias = roi.phantom_bias(pdff, v)
    jper, jbias = jroi.phantom_bias(pdff, v)
    assert per == jper
    assert {g: b for g, b in bias.items() if per[g]} == \
        {g: b for g, b in jbias.items() if per[g]}
    assert all(np.isnan(b) for g, b in bias.items() if not per[g])
    assert roi.phantom_per_slice(pdff, v) == jroi.phantom_per_slice(pdff, v)
    err, within = roi.bias_histogram([0.1, 0.2, 0.5], [0.11, 0.3, 0.5],
                                     0.03)
    jerr, jwithin = jroi.bias_histogram([0.1, 0.2, 0.5], [0.11, 0.3, 0.5],
                                        0.03)
    np.testing.assert_array_equal(err, jerr)
    assert within == jwithin == 2 / 3
    assert roi.PHANTOM_GT_VALS == jroi.PHANTOM_GT_VALS == pp.GT_VALS


def test_workbooks_match_jax(tmp_path):
    pdff = roi.maps_to_display(_maps())[0]
    crops = str(_crops(tmp_path / "c.npy"))
    res_m = roi.roi_stats(pdff, crops)
    res_r = roi.roi_stats(pdff * 0.9, crops)
    roi.export_roi_xlsx(str(tmp_path / "p.xlsx"), res_m, res_r, "PDFF")
    jroi.export_roi_xlsx(str(tmp_path / "j.xlsx"), res_m, res_r, "PDFF")
    per, bias = roi.phantom_bias(pdff, crops)
    per_slice = roi.phantom_per_slice(pdff, crops)
    roi.export_phantom_xlsx(str(tmp_path / "pp.xlsx"), per, bias, per_slice)
    jroi.export_phantom_xlsx(str(tmp_path / "jp.xlsx"), per, bias, per_slice)
    for a, b in (("p", "j"), ("pp", "jp")):
        got = export.read_xlsx(str(tmp_path / f"{a}.xlsx"))
        assert got == jexport.read_xlsx(str(tmp_path / f"{b}.xlsx"))
        assert got == export.read_xlsx(str(tmp_path / f"{b}.xlsx"))
    book = export.read_xlsx(str(tmp_path / "p.xlsx"))
    assert book["RHL"][0] == ["Slice", "Reference PDFF", "Model PDFF", "Bias"]
    assert len(book["RHL"]) == 4 and len(book["LHL"]) == 3
    # strings, non-finite numbers and escaping
    wb = export.XlsxWriter(str(tmp_path / "s.xlsx"))
    ws = wb.add_worksheet("a<&>")
    ws.write_row(0, ["x & y", 1.5, float("nan"), 3])
    wb.close()
    assert export.read_xlsx(str(tmp_path / "s.xlsx")) == \
        jexport.read_xlsx(str(tmp_path / "s.xlsx")) == \
        {"a<&>": [["x & y", 1.5, "nan", 3]]}
    frms, c1, c2 = export.load_crops(crops)
    for x, y in zip((frms, c1, c2), jexport.load_crops(crops)):
        np.testing.assert_array_equal(x, y)


class _Event:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_tracker_matches_jax_by_fake_events(tmp_path):
    stack = np.random.default_rng(2).random((32, 32, 3)).astype(np.float32)
    events = [("button_press", dict(xdata=10.0, ydata=12.0)),
              ("button_press", dict(xdata=20.0, ydata=22.0)),
              ("button_press", dict(xdata=5.0, ydata=5.0)),  # a third: no
              ("key_press", dict(key="s")),
              ("onscroll", dict(button="up")),
              ("button_press", dict(xdata=12.0, ydata=12.0)),
              ("button_press", dict(xdata=None, ydata=3.0)),  # off-axes
              ("key_press", dict(key="s")),
              ("onscroll", dict(button="up")),
              ("button_press", dict(xdata=14.0, ydata=14.0)),
              ("button_press", dict(xdata=24.0, ydata=24.0)),
              ("key_press", dict(key="s")),
              ("onscroll", dict(button="down")),
              ("key_press", dict(key="e")),
              ("onscroll", dict(button="down")),
              ("onscroll", dict(button="down"))]
    trackers = []
    for cls, name in ((IndexTracker, "p.npy"), (JTracker, "j.npy")):
        tr = cls(None, None, stack, npy_file=str(tmp_path / name))
        for method, kw in events:
            getattr(tr, method)(_Event(**kw))
        trackers.append(tr)
    p, j = trackers
    assert (p.ind, p.frms, p.crops_1, p.crops_2) == \
        (j.ind, j.frms, j.crops_1, j.crops_2)
    assert p.frms == [0, 2] and p.crops_2 == [(16, 18), (20, 20)]
    for x, y in zip(export.load_crops(str(tmp_path / "p.npy")),
                    jexport.load_crops(str(tmp_path / "j.npy"))):
        np.testing.assert_array_equal(x, y)
    # a reload continues from the file, a legacy short crops_2 is padded
    assert IndexTracker(None, None, stack,
                        npy_file=str(tmp_path / "p.npy")).frms == [0, 2]
    export.save_crops(str(tmp_path / "old.npy"), [0, 1], [(4, 4), (6, 6)],
                      [(4, 12)])
    assert len(IndexTracker(None, None, stack,
                            npy_file=str(tmp_path / "old.npy")).crops_2) == 2


@pytest.fixture(scope="module")
def cohort():
    acqs, maps, te = (np.asarray(x) for x in j_synth(3, h=32, w=32, ne=6))
    return acqs, maps, te


@pytest.fixture(scope="module")
def aideal(tmp_path_factory, cohort):
    """A JAX experiment directory at F=4 with no checkpoint (its CLI serves
    the seeded Flax init) and that init's parameters as an .npz."""
    root = tmp_path_factory.mktemp("aideal")
    exp = root / "exp"
    exp.mkdir()
    Config(n_G_filters=4).save(exp / "settings.yml")
    ucfg = dict(junsup.DEFAULTS, n_G_filters=4)
    g_fm, g_r2 = junsup.build_models(ucfg)
    state = junsup.init_state(ucfg, g_fm, g_r2, optax.adam(1e-4),
                              jax.random.PRNGKey(0), cohort[0][:1])
    weights = root / "w.npz"
    np.savez(weights, **_flat(state.params_fm, "params_fm/"),
             **_flat(state.params_r2, "params_r2/"),
             fm_offset=np.asarray(state.fm_offset))
    crops = root / "crops.npy"
    export.save_crops(str(crops), [0, 1, 2], [(8, 9), (12, 14), (10, 6)],
                      [(16, 12), NO_ROI, (6, 16)])
    return dict(exp=exp, weights=weights, crops=crops, root=root)


COMMON = ["--synthetic", "3", "--data_size", "32"]


@pytest.mark.parametrize("map_name", ["PDFF", "R2s"])
def test_roi_analysis_main_matches_jax(aideal, map_name):
    out = aideal["root"] / map_name
    base = COMMON + ["--model_sel", "AI-DEAL", "--map", map_name,
                     "--crops_file", str(aideal["crops"]), "--dataset", "r",
                     "--te_suffix", "true", "--te1", "0.0014", "--dte",
                     "0.0022"]
    jroi_cli.main(base + ["--experiment_dir", str(aideal["exp"]),
                          "--compile_cache", "", "--output_base",
                          str(out / "jax")])
    res = roi_analysis.main(base + ["--weights", str(aideal["weights"]),
                                    "--device", "cpu", "--infer_batch", "2",
                                    "--output_base", str(out / "port")])
    name = f"{map_name}_ROIs_14_22.xlsx"
    assert res["xlsx"] == out / "port" / "r" / name
    got = export.read_xlsx(str(res["xlsx"]))
    want = export.read_xlsx(str(out / "jax" / "r" / name))
    assert set(got) == set(want) == {"RHL", "LHL"}
    tol = PDFF_TOL * (200.0 if map_name == "R2s" else 1.0)
    for sheet in got:
        assert got[sheet][0] == want[sheet][0]
        g, w = np.array(got[sheet][1:]), np.array(want[sheet][1:])
        assert g.shape == w.shape == ((3, 4) if sheet == "RHL" else (2, 4))
        np.testing.assert_array_equal(g[:, :2], w[:, :2])  # slice, GT
        np.testing.assert_allclose(g[:, 2:], w[:, 2:], rtol=0, atol=tol)
    assert Config.load(out / "port" / "r" / "settings_roi.yml")["map"] == \
        map_name


def test_roi_realphantom_main_matches_jax(aideal, tmp_path):
    crops = tmp_path / "vials.npy"
    export.save_crops(str(crops), [0] * 4 + [1] * 4,
                      [(4, 4), (12, 8), (18, 18), (8, 20)] * 2,
                      [NO_ROI] * 8)
    base = COMMON + ["--crops_file", str(crops), "--dataset", "ph"]
    books = {}
    for map_name in ("PDFF", "R2s"):
        jphantom_cli.main(base + ["--map", map_name, "--compile_cache", "",
                                  "--output_base", str(tmp_path / "jax"),
                                  "--out_xlsx", f"{map_name}.xlsx"])
        res = roi_realphantom.main(base + ["--map", map_name, "--device",
                                           "cpu", "--out_xlsx",
                                           f"{map_name}.xlsx",
                                           "--output_base",
                                           str(tmp_path / "port")])
        got = export.read_xlsx(str(res["xlsx"]))
        want = export.read_xlsx(str(tmp_path / "jax" / "ph" /
                                    f"{map_name}.xlsx"))
        assert list(got) == list(want) == ["Phantom", "Slice_0", "Slice_1"]
        tol = PDFF_TOL * (200.0 if map_name == "R2s" else 1.0)
        for sheet in got:
            assert got[sheet][0] == want[sheet][0]
            for g, w in zip(got[sheet][1:], want[sheet][1:]):
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    if isinstance(b, str):  # nan
                        assert a == b
                    else:
                        assert abs(a - b) <= tol, (sheet, g, w)
        books[map_name] = res["xlsx"]
    # the statistics on the port's workbook and on JAX's, phantom mode
    for mod, out, d in ((stats_analysis, "sp", "port"),
                        (jstats_cli, "sj", "jax")):
        arg = ",".join(f"{m}={tmp_path / d / 'ph' / 'PDFF.xlsx'}"
                       for m in ("A", "B"))
        r = mod.main(["--dataset", "st", "--mode", "phantom", "--xlsx", arg,
                      "--output_base", str(tmp_path / out)]
                     + (["--compile_cache", ""] if d == "jax" else []))
        books[out] = r
    for m in ("A", "B"):
        for k, v in books["sp"]["by_method"][m].items():
            assert abs(v - books["sj"]["by_method"][m][k]) <= 100 * PDFF_TOL
    assert (tmp_path / "sp" / "st" / "PDFF-A-Bias-BlandAltman.png").exists()


def test_stats_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    refs = rng.random(40)
    meas = refs + rng.normal(scale=0.02, size=40)
    groups = np.repeat(["a", "b", "c", "d"], 10)
    assert stats.summary_stats(meas) == jstats.summary_stats(meas)
    assert stats.bias_loa(refs, meas) == jstats.bias_loa(refs, meas)
    assert stats.group_bias_loa(refs, meas, groups) == \
        jstats.group_bias_loa(refs, meas, groups)
    for k, v in stats.bland_altman(refs, meas).items():
        np.testing.assert_array_equal(v, jstats.bland_altman(refs, meas)[k])
    assert stats.regression(refs, meas) == jstats.regression(refs, meas)
    assert stats.wilcoxon_paired(refs, meas) == \
        jstats.wilcoxon_paired(refs, meas)
    assert stats.pairwise_wilcoxon(meas, groups) == \
        jstats.pairwise_wilcoxon(meas, groups)
    np.testing.assert_array_equal(stats.extreme_outliers(meas),
                                  jstats.extreme_outliers(meas))
    X = np.stack([np.ones(40), refs], 1)
    factors = {"sheet": np.tile(np.arange(5), 8), "method": groups}
    fit = stats.fit_lmm(meas - refs, X, factors, fixed_names=["i", "r"])
    jfit = jstats.fit_lmm(meas - refs, X, factors, fixed_names=["i", "r"])
    np.testing.assert_array_equal(fit.beta, jfit.beta)
    assert fit.summary() == jfit.summary()
    red = stats.fit_lmm(meas - refs, X, {"sheet": factors["sheet"]},
                        reml=False)
    full = stats.fit_lmm(meas - refs, X, factors, reml=False)
    assert stats.lrt_anova(red, full) == jstats.lrt_anova(
        jstats.fit_lmm(meas - refs, X, {"sheet": factors["sheet"]},
                       reml=False),
        jstats.fit_lmm(meas - refs, X, factors, reml=False))


def test_stats_analysis_invivo_matches_jax(tmp_path):
    pdff = roi.maps_to_display(_maps(n=6, seed=5))[0]
    crops = str(_crops(tmp_path / "c.npy", n=6))
    paths = []
    for i, k in enumerate((0.9, 1.1)):
        p = tmp_path / f"w{i}.xlsx"
        roi.export_roi_xlsx(str(p), roi.roi_stats(pdff * k, crops),
                            roi.roi_stats(pdff, crops))
        paths.append(f"P{i}={p}")
    arg = ",".join(paths)
    got = stats_analysis.main(["--dataset", "iv", "--xlsx", arg,
                               "--output_base", str(tmp_path / "p")])
    want = jstats_cli.main(["--dataset", "iv", "--xlsx", arg,
                            "--compile_cache", "", "--output_base",
                            str(tmp_path / "j")])
    assert got.keys() == want.keys()
    assert got["wilcoxon"] == want["wilcoxon"]
    for k in ("P0", "P1"):
        assert got[k]["summary"] == want[k]["summary"]
        assert got[k]["bias"] == want[k]["bias"]
    assert (tmp_path / "p" / "iv" / "LS-corr-P0.png").exists()
    with pytest.raises(SystemExit):
        stats_analysis.main(["--dataset", "iv", "--output_base",
                             str(tmp_path / "p")])


def test_infer_png_export_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from matplotlib.image import imread
    maps = _maps(n=3, h=32, w=32, seed=6)
    cfg = dict(infer.DEFAULTS, n_plot=2)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = infer.export_png(tmp_path / "p", cfg, maps)
    want = jinfer.export_png(tmp_path / "j", cfg,
                             jinfer._display_planes(maps))
    np.testing.assert_array_equal(imread(got), imread(want))
    # through the CLI, with the npz beside it
    out = infer.main(["--device", "cpu", "--model_sel", "Mag", "--synthetic",
                      "2", "--data_size", "32", "--infer_batch", "2",
                      "--export", "npz,png", "--output_base",
                      str(tmp_path / "cli")])
    assert out.shape == (2, 3, 32, 32, 2)
    assert (tmp_path / "cli" / "infer" / "panels.png").stat().st_size > 0
    assert (tmp_path / "cli" / "infer" / "maps_pred.npz").exists()


def _jax_phantom_tool():
    spec = importlib.util.spec_from_file_location(
        "phantom_parity_tool", ROOT / "tools" / "phantom_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("field", [1.5, 3.0])
def test_phantom_matches_jax_and_parity_file(field):
    tool = _jax_phantom_tool()
    acqs, maps, te, masks = pp.build_phantom(field, "cpu")
    j_acqs, j_maps, j_te, j_masks = tool.build_phantom(field)
    np.testing.assert_array_equal(maps.numpy(), j_maps)
    np.testing.assert_array_equal(te.numpy(), j_te)
    np.testing.assert_allclose(acqs.numpy(), j_acqs, rtol=0, atol=1e-6)
    assert all((masks[k] == j_masks[k]).all() for k in j_masks)
    pdff_c, pdff_m = pp.run_port(acqs, maps, te, field)
    j_c, j_m = tool.run_repo(j_acqs, j_maps, j_te, field)
    key = "field_1p5T" if field == 1.5 else "field_3T"
    ref = json.loads((ROOT / "PHANTOM_PARITY.json").read_text())[key]
    for got, want, path in ((pdff_c, j_c, "complex"),
                            (pdff_m, j_m, "magnitude")):
        v_got, v_want = pp.per_vial(got, masks), tool.per_vial(want, j_masks)
        assert max(abs(v_got[g] - v_want[g]) for g in v_want) <= 1e-5
        assert max(abs(v_got[v["gt_ff"]] - v[path]["repo"])
                   for v in ref["vials"]) <= 5e-4
    bias = max(abs(pp.per_vial(pdff_c, masks)[g] - g) for g in pp.GT_VALS)
    assert bias <= pp.BIAS_BOUND


def test_phantom_cli_passes_on_cpu(capsys, monkeypatch):
    assert pp.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert text.count("vial GT=") == 22 and "PASS" in text
    # a median moved past the gate fails, in `passes` and in `main`
    ref = json.loads(pp.PARITY_FILE.read_text())
    good = pp.field_result("field_3T", "cpu", ref)
    assert pp.passes(good)
    moved = dict(good, max_gap=dict(good["max_gap"],
                                    magnitude=1.01 * pp.PARITY_TOL))
    assert not pp.passes(moved)
    assert not pp.passes(dict(good, max_abs_bias_complex=0.031))
    monkeypatch.setattr(pp, "field_result", lambda *a: moved)
    assert pp.main(["--device", "cpu"]) == 1
    assert "FAIL" in capsys.readouterr().out


def test_kernel_matrices_are_built_without_tf32():
    """The four kernels' per-row matrices are built with TF32 off whatever
    the caller's `allow_tf32`, which is restored after; their values do
    not depend on it (the phantom's magnitude medians moved by 2.8e-3 at
    3 T when TF32 built them on the card)."""
    from ideal_gan_tpu_torch import ops, physics
    from ideal_gan_tpu_torch.ops import ideal as oi

    te = physics.te_train_for_field(6, bs=2, field=3.0)
    builders = (ops.precompute_fit_matrices, oi.precompute_cycle_matrices,
                oi.precompute_synth_matrices, ops.precompute_mag_matrices)
    want = [b(te, 3.0) for b in builders]
    seen = []
    real_matmul = torch.Tensor.__matmul__
    matmul = torch.backends.cuda.matmul

    def spy(a, b):
        seen.append(matmul.allow_tf32)
        return real_matmul(a, b)

    prev = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.Tensor, "__matmul__", spy)
            got = [b(te, 3.0) for b in builders]
        assert matmul.allow_tf32 is True
    finally:
        matmul.allow_tf32 = prev
    assert seen and set(seen) == {False}
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
