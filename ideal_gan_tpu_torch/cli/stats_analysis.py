"""CLI: ROI statistics (port of `ideal_gan_tpu/cli/stats_analysis.py`) —
the in-framework replacement for the reference's offline R suite
(statistics/bias-analysis.R, regression.R, wilcox_test_allROI.R). Host
only: numpy and scipy, and matplotlib for its PNGs.

Consumes the xlsx workbooks exported by `roi_analysis` /
`roi_realphantom` and produces, per the R workflows:

- summary statistics of the measured map (regression.R:33-35)
- regression of measured vs reference with equation/R² PNG
  (regression.R:38-54)
- Bland–Altman bias plot + mean bias / limits of agreement
  (regression.R:57-77)
- per-method bias/LoA table and a crossed random-intercept linear mixed
  model `bias ~ refs + (1|sheet) + (1|method)` with the
  full-vs-reduced likelihood-ratio anova, when several phantom
  workbooks are given (bias-analysis.R:85-102)
- pairwise Wilcoxon signed-rank tests between in-vivo workbooks (e.g.
  TE protocols), Holm-adjusted (wilcox_test_allROI.R)

Usage:
    python -m ideal_gan_tpu_torch.cli.stats_analysis --dataset run1 \
        --xlsx output/run1/ROI_analysis.xlsx [--mode invivo]
    python -m ideal_gan_tpu_torch.cli.stats_analysis --dataset phantom \
        --xlsx "VET-Net=a.xlsx,GraphCuts=b.xlsx" --mode phantom
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..eval import stats as st
from .common import setup_experiment

DEFAULTS = dict(
    dataset="stats", xlsx="", mode="invivo", map="PDFF", scale=100.0,
    ba_ylim=0.0, lmm=True,
)


def _parse_xlsx_arg(arg: str) -> dict:
    """`name=path,name=path` → {name: path}; bare paths are keyed by
    file stem."""
    out = {}
    for part in str(arg).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, path = part.split("=", 1)
        else:
            name, path = Path(part).stem, part
        out[name] = path
    return out


def analyze_invivo(cfg, paths: dict) -> dict:
    """regression.R + wilcox_test_allROI.R on RHL/LHL workbooks."""
    k = cfg["scale"]
    out_dir = Path(cfg["output_dir"])
    results = {}
    all_vals, all_groups = [], []
    for name, path in paths.items():
        tab = st.load_roi_table(path)
        refs, meas = tab["refs"] * k, tab["meas"] * k
        print(f"== {name} ({len(refs)} ROIs) ==")
        s = st.summary_stats(meas)
        print(f"  measured {cfg['map']}: mean {s['mean']:.2f} ± {s['sd']:.2f}"
              f" (median {s['median']:.2f}, IQR {s['iqr']:.2f})")
        reg = st.plot_regression(
            refs, meas, str(out_dir / f"LS-corr-{name}.png"),
            xlabel=f"Reference {cfg['map']}",
            ylabel=f"Measured {cfg['map']}")
        print(f"  regression: {reg['equation']} (p={reg['p']:.2e})")
        ba = st.bias_loa(refs, meas)
        print(f"  bias {ba['mean_bias']:+.3f}, LoA [{ba['lower']:+.3f}, "
              f"{ba['upper']:+.3f}]")
        st.plot_bland_altman(
            refs, meas, str(out_dir / f"BlandAltman-{name}.png"),
            xlabel=f"Mean {cfg['map']}", ylabel=f"Bias {cfg['map']}",
            ylim=cfg["ba_ylim"] or None)
        results[name] = {"summary": s, "regression": reg, "bias": ba}
        all_vals.append(meas)
        all_groups.extend([name] * len(meas))
    if len(paths) > 1:
        print("== pairwise Wilcoxon (Holm-adjusted) ==")
        rows = st.pairwise_wilcoxon(np.concatenate(all_vals),
                                    np.array(all_groups))
        for r in rows:
            print(f"  {r['group1']} vs {r['group2']}: p={r['p']:.4f} "
                  f"p_adj={r['p_adj']:.4f}")
        results["wilcoxon"] = rows
    return results


def analyze_phantom(cfg, paths: dict) -> dict:
    """bias-analysis.R on per-slice phantom workbooks from ≥1 methods."""
    k = cfg["scale"]
    out_dir = Path(cfg["output_dir"])
    tab = st.load_phantom_tables(paths)
    refs, bias = tab["refs"] * k, tab["bias"] * k
    results = {"by_method": st.group_bias_loa(
        np.zeros_like(bias), bias, tab["method"])}
    print("== per-method bias / LoA ==")
    for m, b in results["by_method"].items():
        print(f"  {m:12s} mBias {b['mean_bias']:+.3f}  "
              f"LoA ±{b['loa']:.3f}  n={b['n']}")
    for m in np.unique(tab["method"]):
        sel = tab["method"] == m
        st.plot_bland_altman(
            refs[sel], refs[sel] + bias[sel],
            str(out_dir / f"{cfg['map']}-{m}-Bias-BlandAltman.png"),
            xlabel="Ground-Truth", ylabel="Difference",
            ylim=cfg["ba_ylim"] or None, against_mean=False)
    if cfg["lmm"] and len(paths) > 1:
        fixed = ["intercept", "refs"]
        X = np.stack([np.ones_like(refs), refs], axis=1)
        if np.ptp(refs) == 0.0:
            # single-vial tables: refs is constant → collinear with the
            # intercept; fall back to an intercept-only model
            X, fixed = X[:, :1], fixed[:1]
        fit = st.fit_lmm(bias, X,
                         {"sheet": tab["sheet"], "method": tab["method"]},
                         reml=True, fixed_names=fixed)
        print(fit.summary())
        full = st.fit_lmm(bias, X,
                          {"sheet": tab["sheet"], "method": tab["method"]},
                          reml=False)
        reduced = st.fit_lmm(bias, X, {"sheet": tab["sheet"]}, reml=False)
        lrt = st.lrt_anova(reduced, full)
        print(f"anova(reduced, full): chisq={lrt['chisq']:.3f} "
              f"df={lrt['df']} p={lrt['p']:.4f}")
        results["lmm"] = fit
        results["lrt"] = lrt
    return results


def main(argv=None):
    cfg = setup_experiment(DEFAULTS, argv)
    paths = _parse_xlsx_arg(cfg["xlsx"])
    if not paths:
        raise SystemExit("--xlsx required (path, or name=path[,name=path])")
    for p in paths.values():
        if not Path(p).exists():
            raise SystemExit(f"no workbook at {p}")
    if cfg["mode"] == "phantom":
        return analyze_phantom(cfg, paths)
    return analyze_invivo(cfg, paths)


if __name__ == "__main__":
    main()
