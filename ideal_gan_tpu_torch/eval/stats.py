"""In-framework ROI statistics (port of `ideal_gan_tpu/eval/stats.py`, the
rebuild of the reference's offline R suite, statistics/*.R; matplotlib is
imported by the plots only).

The reference ships its bias / agreement / significance analysis as R
scripts that consume the xlsx ROI exports (bias-analysis.R,
regression.R, wilcox_test_allROI.R, precision-analysis.R,
mTE-correlation.R). This module reproduces those capabilities natively
on numpy/scipy so the whole pipeline — inference → ROI export →
statistics — runs inside the framework:

- summary statistics (rstatix ``get_summary_stats(type="common")``)
- mean bias + 1.96σ limits of agreement, grouped by an arbitrary factor
  (bias-analysis.R:96-102 ``group_by(method) %>% summarise(...)``)
- Bland–Altman tables and plots (regression.R:57-77, bias-analysis.R:105-125)
- least-squares regression with the ggpubr-style equation/R² annotation
  (regression.R:38-54)
- paired Wilcoxon signed-rank tests with Holm adjustment across protocol
  groups (wilcox_test_allROI.R)
- extreme-outlier detection (rstatix ``identify_outliers`` rule)
- linear mixed models with crossed random intercepts fitted by
  REML/ML profile likelihood, plus the likelihood-ratio anova between
  nested fits (bias-analysis.R:85-93: ``lmer(bias ~ refs + (1|Site_Prot)
  + (1|method))`` and ``anova(reduced, full)``)

All estimators are closed-form or scipy-optimized on dense matrices —
ROI tables are at most a few hundred rows, so no sparse machinery is
needed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
from scipy import optimize, stats as sps

__all__ = [
    "summary_stats", "bias_loa", "group_bias_loa", "bland_altman",
    "plot_bland_altman", "regression", "plot_regression",
    "wilcoxon_paired", "pairwise_wilcoxon", "extreme_outliers",
    "LMMResult", "fit_lmm", "lrt_anova", "load_roi_table",
    "load_phantom_tables",
]


# --------------------------------------------------------------------------
# summary / agreement statistics
# --------------------------------------------------------------------------

def summary_stats(x) -> dict:
    """Common summary stats: n, min, max, median, IQR, mean, sd, se, 95% CI
    half-width (rstatix ``get_summary_stats(type="common")``)."""
    x = np.asarray(x, float)
    x = x[~np.isnan(x)]
    n = x.size
    sd = float(np.std(x, ddof=1)) if n > 1 else 0.0
    se = sd / math.sqrt(n) if n else 0.0
    ci = float(sps.t.ppf(0.975, n - 1) * se) if n > 1 else 0.0
    q1, med, q3 = (np.percentile(x, [25, 50, 75]) if n else
                   (np.nan,) * 3)
    return {"n": n, "min": float(np.min(x)) if n else np.nan,
            "max": float(np.max(x)) if n else np.nan,
            "median": float(med), "iqr": float(q3 - q1),
            "mean": float(np.mean(x)) if n else np.nan,
            "sd": sd, "se": se, "ci": ci}


def bias_loa(refs, meas) -> dict:
    """Mean bias and 1.96σ limits of agreement between a measurement and
    its reference (bias-analysis.R:110-112)."""
    d = np.asarray(meas, float) - np.asarray(refs, float)
    d = d[~np.isnan(d)]
    m = float(np.mean(d)) if d.size else np.nan
    s = float(np.std(d, ddof=1)) if d.size > 1 else 0.0
    return {"mean_bias": m, "sd": s, "loa": 1.96 * s,
            "lower": m - 1.96 * s, "upper": m + 1.96 * s, "n": int(d.size)}


def group_bias_loa(refs, meas, groups) -> dict:
    """Per-group {mean bias, LoA, n} table (bias-analysis.R:96-102)."""
    refs, meas = np.asarray(refs, float), np.asarray(meas, float)
    groups = np.asarray(groups)
    return {g: bias_loa(refs[groups == g], meas[groups == g])
            for g in np.unique(groups)}


def bland_altman(refs, meas, against_mean: bool = True) -> dict:
    """Bland–Altman table: x (refs, or (refs+meas)/2), diff, mean_diff and
    the ±1.96σ limits (regression.R:58-66; bias-analysis.R plots diff
    against the reference directly — ``against_mean=False``)."""
    refs, meas = np.asarray(refs, float), np.asarray(meas, float)
    diff = meas - refs
    agg = bias_loa(refs, meas)
    return {"x": (refs + meas) / 2.0 if against_mean else refs,
            "diff": diff, "mean_diff": agg["mean_bias"],
            "lower": agg["lower"], "upper": agg["upper"]}


def plot_bland_altman(refs, meas, path: str, xlabel: str = "Mean",
                      ylabel: str = "Difference", ylim: float | None = None,
                      against_mean: bool = True) -> None:
    """Bland–Altman PNG matching the R ggplot layout (solid mean line,
    dashed red limits)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ba = bland_altman(refs, meas, against_mean=against_mean)
    fig, ax = plt.subplots(figsize=(5, 3), dpi=150)
    ax.scatter(ba["x"], ba["diff"], s=9)
    ax.axhline(ba["mean_diff"], color="black")
    for y in (ba["lower"], ba["upper"]):
        ax.axhline(y, color="red", linestyle="--")
    if ylim is not None:
        ax.set_ylim(-ylim, ylim)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


# --------------------------------------------------------------------------
# regression / significance
# --------------------------------------------------------------------------

def regression(refs, meas) -> dict:
    """Least-squares line meas = a·refs + b with R², p-value, stderr and
    the ggpubr-style equation label (regression.R:38-54)."""
    refs, meas = np.asarray(refs, float), np.asarray(meas, float)
    ok = ~(np.isnan(refs) | np.isnan(meas))
    res = sps.linregress(refs[ok], meas[ok])
    return {"slope": float(res.slope), "intercept": float(res.intercept),
            "r2": float(res.rvalue ** 2), "p": float(res.pvalue),
            "stderr": float(res.stderr), "n": int(ok.sum()),
            "equation": (f"y = {res.slope:.3g}x + {res.intercept:.3g}, "
                         f"R² = {res.rvalue ** 2:.3f}")}


def plot_regression(refs, meas, path: str, xlabel: str = "Reference",
                    ylabel: str = "Measured") -> dict:
    """Scatter + regression line PNG with the equation annotation
    (regression.R ``ggscatter + stat_regline_equation``). Returns the
    regression dict."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    reg = regression(refs, meas)
    fig, ax = plt.subplots(figsize=(3.4, 3.4), dpi=150)
    ax.scatter(refs, meas, s=9, color="darkorange")
    xs = np.linspace(float(np.nanmin(refs)), float(np.nanmax(refs)), 2)
    ax.plot(xs, reg["slope"] * xs + reg["intercept"], color="blue")
    ax.set_title(reg["equation"], fontsize=8, color="blue")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return reg


def wilcoxon_paired(x, y) -> dict:
    """Paired Wilcoxon signed-rank test (wilcox_test_allROI.R)."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    ok = ~(np.isnan(x) | np.isnan(y))
    res = sps.wilcoxon(x[ok], y[ok])
    return {"statistic": float(res.statistic), "p": float(res.pvalue),
            "n": int(ok.sum())}


def pairwise_wilcoxon(values, groups, adjust: str = "holm",
                      pair_ids=None) -> list[dict]:
    """All pairwise paired Wilcoxon tests between protocol groups with
    Holm p-adjustment (rstatix ``pairwise_wilcox_test`` defaults used by
    wilcox_test_allROI.R).

    Pairing: when ``pair_ids`` is given (slice/ROI key per row), samples
    are matched on the shared ids between the two groups — the only
    order-independent pairing. Without ids, samples are paired by row
    order within group (rstatix's behavior on a sorted data frame); if the
    group sizes differ, the tails are discarded and a warning reports how
    many rows were dropped, since order-pairing is then suspect."""
    values = np.asarray(values, float)
    groups = np.asarray(groups)
    pair_ids = None if pair_ids is None else np.asarray(pair_ids)
    uniq = list(np.unique(groups))
    if pair_ids is not None:
        # duplicate keys within a group cannot be matched — a repeated id
        # would pair the SAME row twice (inflating n and biasing the
        # statistic); warn once per offending group, up front
        for name in uniq:
            ids = pair_ids[groups == name]
            n_dup = len(ids) - len(set(ids.tolist()))
            if n_dup:
                import warnings
                warnings.warn(
                    f"pairwise_wilcoxon: group {name!r} has {n_dup} "
                    "duplicate pair_ids — only the first occurrence of "
                    "each id is paired", stacklevel=2)
    rows = []
    for i in range(len(uniq)):
        for j in range(i + 1, len(uniq)):
            ma, mb = groups == uniq[i], groups == uniq[j]
            if pair_ids is not None:
                ids_a, ids_b = pair_ids[ma], pair_ids[mb]
                idx_a, idx_b = {}, {}
                for k, pid in enumerate(ids_a):
                    idx_a.setdefault(pid, k)
                for k, pid in enumerate(ids_b):
                    idx_b.setdefault(pid, k)
                common = [pid for pid in dict.fromkeys(ids_a.tolist())
                          if pid in idx_b]
                a = values[ma][[idx_a[p] for p in common]]
                b = values[mb][[idx_b[p] for p in common]]
            else:
                a, b = values[ma], values[mb]
                if a.size != b.size:
                    import warnings
                    warnings.warn(
                        f"pairwise_wilcoxon: groups {uniq[i]!r} "
                        f"({a.size}) and {uniq[j]!r} ({b.size}) differ "
                        f"in size; order-pairing drops "
                        f"{abs(a.size - b.size)} rows — pass pair_ids "
                        "for a key-matched pairing", stacklevel=2)
                n = min(a.size, b.size)
                a, b = a[:n], b[:n]
            r = wilcoxon_paired(a, b)
            rows.append({"group1": uniq[i], "group2": uniq[j], **r})
    if adjust == "holm" and rows:
        order = np.argsort([r["p"] for r in rows])
        m = len(rows)
        prev = 0.0
        for rank, idx in enumerate(order):
            padj = min(1.0, (m - rank) * rows[idx]["p"])
            prev = max(prev, padj)  # enforce monotonicity
            rows[idx]["p_adj"] = prev
    return rows


def extreme_outliers(x) -> np.ndarray:
    """Boolean mask of extreme outliers: outside [Q1 − 3·IQR, Q3 + 3·IQR]
    (rstatix ``identify_outliers`` is.extreme rule)."""
    x = np.asarray(x, float)
    q1, q3 = np.nanpercentile(x, [25, 75])
    iqr = q3 - q1
    return (x < q1 - 3 * iqr) | (x > q3 + 3 * iqr)


# --------------------------------------------------------------------------
# linear mixed models (lme4-equivalent for the crossed-intercept case)
# --------------------------------------------------------------------------

@dataclass
class LMMResult:
    """Fit of y = Xβ + Σ_k b_k[g_k] + ε with independent random
    intercepts per factor: b_k ~ N(0, σ_k² I), ε ~ N(0, σ² I)."""

    beta: np.ndarray              # fixed effects
    se: np.ndarray                # fixed-effect standard errors
    sigma2: float                 # residual variance
    var_components: dict          # factor name → intercept variance
    loglik: float                 # maximized (restricted) log-likelihood
    reml: bool
    n: int
    p: int                        # number of fixed-effect columns
    fixed_names: Sequence[str] = field(default_factory=list)

    def summary(self) -> str:
        lines = [f"Linear mixed model ({'REML' if self.reml else 'ML'}), "
                 f"n={self.n}, logLik={self.loglik:.2f}",
                 "Random effects (variance / std.dev):"]
        for k, v in self.var_components.items():
            lines.append(f"  {k:12s} {v:10.4f} / {math.sqrt(max(v, 0)):.4f}")
        lines.append(f"  {'residual':12s} {self.sigma2:10.4f} / "
                     f"{math.sqrt(self.sigma2):.4f}")
        lines.append("Fixed effects (estimate / std.err / t):")
        names = (list(self.fixed_names) or
                 [f"x{i}" for i in range(self.p)])
        for name, b, s in zip(names, self.beta, self.se):
            t = b / s if s > 0 else np.inf
            lines.append(f"  {name:12s} {b:10.4f} / {s:.4f} / {t:.2f}")
        return "\n".join(lines)


def _lmm_neg2ll(theta, y, X, Zs, reml):
    """−2·(restricted) profile log-likelihood at log-variances theta.

    V = σ²I + Σ σ_k² Z_k Z_kᵀ; β profiled out by GLS. The REML criterion
    adds log|XᵀV⁻¹X| (lme4's objective up to a constant)."""
    n, p = X.shape
    if np.any(theta > 50.0):       # exp overflow guard for the optimizer
        return 1e12
    s2 = math.exp(theta[-1])
    V = s2 * np.eye(n)
    for t, Z in zip(theta[:-1], Zs):
        V += math.exp(t) * (Z @ Z.T)
    try:
        L = np.linalg.cholesky(V)
    except np.linalg.LinAlgError:
        return 1e12
    logdetV = 2.0 * float(np.sum(np.log(np.diag(L))))
    try:
        Vi_y = np.linalg.solve(V, y)
        Vi_X = np.linalg.solve(V, X)
        XtViX = X.T @ Vi_X
        beta = np.linalg.solve(XtViX, X.T @ Vi_y)
        r = y - X @ beta
        quad = float(r @ np.linalg.solve(V, r))
    except np.linalg.LinAlgError:
        return 1e12
    out = logdetV + quad
    if reml:
        sign, logdetX = np.linalg.slogdet(XtViX)
        out += logdetX
    if not math.isfinite(out):
        return 1e12
    return out


def fit_lmm(y, X, random_factors: Mapping[str, Sequence],
            reml: bool = True, fixed_names: Sequence[str] = ()) -> LMMResult:
    """Fit a linear mixed model with crossed random intercepts by
    numerical (RE)ML — the estimator behind bias-analysis.R:85
    ``lmer(bias ~ refs + (1|Site_Prot) + (1|method))``.

    ``X`` should include an intercept column; ``random_factors`` maps a
    factor name to its per-row group labels."""
    y = np.asarray(y, float)
    X = np.asarray(X, float)
    if X.ndim == 1:
        X = X[:, None]
    n, p = X.shape
    if np.linalg.matrix_rank(X) < p:
        # lme4 drops rank-deficient fixed-effect columns with a message;
        # be explicit instead — the caller controls the design matrix.
        raise ValueError(
            "fixed-effect design matrix is rank-deficient "
            f"(rank {np.linalg.matrix_rank(X)} < {p} columns); drop the "
            "collinear/constant columns")
    names = list(random_factors)
    Zs = []
    for k in names:
        g = np.asarray(random_factors[k])
        levels = np.unique(g)
        Z = (g[:, None] == levels[None, :]).astype(float)
        Zs.append(Z)
    var0 = float(np.var(y, ddof=1)) or 1.0
    x0 = np.log(np.full(len(Zs) + 1, var0 / (len(Zs) + 1)))
    res = optimize.minimize(_lmm_neg2ll, x0, args=(y, X, Zs, reml),
                            method="Nelder-Mead",
                            options={"xatol": 1e-8, "fatol": 1e-10,
                                     "maxiter": 4000})
    theta = res.x
    s2 = math.exp(theta[-1])
    V = s2 * np.eye(n)
    for t, Z in zip(theta[:-1], Zs):
        V += math.exp(t) * (Z @ Z.T)
    Vi_X = np.linalg.solve(V, X)
    XtViX = X.T @ Vi_X
    beta = np.linalg.solve(XtViX, X.T @ np.linalg.solve(V, y))
    se = np.sqrt(np.diag(np.linalg.inv(XtViX)))
    const = n - p if reml else n
    loglik = -0.5 * (res.fun + const * math.log(2 * math.pi))
    return LMMResult(beta=beta, se=se, sigma2=s2,
                     var_components={k: math.exp(t)
                                     for k, t in zip(names, theta[:-1])},
                     loglik=loglik, reml=reml, n=n, p=p,
                     fixed_names=list(fixed_names))


def lrt_anova(reduced: LMMResult, full: LMMResult) -> dict:
    """Likelihood-ratio test between nested ML fits
    (bias-analysis.R:91-93 ``anova(reduced.lmer, full.lmer)``). Both fits
    must be ML (lme4 refits REML models with ML for anova)."""
    if reduced.reml or full.reml:
        raise ValueError("lrt_anova requires ML fits (reml=False), "
                         "matching lme4's anova() refit")
    chisq = 2.0 * (full.loglik - reduced.loglik)
    df = ((len(full.var_components) + full.p) -
          (len(reduced.var_components) + reduced.p))
    p = float(sps.chi2.sf(max(chisq, 0.0), max(df, 1)))
    return {"chisq": float(chisq), "df": int(df), "p": p}


# --------------------------------------------------------------------------
# xlsx loaders (tidy tables from the framework's own ROI exports)
# --------------------------------------------------------------------------

def _sheet_columns(rows: list[list]) -> list[np.ndarray]:
    body = [r for r in rows[1:] if r and
            any(isinstance(v, (int, float)) for v in r)]
    ncol = max((len(r) for r in body), default=0)
    cols = []
    for c in range(ncol):
        cols.append(np.array([float(r[c]) if c < len(r) and
                              isinstance(r[c], (int, float)) else np.nan
                              for r in body]))
    return cols


def load_roi_table(path: str, sheets: Sequence[str] = ("RHL", "LHL")) -> dict:
    """Tidy {refs, meas, bias, roi} columns from an `export_roi_xlsx`
    workbook — the data frame the regression/wilcoxon scripts build
    (regression.R:20-31). Column layout: Slice / Reference / Model / Bias."""
    from .export import read_xlsx
    book = read_xlsx(path)
    refs, meas, roi = [], [], []
    for name in sheets:
        if name not in book:
            continue
        cols = _sheet_columns(book[name])
        if len(cols) < 3:
            continue
        refs.append(cols[1])
        meas.append(cols[2])
        roi.extend([name] * len(cols[1]))
    refs = np.concatenate(refs) if refs else np.empty(0)
    meas = np.concatenate(meas) if meas else np.empty(0)
    return {"refs": refs, "meas": meas, "bias": meas - refs,
            "roi": np.array(roi)}


def load_phantom_tables(paths: Mapping[str, str]) -> dict:
    """Stacked tidy table over several phantom workbooks
    ({method name → xlsx path}), mirroring bias-analysis.R:16-60's
    method/vial/sheet factors. Reads the per-slice sheets
    (Ground-truth / Model-result columns) of `export_phantom_xlsx`."""
    from .export import read_xlsx
    refs, meas, method, sheet_id, vial = [], [], [], [], []
    for name, path in paths.items():
        book = read_xlsx(path)
        for sheet, rows in book.items():
            if not sheet.startswith("Slice_"):
                continue
            cols = _sheet_columns(rows)
            if len(cols) < 2:
                continue
            refs.append(cols[0])
            meas.append(cols[1])
            method.extend([name] * len(cols[0]))
            sheet_id.extend([sheet] * len(cols[0]))
            vial.extend(range(len(cols[0])))
    refs = np.concatenate(refs) if refs else np.empty(0)
    meas = np.concatenate(meas) if meas else np.empty(0)
    return {"refs": refs, "meas": meas, "bias": meas - refs,
            "method": np.array(method), "sheet": np.array(sheet_id),
            "vial": np.array(vial)}
