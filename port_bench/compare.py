"""The numbers that decide `correct`.

Serving: of each compared slice, the RMS of the served maps' gap to the
reference's over the RMS of the reference's maps; the worst slice. Taken
apart for (phi, R2*) and for water/fat.

Training: each net's output in the first step, as serving's maps, by
the worst slice; the loss of each of the first steps (a step pair's two),
as the gap to the reference's over the reference's; the first gradient as
the optimizer received it, and the parameters' change after the first
step and after the last, each by the worst leaf (or the median leaf): the
gap between the program's norm and the reference's over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of the change.
"""

from __future__ import annotations

import numpy as np


def rel_rms_by_slice(got: np.ndarray, ref: np.ndarray) -> list:
    """Each slice's RMS gap over the RMS of the reference's slice."""
    n = len(ref)
    d = (got.reshape(n, -1).astype(np.float64)
         - ref.reshape(n, -1).astype(np.float64))
    r = ref.reshape(n, -1).astype(np.float64)
    num = np.sqrt(np.mean(d * d, axis=1))
    den = np.sqrt(np.mean(r * r, axis=1))
    return [float(x) for x in num / np.maximum(den, 1e-30)]


def output_gap(got: dict, ref: dict) -> float:
    """The worst slice's relative RMS gap of each net's output {net:
    tensor} to the reference's; a slice the program did not produce reads
    1, the gap of an answer of zeros."""
    worst = 0.0
    for k, r in ref.items():
        r = r.detach().float().cpu().numpy()
        g = got[k].numpy() if k in got else r[:0]
        n = min(len(g), len(r))
        gaps = rel_rms_by_slice(g[:n], r[:n]) + [1.0] * (len(r) - n)
        worst = max([worst] + gaps)
    return float(worst)


def loss_gap(got, ref) -> float:
    return float(max(abs(g - r) / max(abs(r), 1e-30)
                     for gs, rs in zip(got, ref) for g, r in zip(gs, rs)))


def _leaf_gaps(got: dict, ref: dict, keep=None) -> dict:
    leaves = sorted(ref if keep is None else keep)
    med = float(np.median([ref[k] for k in leaves]))
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def leaf_gap(got: dict, ref: dict, keep=None, over=max) -> float:
    """The worst leaf's (`over` = max) |got - ref| / max(ref, median(ref))
    over the norms {leaf: norm}, on the leaves of `keep` (all where
    None)."""
    return float(over(list(_leaf_gaps(got, ref, keep).values())))


def worst_leaves(got: dict, ref: dict, keep=None, n: int = 3) -> list:
    gaps = _leaf_gaps(got, ref, keep)
    return sorted(([k, g] for k, g in gaps.items()), key=lambda x: -x[1])[:n]


def diff_gap(diff_norms: dict, ref_norms: dict) -> float:
    """The whole gradient's relative gap, sqrt(sum |g - g_ref|^2) /
    sqrt(sum |g_ref|^2), from each leaf's norm of the difference and of
    the reference."""
    num = sum(v * v for v in diff_norms.values())
    den = sum(ref_norms[k] ** 2 for k in diff_norms)
    return float(np.sqrt(num / max(den, 1e-300)))


def moving_leaves(grad_norms: dict, share: float = 1e-3) -> list:
    med = float(np.median(list(grad_norms.values())))
    return [k for k, v in grad_norms.items() if v >= share * med]
