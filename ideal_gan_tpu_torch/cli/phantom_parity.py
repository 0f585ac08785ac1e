"""The port's phantom check: per-vial PDFF of the synthetic 11-vial phantom
through the hand-written kernels, against the JAX package's per-vial
numbers in `PHANTOM_PARITY.json` (the counterpart of
`tools/phantom_parity.py`, whose TF reference is not part of the repo).

    python -m ideal_gan_tpu_torch.cli.phantom_parity [--device cuda]

`build_phantom(field)` draws the tool's phantom: 11 vials at `GT_VALS` on a
4×3 grid of radius-12 disks in 192×128, |W+F| = 0.7, R2* 30 s⁻¹, a linear
field ramp, the field's protocol TE train, echoes synthesized by the
synthesis kernel (`ops.synthesize_fused`) plus the JAX tool's seeded noise
(`np.random.default_rng(1234)`, σ = 0.005 inside the vials). `run_port`
fits it with the ground-truth (φ, R2*): the complex path through the map
fit kernel (`ops.fit_rho_fused`), PDFF = |F|/|W+F|; the magnitude path
through the magnitude fit kernel (`ops.cse_mag_fused`), PDFF = F/(W+F).
`per_vial` is the median over each vial's interior (radius 9);
`field_result` holds one field's medians against the JSON's `repo` values.
`main` runs 1.5 T and 3 T, prints each vial's medians, their gap to the
JSON and the complex path's bias against the ground truth, and exits 1
unless every gap is ≤ `PARITY_TOL` (5e-4 PDFF, a tenth of the ±0.5 %
target) and every complex |bias| ≤ 0.03.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from .. import ops, physics
from .common import parse_flags, resolve_device

GT_VALS = (0.0, 0.026, 0.053, 0.079, 0.105, 0.157, 0.209, 0.312, 0.413,
           0.514, 1.0)
H, W = 192, 128
NE = 6
AMP = 0.7
R2S_TRUE = 30.0
FM_SPAN = 40.0
NOISE_STD = 0.005
SEED = 1234
RADIUS = 12.0
FIELDS = {"field_1p5T": 1.5, "field_3T": 3.0}
PARITY_FILE = Path(__file__).resolve().parents[2] / "PHANTOM_PARITY.json"
# the bound the JAX package's complex path is held to against the ground
# truth (tests/test_phantom_parity.py)
BIAS_BOUND = 0.03
# each vial median's largest gap to the JSON's repo value
PARITY_TOL = 5e-4


def vial_centers() -> list:
    rows = np.linspace(24, H - 24, 4)
    cols = np.linspace(24, W - 24, 3)
    return [(r, c) for r in rows for c in cols][:len(GT_VALS)]


def vial_crops(wdt: int = 8) -> list:
    """Each vial's (left_x, sup_y) ROI anchor: the (wdt+1)² box centred on
    the vial, inside its interior."""
    return [(int(round(cx)) - wdt // 2, int(round(cy)) - wdt // 2)
            for cy, cx in vial_centers()]


def build_phantom(field: float = 1.5, device="cuda"):
    """The phantom → (acqs (1, NE, H, W, 2), maps (1, 3, H, W, 2), te (1,
    NE, 1)) float32 tensors on `device` and {gt_ff: interior mask (H, W)}.
    The echoes come from the synthesis kernel, the noise from numpy."""
    dev = resolve_device(device)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    water = np.zeros((H, W), np.float32)
    fat = np.zeros((H, W), np.float32)
    masks = {}
    for ff, (cy, cx) in zip(GT_VALS, vial_centers()):
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        disk = d2 <= RADIUS ** 2
        water[disk] = AMP * (1.0 - ff)
        fat[disk] = AMP * ff
        masks[ff] = d2 <= (RADIUS - 3.0) ** 2
    support = (water + fat) > 0
    fm = (FM_SPAN * ((xx / W) - 0.5) + 0.25 * FM_SPAN * (yy / H)) * support
    r2s = R2S_TRUE * support
    zeros = np.zeros((H, W), np.float32)
    maps = np.stack([
        np.stack([water, zeros], -1),
        np.stack([fat, zeros], -1),
        np.stack([fm / physics.FM_SC, r2s / physics.R2_SC], -1),
    ])[None].astype(np.float32)
    maps_t = torch.from_numpy(maps).to(dev)
    te = physics.te_train_for_field(NE, bs=1, field=field).to(dev)
    acqs = ops.synthesize_fused(maps_t, te, field=field)
    rng = np.random.default_rng(SEED)
    noise = rng.normal(scale=NOISE_STD, size=tuple(acqs.shape)).astype(
        np.float32) * support[None, None, :, :, None]
    acqs = acqs + torch.from_numpy(noise).to(dev)
    return acqs, maps_t, te, masks


def pdff_complex(rho: np.ndarray) -> np.ndarray:
    w = rho[:, 0, ..., 0] + 1j * rho[:, 0, ..., 1]
    f = rho[:, 1, ..., 0] + 1j * rho[:, 1, ..., 1]
    tot = np.abs(w + f)
    return np.where(tot > 1e-8, np.abs(f) / np.maximum(tot, 1e-8), 0.0)


def pdff_magnitude(rho_abs: np.ndarray) -> np.ndarray:
    w, f = rho_abs[:, 0, ..., 0], rho_abs[:, 1, ..., 0]
    tot = w + f
    return np.where(tot > 1e-8, f / np.maximum(tot, 1e-8), 0.0)


def run_port(acqs, maps, te, field: float = 1.5):
    """The complex fit and the magnitude fit with the ground-truth (φ, R2*)
    → (pdff_c, pdff_m) numpy (1, H, W)."""
    pm = maps[:, 2:3]
    rho = ops.fit_rho_fused(acqs, pm, te, field=field)
    a_abs = torch.sqrt(torch.sum(torch.square(acqs), dim=-1, keepdim=True))
    res = ops.cse_mag_fused(a_abs, pm[..., 1:].contiguous(), te, field=field)
    return (pdff_complex(rho.cpu().numpy()),
            pdff_magnitude(res.rho.cpu().numpy()))


def per_vial(pdff: np.ndarray, masks) -> dict:
    return {ff: float(np.median(pdff[0][m])) for ff, m in masks.items()}


def field_result(key: str, device="cuda", ref: dict | None = None) -> dict:
    """One field of `FIELDS` through the three kernels: {"medians": {path:
    [median of each vial, in GT_VALS order]}, "max_gap": {path: max
    |median − the JSON's repo value|}, "max_abs_bias_complex"}."""
    ref = ref or json.loads(PARITY_FILE.read_text())
    field = FIELDS[key]
    acqs, maps, te, masks = build_phantom(field, device)
    pdff_c, pdff_m = run_port(acqs, maps, te, field)
    got = {"complex": per_vial(pdff_c, masks),
           "magnitude": per_vial(pdff_m, masks)}
    vials = ref[key]["vials"]
    return dict(medians={p: [got[p][g] for g in GT_VALS] for p in got},
                max_gap={p: max(abs(got[p][v["gt_ff"]] - v[p]["repo"])
                                for v in vials) for p in got},
                max_abs_bias_complex=max(abs(got["complex"][g] - g)
                                         for g in GT_VALS))


def passes(result: dict) -> bool:
    return (max(result["max_gap"].values()) <= PARITY_TOL
            and result["max_abs_bias_complex"] <= BIAS_BOUND)


def main(argv=None) -> int:
    cfg = parse_flags(dict(device="cuda"), argv)
    ref = json.loads(PARITY_FILE.read_text())
    ok = True
    for key, field in FIELDS.items():
        r = field_result(key, cfg["device"], ref)
        ok = ok and passes(r)
        print(f"== {field} T ==")
        for i, v in enumerate(ref[key]["vials"]):
            c, m = r["medians"]["complex"][i], r["medians"]["magnitude"][i]
            print(f"vial GT={v['gt_ff']:.3f}: complex {c:.6f} "
                  f"(Δ {c - v['complex']['repo']:+.2e}) magnitude {m:.6f} "
                  f"(Δ {m - v['magnitude']['repo']:+.2e})")
        print(f"max |Δ| complex {r['max_gap']['complex']:.2e} magnitude "
              f"{r['max_gap']['magnitude']:.2e}; max |bias| complex "
              f"{r['max_abs_bias_complex']:.4f}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
