"""Fatty-acid (9-peak, 5-species) model operators (port of
`ideal_gan_tpu/physics/fa.py`, the rebuild of falib/FA_model.py).

The FA variant runs the MEBCRN core of `physics.ops` with the
FATTY_ACID_9PEAK species (water, fat, ndb, nmidb, cl and their per-peak
decay) and keeps the reference's three behaviours:
- the legacy channel-interleaved 4-D layout (re/im per species);
- R2* zeroed inside the cycle and the forward (falib/FA_model.py:87,161:
  only the field map demodulates), while `fa_get_rho` uses it;
- ns = 5.
Plain PyTorch, differentiable by autograd; tensors stay on their device.
"""

from __future__ import annotations

import torch

from . import ops as core
from .constants import FATTY_ACID_9PEAK

NS = FATTY_ACID_9PEAK.n_species


def _acqs_to_mebcrn(a: torch.Tensor) -> torch.Tensor:
    nb, h, w, ch = a.shape
    return torch.movedim(a.reshape(nb, h, w, ch // 2, 2), 3, 1)


def _mebcrn_to_legacy(x: torch.Tensor) -> torch.Tensor:
    nb, k, h, w, _ = x.shape
    return torch.movedim(x, 1, 3).reshape(nb, h, w, 2 * k)


def _maps_rows(param_maps: torch.Tensor) -> torch.Tensor:
    """Legacy (nb, H, W, [R2*, FM]) → MEBCRN row (nb, 1, H, W, [FM, R2*])
    with R2* zeroed (the FA quirk)."""
    fm = param_maps[..., 1:]
    return torch.cat([fm, torch.zeros_like(fm)], dim=-1)[:, None]


def fa_cycle(acqs: torch.Tensor, param_maps: torch.Tensor,
             te: torch.Tensor, field: float = 1.5):
    """(ρ̂, Â) of legacy-layout acquisitions under the FA model
    (falib/FA_model.py:59-127): field-map-only demodulation, the 5-species
    LS projection. acqs (nb, H, W, 2·ne); param_maps (nb, H, W, 2) =
    (R2*, FM); te (nb, ne, 1). Returns legacy (nb, H, W, 2·ns) and (nb, H,
    W, 2·ne)."""
    rho, recon = core.cycle_full(_acqs_to_mebcrn(acqs), _maps_rows(param_maps),
                                 te, field=field, species=FATTY_ACID_9PEAK)
    return _mebcrn_to_legacy(rho), _mebcrn_to_legacy(recon)


def fa_forward(out_maps: torch.Tensor, te: torch.Tensor,
               field: float = 1.5) -> torch.Tensor:
    """Legacy forward synthesis (falib/FA_model.py:130-185): out_maps (nb,
    H, W, 2·ns + 2), the species' interleaved re/im then (R2*, FM), R2*
    ignored. Returns legacy acquisitions (nb, H, W, 2·ne)."""
    rho = _acqs_to_mebcrn(out_maps[..., :2 * NS])  # (nb, ns, H, W, 2)
    fm = out_maps[..., 2 * NS + 1]
    row = torch.stack([fm, torch.zeros_like(fm)], dim=-1)[:, None]
    acqs = core.synthesize(torch.cat([rho, row], dim=1), te, field=field,
                           species=FATTY_ACID_9PEAK)
    return _mebcrn_to_legacy(acqs)


def fa_get_rho(acqs: torch.Tensor, param_maps: torch.Tensor,
               te: torch.Tensor, field: float = 1.5) -> torch.Tensor:
    """MEBCRN FA map inversion (falib/FA_model.py:188-228): acqs (nb, ne,
    H, W, 2); param_maps (nb, H, W, [FM, R2*]), R2* used. Returns (nb, ns,
    H, W, 2)."""
    return core.fit_rho(acqs, param_maps[:, None], te, field=field,
                        species=FATTY_ACID_9PEAK)
