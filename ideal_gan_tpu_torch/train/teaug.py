"""Physics-based TE-augmentation training (port of
`ideal_gan_tpu/train/teaug.py`, the VET-Net generator step).

Each step synthesizes acquisitions A from the ground-truth maps B at a
freshly sampled TE train through the forward physics (`ops.synthesize_fused`,
the synthesis kernel on the card) plus Gaussian noise, and trains the
TE-conditioned VET-Net (`models.VETNet`, whose ConvLSTM front runs the
ConvLSTM kernels) on the MAE between its (FM, R2*) maps and B's, masked to
B's support, plus the TV regularizers. A diagnostic `WF_loss` fits ρ̂ from A
and the predicted maps (`ops.fit_rho_fused`, the fit kernel on the card)
under `torch.no_grad()`: a metric, not part of the loss.

Not ported yet (ROADMAP Queue 1 item 7): the G_models "U-Net", "2U-Net"
(with its R2 step) and "MDWF-Net", `out_vars="WF"`, `microbatch > 0`
(gradient accumulation), bf16 and remat. Those settings raise
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import physics
from ..cli.common import resolve_device
from ..losses import total_variation_2d
from ..models import VETNet
from ..ops import fit_rho_fused, synthesize_fused
from .common import ModelState, linear_decay_schedule, make_adam

DEFAULTS = dict(
    dataset="TEaug-300", n_echoes=6, field=1.5, G_model="PM-Gen",
    out_vars="PM", n_G_filters=72, batch_size=8, epochs=100, epoch_decay=100,
    epoch_ckpt=10, lr=0.0002, beta_1=0.9, beta_2=0.9999, noise_std=0.1,
    FM_aug=False, FM_mean=1.0, bip_grad=False, data_aug_p=0.4, bf16=False,
    remat=False, microbatch=0,
    R2_TV_weight=0.0, FM_TV_weight=0.0, sel_weight=False, sel_weight_pwr=1.0,
    te_input=True,
    R2_SelfAttention=False, FM_SelfAttention=True,
)
_VETNET = ("PM-Gen", "VET-Net", "multi-decod")


def _check_ported(cfg) -> None:
    unported = [k for k in ("bf16", "remat", "microbatch") if cfg.get(k)]
    if cfg["G_model"] not in _VETNET:
        unported.append(f"G_model={cfg['G_model']}")
    if cfg["out_vars"] != "PM":
        unported.append(f"out_vars={cfg['out_vars']}")
    if unported:
        raise NotImplementedError(
            f"teaug settings {unported} are not ported yet (ROADMAP Queue 1 "
            f"item 7: the U-Net, 2U-Net and MDWF-Net generators, the WF "
            f"outputs, microbatching, bf16, remat)")


def build_model(cfg) -> VETNet:
    """The generator G_A2B: VET-Net on the complex echoes (Cin = 2)."""
    _check_ported(cfg)
    return VETNet(2, te_input=cfg.get("te_input", True),
                  filters=cfg["n_G_filters"],
                  r2_self_attention=cfg["R2_SelfAttention"],
                  fm_self_attention=cfg["FM_SelfAttention"])


def sample_te(generator: torch.Generator, cfg, bs: int) -> torch.Tensor:
    """One TE train for a batch, with the trainer's per-field presets
    (3 T; the bipolar-gradient spacing), as (bs, ne, 1) float32 on the
    CPU."""
    ne = cfg["n_echoes"]
    if cfg["field"] == 3.0:
        return physics.sample_te_train(generator, ne, bs, te1_d=0.4e-3,
                                       dte_min=1.0e-3, dte_d=0.3e-3)
    if cfg["bip_grad"]:
        return physics.sample_te_train(generator, ne, bs, dte_min=0.9e-3,
                                       dte_d=0.3e-3)
    return physics.sample_te_train(generator, ne, bs)


def _selective_weight(cfg, B, A, te):
    """Phase-coherence selective weighting: per voxel, the agreement of
    each of the first three observed echo phases with the phase that B's
    field map and water phase predict, (nb, 1, H, W, 1)."""
    sel_w = 0.0
    for echo in range(3):
        obs = torch.atan2(A[:, echo:echo + 1, ..., 1:],
                          A[:, echo:echo + 1, ..., :1])
        phi = (2.0 * np.pi * B[:, 2:3, ..., :1] * physics.FM_SC
               * te[0, echo, 0])
        phi = phi + torch.atan2(B[:, :1, ..., 1:], B[:, :1, ..., :1])
        sel_w = sel_w + (1.0 / 6.0) * torch.cos(obs - phi) + (1.0 / 6.0)
    return sel_w ** cfg["sel_weight_pwr"]


def make_loss_fn(cfg, model):
    """The generator loss as `loss_fn(B, te, noise) -> (loss, metrics)` over
    the model's current parameters. B (nb, ≥3, H, W, 2) ground-truth maps,
    te (nb, ne, 1), noise (nb, ne, H, W, 2) standard normal (the caller
    draws it; tests pass the JAX package's)."""
    _check_ported(cfg)
    field = cfg["field"]

    def loss_fn(B, te, noise):
        A = synthesize_fused(B[:, :3], te, field, uniform_te=False)
        A = A + cfg["noise_std"] * noise
        B_pm = B[:, 2:3]
        B_wf_abs = torch.sqrt(torch.sum(torch.square(B[:, :2]), dim=-1,
                                        keepdim=True))
        pm = model(A, te[..., 0]).float()
        # support mask of the GT PM rows, before the MAE and the TV terms
        pm = torch.where(B_pm != 0.0, pm, torch.zeros_like(pm))
        if cfg["sel_weight"]:
            sel_w = _selective_weight(cfg, B, A, te)
            sel_w = torch.cat([sel_w, sel_w], dim=-1)
        else:
            sel_w = 1.0
        sup = torch.mean(torch.abs(sel_w * B_pm - sel_w * pm))
        fm, r2 = pm[..., :1], pm[..., 1:]
        with torch.no_grad():  # B→A→B̂ map consistency (a diagnostic)
            wf_hat = fit_rho_fused(A, pm, te, field, uniform_te=False)
            wf_abs = torch.sqrt(torch.sum(torch.square(wf_hat), dim=-1,
                                          keepdim=True))
            wf_mae = torch.mean(torch.abs(B_wf_abs - wf_abs))
        r2_tv = torch.sum(total_variation_2d(r2[:, 0])) * cfg["R2_TV_weight"]
        fm_tv = torch.sum(total_variation_2d(fm[:, 0])) * cfg["FM_TV_weight"]
        loss = sup + r2_tv + fm_tv
        return loss, {"PM_loss": sup, "WF_loss": wf_mae, "TV_R2": r2_tv,
                      "TV_FM": fm_tv, "G_loss": loss}

    return loss_fn


TEAugState = ModelState  # the generator, its optimizer and the step count


def make_train_step(cfg, model):
    """(train_step, tx): `train_step(state, (B, te), generator) -> (state,
    metrics)` draws the noise from `generator` (on B's device) and takes
    one Adam step on the generator loss (no gradient clipping, as the JAX
    trainer); tx is the optimizer recipe `params -> Adam`. The state is
    updated in place and returned."""
    loss_fn = make_loss_fn(cfg, model)
    total_steps = cfg.get("total_steps", cfg["epochs"])
    schedule = linear_decay_schedule(
        cfg["lr"], total_steps,
        int(cfg["epoch_decay"] * total_steps / max(cfg["epochs"], 1)))
    tx = make_adam(schedule, cfg["beta_1"], cfg["beta_2"])

    def train_step(state: TEAugState, batch, generator: torch.Generator):
        B, te = batch
        noise = torch.randn((B.shape[0], te.shape[1], *B.shape[2:]),
                            generator=generator, device=B.device)
        state.opt.zero_grad()
        loss, metrics = loss_fn(B, te, noise)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step, tx


def init_state(cfg, model, tx, generator: torch.Generator,
               device="cuda") -> TEAugState:
    """Seeded random weights (`models.init_params`) on `device` (default
    the card; raises without one) and a fresh optimizer from the recipe
    `tx` over the trainable parameters."""
    dev = resolve_device(device)
    model.init_params(generator)
    model.to(dev)
    return TEAugState(model, tx([p for p in model.parameters()
                                 if p.requires_grad]))
