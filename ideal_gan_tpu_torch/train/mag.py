"""Magnitude-only R2*/PDFF training (port of `ideal_gan_tpu/train/mag.py`,
the rebuild of train-IDEAL-mag.py).

Each step synthesizes acquisitions A from the ground-truth maps B at the
batch's TE train (`ops.synthesize_fused`, the synthesis kernel on the card)
and takes their magnitudes. A UNet on |A| (`models.UNet(me_layer=True)`,
whose ConvLSTM front runs the ConvLSTM kernels; with the TE vector in
supervised mode) predicts R2*, as a `prob.Rician` posterior when
main_loss="Rice". The magnitude-domain LS fit (`ops.cse_mag_fused`, the
magnitude fit kernel) recovers (|W|, |F|) and the reprojected |Â|.
Supervised mode trains on R2* and/or the LS coefficients against B,
unsupervised mode on the magnitude cycle loss; then the regularizers of
the reference (R2* TV, demodulated-signal TV, LS non-negativity and the
quadratic-discriminant condition), each with its weight.

The JAX step splits a key into `rngs={"bayes": ...}`, which no layer on
this path reads (there is no Flipout layer, and the Rician is not
sampled): the port's step takes no generator.

With `bf16` the UNet computes in bfloat16 (its ConvLSTM front in the
kernels' bf16 storage mode) while its parameters stay float32; its point
output and the Rician head's (ν, σ) are upcast to float32 before the
magnitude fit, as in the JAX package. `remat` rematerializes its blocks in
the backward.
"""

from __future__ import annotations

import torch

from ..cli.common import resolve_device
from ..losses import total_variation_2d
from ..models import UNet
from ..ops import cse_mag_fused, synthesize_fused
from ..prob import Rician
from .common import (ModelState, compute_dtype, linear_decay_schedule,
                     make_adam)

DEFAULTS = dict(
    dataset="Mag-300", n_echoes=6, field=1.5, training_mode="supervised",
    main_loss="MSE",  # Rice | MSE | MAE | MSLE
    main_out_var="R2s",  # R2s | WF | R2s-WF
    n_G_filters=36, batch_size=8, epochs=100, epoch_decay=100, epoch_ckpt=10,
    lr=0.0002, beta_1=0.9, beta_2=0.9999, R2_TV_weight=0.0,
    A_demod_TV_weight=0.0, LS_NZ_weight=0.0, LS_cond_weight=0.0,
    D1_SelfAttention=True, bf16=False, remat=False,
)

MagState = ModelState  # the UNet, its optimizer and the step count


def build_model(cfg) -> UNet:
    """The R2* net on the echo magnitudes (Cin = 1), in the config's compute
    dtype (`bf16`) and with its `remat`."""
    return UNet(1, n_out=1, bayesian=cfg["main_loss"] == "Rice",
                me_layer=True,
                te_input=cfg["training_mode"] == "supervised",
                filters=cfg["n_G_filters"], output_activation="sigmoid",
                self_attention=cfg["D1_SelfAttention"],
                dtype=compute_dtype(cfg), remat=bool(cfg.get("remat")))


def _point_loss(name):
    if name in ("MSE", "Rice"):
        return lambda a, b: torch.mean(torch.square(a - b))
    if name == "MAE":
        return lambda a, b: torch.mean(torch.abs(a - b))
    if name == "MSLE":
        return lambda a, b: torch.mean(torch.square(
            torch.log1p(torch.clamp(a, min=0)) - torch.log1p(
                torch.clamp(b, min=0))))
    raise NameError(f"Unrecognized Main Loss Function {name!r}")


def make_loss_fn(cfg, model):
    """The loss as `loss_fn(B, te) -> (loss, metrics)` over the model's
    current parameters. B (nb, ≥3, H, W, 2) ground-truth maps, te (nb, ne,
    1)."""
    rice = cfg["main_loss"] == "Rice"
    supervised = cfg["training_mode"] == "supervised"
    loss_alt = _point_loss(cfg["main_loss"])
    field = cfg["field"]

    def loss_fn(B, te):
        A = synthesize_fused(B[:, :3], te, field)
        a_mag = torch.sqrt(torch.sum(torch.square(A), dim=-1, keepdim=True))
        keep = torch.mean(a_mag, dim=1, keepdim=True) >= 5e-2
        out = model(a_mag, te[..., 0]) if supervised else model(a_mag)
        # the physics in float32 (a bf16 net's outputs upcast)
        out = Rician(out.nu.float(), out.sigma.float()) if rice \
            else out.float()
        if rice:
            r2_nu, r2_point = out.nu, out.mean()
            r2s_nu = r2_nu
        else:
            r2_point = torch.where(keep, out, 0.0)
            r2_nu, r2s_nu = r2_point, None
        res = cse_mag_fused(a_mag, r2_point, te, field, r2s_nu=r2s_nu)
        cycle_loss = loss_alt(a_mag, torch.where(keep, res.recon, 0.0))

        # split losses against the ground truth
        b_wf_abs = torch.sqrt(torch.sum(torch.square(B[:, :2]), dim=-1,
                                        keepdim=True))
        b_wf_sq = torch.cat([
            torch.square(b_wf_abs[:, :1]),
            2.0 * torch.prod(b_wf_abs, dim=1, keepdim=True),
            torch.square(b_wf_abs[:, 1:])], dim=1)
        wf_loss = loss_alt(b_wf_sq, res.ls_coeffs)
        b_r2 = B[:, 2:3, ..., 1:]
        r2_loss = (-torch.mean(out.log_prob(b_r2)) if rice
                   else loss_alt(b_r2, r2_point))
        r2_tv = torch.sum(total_variation_2d(r2_nu[:, 0]))

        if not supervised:
            g_loss = cycle_loss
        elif cfg["main_out_var"] == "R2s":
            g_loss = r2_loss
        elif cfg["main_out_var"] == "WF":
            g_loss = wf_loss
        else:
            g_loss = r2_loss + wf_loss
        g_loss = g_loss + r2_tv * cfg["R2_TV_weight"]

        # the reference's physics regularizers (train-IDEAL-mag.py:305-316)
        ad = res.demod.reshape((-1,) + res.demod.shape[2:])
        ad_tv = torch.sum(total_variation_2d(ad))
        ls = res.ls_coeffs  # (nb, 3, H, W, 1): (a, b, c)
        ac = ls[:, ::2]
        ls_nz = torch.sum(torch.where(ac < 0.0, torch.square(ac), 0.0))
        wf_nz = torch.sum(torch.where(ls[:, :1] < ls[:, -1:],
                                      ls[:, -1:] - ls[:, :1], 0.0))
        cond = torch.square(ls[:, 1:2]) - 4.0 * torch.prod(ac, dim=1,
                                                           keepdim=True)
        ls_cond = torch.sum(torch.where(cond > 0.0, torch.square(cond), 0.0))
        g_loss = (g_loss + ad_tv * cfg["A_demod_TV_weight"]
                  + ls_nz * cfg["LS_NZ_weight"]
                  + ls_cond * cfg["LS_cond_weight"])
        return g_loss, {"A2B2A_cycle_loss": cycle_loss, "WF_loss": wf_loss,
                        "R2_loss": r2_loss, "R2_TV": r2_tv, "Ad_TV": ad_tv,
                        "LS_NZ": ls_nz, "WF_NZ": wf_nz, "LS_cond": ls_cond,
                        "G_loss": g_loss}

    return loss_fn


def make_train_step(cfg, model):
    """(train_step, tx): `train_step(state, (B, te)) -> (state, metrics)`
    takes one Adam step on the loss (no gradient clipping; the learning
    rate decays over `epochs` optimizer steps after `epoch_decay`, as the
    JAX trainer's schedule counts them); tx is the optimizer recipe
    `params -> Adam`. The state is updated in place and returned."""
    loss_fn = make_loss_fn(cfg, model)
    schedule = linear_decay_schedule(cfg["lr"], cfg["epochs"],
                                     cfg["epoch_decay"])
    tx = make_adam(schedule, cfg["beta_1"], cfg["beta_2"])

    def train_step(state: MagState, batch):
        B, te = batch
        state.opt.zero_grad()
        loss, metrics = loss_fn(B, te)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step, tx


def init_state(cfg, model, tx, generator: torch.Generator,
               device="cuda") -> MagState:
    """Seeded random weights (`models.init_params`) on `device` (default
    the card; raises without one) and a fresh optimizer from the recipe
    `tx` over the trainable parameters."""
    dev = resolve_device(device)
    model.init_params(generator)
    model.to(dev)
    return MagState(model, tx([p for p in model.parameters()
                               if p.requires_grad]))
