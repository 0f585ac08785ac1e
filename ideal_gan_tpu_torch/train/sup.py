"""Supervised water–fat training (port of `ideal_gan_tpu/train/sup.py`).

Trains a generator on (acquisitions A, maps B) pairs with MAE supervision
in one of four output modes:
  WF    — |W|, |F| magnitudes
  WFc   — complex W/F (4 channels)
  PM    — (R2*, field map); W/F recovered by the LS fit, as a metric
  WF-PM — both
The nets take the legacy channel-interleaved acquisitions (nb, H, W,
2·ne), with no ConvLSTM front. With a TE protocol other than the default
(both `TE1` and `dTE` changed), A is resynthesized from B at the batch's TE
train (`ops.synthesize_fused`, the synthesis kernel on the card). In PM mode
the diagnostic `WF_loss` fits ρ from A and the predicted maps
(`ops.fit_rho_fused`, the fit kernel on the card) under `torch.no_grad()`:
it feeds a metric, not the loss, so no gradient flows through it, as in the
JAX package. CPU tensors run both kernels' plain versions.

With `bf16` the generator computes in bfloat16 while its parameters stay
float32, and its output is upcast to float32 before the losses and the fit,
as in the JAX package; `remat` rematerializes its blocks in the backward.
With `microbatch` > 0 the step accumulates its gradients over chunks of that
many slices (`common.accumulate_microbatch_grads`), each drawing its own
input noise, the batch-sum terms (TV, L1) scaled by the chunk count. The JAX
package's data-parallel mesh (`data_mesh_for_batch`, `shard_batch`) has no
counterpart here: one card runs the step (ROADMAP Queue 1 item 8b).
"""

from __future__ import annotations

import torch

from ..cli.common import resolve_device
from ..data import layouts
from ..losses import l1_mean, total_variation_2d
from ..models import MDWFNet, UNet, VETNet
from ..ops import fit_rho_fused, synthesize_fused
from .common import (ModelState, accumulate_microbatch_grads, compute_dtype,
                     linear_decay_schedule, make_adam)

DEFAULTS = dict(
    dataset="WF-sup", data_size=192, DL_gen=False, DL_partial_real=0,
    DL_filename="LDM_ds", sigma_noise=0.0, shuffle=True, n_echoes=6,
    TE1=0.0013, dTE=0.0021, field=1.5, out_vars="WF", G_model="multi-decod",
    n_G_filters=72, batch_size=8, epochs=100, epoch_decay=100, epoch_ckpt=10,
    lr=0.0005, beta_1=0.9, beta_2=0.9999, R2_TV_weight=0.0, FM_TV_weight=0.0,
    R2_L1_weight=0.0, FM_L1_weight=0.0, D1_SelfAttention=False,
    D2_SelfAttention=True, D3_SelfAttention=True, bf16=False, remat=False,
    microbatch=0,
)

SupState = ModelState  # the generator, its optimizer and the step count


def build_model(cfg):
    """The generator, as the JAX package selects it. `multi-decod` is
    MDWF-Net for WF-PM and else the two-decoder PM generator (VET-Net
    without the ConvLSTM front or TE input); with out_vars WF (the
    default) its (R2*, FM) heads are trained against |W|, |F|, as in the
    JAX package. `U-Net` has heads 4 × tanh (WFc), 4 × relu (WF-PM) or
    2 × relu. Every net takes the legacy 2·n_echoes input channels.
    multi-decod with WFc and any other G_model (the reference's MEBCRN
    among them) raise NameError, as in the JAX package. Each in the
    config's compute dtype (`bf16`) and with its `remat`."""
    cin = 2 * cfg["n_echoes"]
    kw = dict(dtype=compute_dtype(cfg), remat=bool(cfg.get("remat")))
    if cfg["G_model"] == "multi-decod":
        if cfg["out_vars"] == "WF-PM":
            return MDWFNet(cin, filters=cfg["n_G_filters"],
                           n_echoes=cfg["n_echoes"],
                           wf_self_attention=cfg["D1_SelfAttention"],
                           r2_self_attention=cfg["D2_SelfAttention"],
                           fm_self_attention=cfg["D3_SelfAttention"], **kw)
        if cfg["out_vars"] == "WFc":
            raise NameError("out_vars='WFc' requires G_model='U-Net' "
                            "(the reference's multi-decod generator has "
                            "2 output channels; its WFc branch crashes)")
        return VETNet(cin, me_layer=False, te_input=False, n_out=1,
                      filters=cfg["n_G_filters"],
                      r2_self_attention=cfg["D1_SelfAttention"],
                      fm_self_attention=cfg["D2_SelfAttention"], **kw)
    if cfg["G_model"] == "U-Net":
        if cfg["out_vars"] == "WFc":
            n_out, out_activ = 4, "tanh"
        elif cfg["out_vars"] == "WF-PM":
            n_out, out_activ = 4, "relu"
        else:
            n_out, out_activ = 2, "relu"
        return UNet(cin, n_out=n_out, me_layer=False,
                    filters=cfg["n_G_filters"], output_activation=out_activ,
                    self_attention=cfg["D1_SelfAttention"], **kw)
    raise NameError(
        f"Unrecognized generator {cfg['G_model']!r} (note: the reference's "
        "'MEBCRN' option is dead code — dl.MEBCRN does not exist)")


def _cabs(re, im):
    """|re + i·im|, with the derivative 0 at 0 (as `jnp.abs`)."""
    return torch.abs(torch.complex(re, im))


def _mae(a, b):
    return torch.mean(torch.abs(a - b))


def _masked(keep, x):
    return torch.where(keep, x, torch.zeros_like(x))


def make_loss_fn(cfg, model, tv_scale: float = 1.0):
    """The supervised loss as `loss_fn(A, B, te, noise=None) -> (loss,
    metrics)` over the model's current parameters. A (nb, ne, H, W, 2)
    acquisitions and B (nb, 3, H, W, 2) maps, MEBCRN; te (nb, ne, 1);
    noise (nb, H, W, 2·ne) standard normal in the legacy layout, needed
    when `sigma_noise` > 0 (the caller draws it; tests pass the JAX
    package's). `tv_scale` multiplies the batch-sum terms (TV, L1)."""
    out_vars = cfg["out_vars"]
    # resynthesized only where both TE1 and dTE differ from the default
    # protocol, at the batch's own TE train (the JAX package's rule)
    resynth = cfg["TE1"] != 0.0013 and cfg["dTE"] != 0.0021
    unet_like = cfg["G_model"] in ("U-Net", "MEBCRN")
    field = cfg["field"]

    def loss_fn(A, B, te, noise=None):
        if resynth:  # data, not parameters: no gradient to carry
            A = synthesize_fused(B, te, field)
        A_leg = layouts.acqs_from_mebcrn(A)
        B_leg = layouts.maps_from_mebcrn(B)
        if cfg["sigma_noise"] > 0.0:
            A_leg = A_leg + cfg["sigma_noise"] * noise
        B_WF = B_leg[..., :4]
        B_PM = B_leg[..., 4:]
        B_WF_abs = _cabs(B_WF[..., 0::2], B_WF[..., 1::2])

        out = model(A_leg).float()
        if out_vars == "WF":
            A2B_WF_abs = _masked(B_leg[..., :2] != 0.0, out[..., :2])
            A2B_R2 = torch.zeros_like(A2B_WF_abs[..., :1])
            A2B_FM = torch.zeros_like(A2B_R2)
            sup_loss = _mae(B_WF_abs, A2B_WF_abs)
        elif out_vars == "WFc":
            A2B_WF = _masked(B_leg[..., :4] != 0.0, out[..., :4])
            A2B_WF_abs = _cabs(A2B_WF[..., 0::2], A2B_WF[..., 1::2])
            A2B_R2 = torch.zeros_like(A2B_WF_abs[..., :1])
            A2B_FM = torch.zeros_like(A2B_R2)
            sup_loss = _mae(B_WF, A2B_WF)
        elif out_vars == "PM":
            pm = out[..., -2:] if cfg["G_model"] == "multi-decod" else out
            A2B_PM = _masked(B_leg[..., :2] != 0.0, pm)
            A2B_R2 = A2B_PM[..., :1]
            A2B_FM = A2B_PM[..., 1:]
            if unet_like:
                A2B_FM = _masked(B_leg[..., :1] != 0.0,
                                 (A2B_FM - 0.5) * 2.0)
                A2B_PM = torch.cat([A2B_R2, A2B_FM], dim=-1)
            with torch.no_grad():  # the LS fit feeds WF_loss only
                pm_meb = layouts.maps_to_mebcrn(A2B_PM.detach(), mode="PM")
                wf = fit_rho_fused(A, pm_meb, te, field)
                A2B_WF_abs = torch.movedim(_cabs(wf[..., 0], wf[..., 1]),
                                           1, -1)
            sup_loss = _mae(B_PM, A2B_PM)
        elif out_vars == "WF-PM":
            B_abs = torch.cat([B_WF_abs, B_PM], dim=-1)
            A2B_abs = _masked(B_leg[..., :4] != 0.0, out)
            A2B_WF_abs = A2B_abs[..., :2]
            A2B_R2 = A2B_abs[..., 2:3]
            A2B_FM = A2B_abs[..., 3:]
            if unet_like:
                A2B_FM = _masked(B_leg[..., :1] != 0.0,
                                 (A2B_FM - 0.5) * 2.0)
                A2B_abs = torch.cat([A2B_WF_abs, A2B_R2, A2B_FM], -1)
            sup_loss = _mae(B_abs, A2B_abs)
        else:
            raise ValueError(out_vars)

        metrics = {"sup_loss": sup_loss,
                   "WF_loss": _mae(B_WF_abs, A2B_WF_abs),
                   "R2_loss": _mae(B_PM[..., :1], A2B_R2),
                   "FM_loss": _mae(B_PM[..., 1:], A2B_FM)}
        reg = 0.0
        if out_vars not in ("WF", "WFc"):
            r2_tv = (torch.sum(total_variation_2d(A2B_R2))
                     * cfg["R2_TV_weight"] * tv_scale)
            fm_tv = (torch.sum(total_variation_2d(A2B_FM))
                     * cfg["FM_TV_weight"] * tv_scale)
            r2_l1 = l1_mean(A2B_R2) * cfg["R2_L1_weight"] * tv_scale
            fm_l1 = l1_mean(A2B_FM) * cfg["FM_L1_weight"] * tv_scale
            reg = r2_tv + fm_tv + r2_l1 + fm_l1
            metrics.update(TV_R2=r2_tv, TV_FM=fm_tv, L1_R2=r2_l1,
                           L1_FM=fm_l1)
        return sup_loss + reg, metrics

    return loss_fn


def draw_noise(cfg, A, generator: torch.Generator):
    """The legacy-layout input noise (nb, H, W, 2·ne) from `generator` on
    A's device, or None without `sigma_noise`."""
    if cfg["sigma_noise"] <= 0.0:
        return None
    nb, ne, hgt, wdt, two = A.shape
    return torch.randn((nb, hgt, wdt, ne * two), generator=generator,
                       device=A.device)


def make_grad_fn(cfg, model):
    """The gradients as `grad_fn(A, B, te, noise) -> (loss, metrics)`: they
    are left in the parameters' `.grad` (which the caller zeroes). With
    `microbatch` > 0 over chunks of that many slices
    (`accumulate_microbatch_grads`, the batch-sum terms scaled by the chunk
    count), chunk i taking noise rows [i·micro, (i+1)·micro); else one
    backward of the full batch."""
    micro = int(cfg.get("microbatch") or 0)
    params = list(model.parameters())

    def grad_fn(A, B, te, noise=None):
        n_chunks = A.shape[0] // micro if micro else 1
        loss_fn = make_loss_fn(cfg, model, tv_scale=float(n_chunks))
        if micro:
            return accumulate_microbatch_grads(loss_fn, params,
                                               (A, B, te, noise), micro)
        loss, metrics = loss_fn(A, B, te, noise)
        loss.backward()
        return loss, metrics

    return grad_fn


def make_train_step(cfg, model):
    """(train_step, tx): `train_step(state, (A, B, te), generator) ->
    (state, metrics)` draws the input noise from `generator` (on A's
    device; under `microbatch`, chunk by chunk, each its own) and takes one
    Adam step on the loss (the linear-decay schedule); tx is the optimizer
    recipe `params -> Adam`. The state is updated in place and returned;
    metrics carry `G_loss`."""
    grad_fn = make_grad_fn(cfg, model)
    micro = int(cfg.get("microbatch") or 0)
    total_steps = cfg.get("total_steps", cfg["epochs"])
    schedule = linear_decay_schedule(
        cfg["lr"], total_steps,
        int(cfg["epoch_decay"] * total_steps / max(cfg["epochs"], 1)))
    tx = make_adam(schedule, cfg["beta_1"], cfg["beta_2"])

    def train_step(state: SupState, batch, generator: torch.Generator):
        A, B, te = batch
        state.opt.zero_grad()
        noise = None
        if cfg["sigma_noise"] > 0.0:
            step = micro or A.shape[0]
            noise = torch.cat([draw_noise(cfg, A[i:i + step], generator)
                               for i in range(0, A.shape[0], step)])
        loss, metrics = grad_fn(A, B, te, noise)
        state.opt.step()
        state.step += 1
        metrics["G_loss"] = loss
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step, tx


def make_eval_step(cfg, model):
    """`eval_step(state, (A, B, te), generator) -> metrics`: the loss's
    metrics and `G_loss` without a gradient or an update."""
    loss_fn = make_loss_fn(cfg, model)

    @torch.no_grad()
    def eval_step(state: SupState, batch, generator: torch.Generator):
        A, B, te = batch
        loss, metrics = loss_fn(A, B, te, draw_noise(cfg, A, generator))
        metrics["G_loss"] = loss
        return metrics

    return eval_step


def init_state(cfg, model, tx, generator: torch.Generator,
               device="cuda") -> SupState:
    """Seeded random weights (`models.init_params`) on `device` (default
    the card; raises without one) and a fresh optimizer from the recipe
    `tx`."""
    dev = resolve_device(device)
    model.init_params(generator)
    model.to(dev)
    return SupState(model, tx(list(model.parameters())))
