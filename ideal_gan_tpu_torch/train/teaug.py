"""Physics-based TE-augmentation training (port of
`ideal_gan_tpu/train/teaug.py`).

Each step synthesizes acquisitions A from the ground-truth maps B at a
freshly sampled TE train through the forward physics (`ops.synthesize_fused`,
the synthesis kernel on the card) plus Gaussian noise, and trains the
TE-conditioned generator G_A2B on the MAE between its maps and B's:
- "PM-Gen" / "VET-Net" / "multi-decod": `models.VETNet` (ConvLSTM front,
  whose recurrence runs the ConvLSTM kernels), (FM, R2*) masked to B's
  support, plus the TV regularizers;
- "U-Net": a `models.UNet` with the ConvLSTM front and TE-AdaIN, two tanh
  channels read as FM and R2* = (x + 1)/2;
- "2U-Net": a one-channel FM U-Net; R2* comes from a second U-Net G_A2R2
  on the echo magnitudes (`build_r2_model`, the ConvLSTM at Cin = 1), run
  without a gradient in G_A2B's step and trained in its own step
  (`make_r2_train_step`) with G_A2B frozen;
- "MDWF-Net": `models.MDWFNet` on the legacy interleaved echoes with the
  "dense_l1" TE input, [|W|, |F|, R2*, FM] against B's magnitudes and
  maps, unmasked.
For the ME nets, a diagnostic `WF_loss` fits ρ̂ from A and the predicted
maps (`ops.fit_rho_fused`, the fit kernel on the card) under
`torch.no_grad()`: a metric, not part of the loss. With `out_vars="WF"`
G_A2B's first two channels are regressed on |W|, |F| directly (MDWF-Net
then raises, as its legacy-layout net cannot take the 5-D echoes; the JAX
package raises there too).

With `bf16` the generators compute in bfloat16 (their ConvLSTM fronts in
the kernels' bf16 storage mode) while their parameters stay float32, and
their outputs are upcast to float32 before the masks, the losses and the
fit, as in the JAX package; `remat` rematerializes their blocks in the
backward. With `microbatch` > 0 G_A2B's step accumulates its gradients over
chunks of that many slices (`common.accumulate_microbatch_grads`), each
chunk synthesizing its acquisitions with its own noise, the TV terms
scaled by the chunk count (`tv_scale`) so that the average is the
full-batch loss. On a data mesh (`mesh=`) each rank takes its rows of the
global batch, draws the noise of the global batch and keeps its rows
(`parallel.mesh.draw_rows`), scales the TV terms by the data size too, and
the optimizers average the gradients over the ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import physics
from ..cli.common import resolve_device
from ..data.layouts import acqs_from_mebcrn
from ..losses import total_variation_2d
from ..models import MDWFNet, UNet, VETNet
from ..ops import fit_rho_fused, synthesize_fused
from ..parallel.mesh import data_size, draw_rows
from .common import (Adam, ModelState, accumulate_microbatch_grads,
                     compute_dtype, linear_decay_schedule, make_adam)

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


def build_model(cfg):
    """The generator G_A2B of `cfg["G_model"]`: VET-Net or the U-Nets on
    the complex echoes (Cin = 2), MDWF-Net on the legacy 2·ne channels;
    other names raise NameError, as in the JAX package. Each in the
    config's compute dtype (`bf16`) and with its `remat`."""
    g, te_input = cfg["G_model"], cfg.get("te_input", True)
    kw = dict(dtype=compute_dtype(cfg), remat=bool(cfg.get("remat")))
    if g in _VETNET:
        return VETNet(2, te_input=te_input, filters=cfg["n_G_filters"],
                      r2_self_attention=cfg["R2_SelfAttention"],
                      fm_self_attention=cfg["FM_SelfAttention"], **kw)
    if g in ("U-Net", "2U-Net"):
        return UNet(2, n_out=1 if g == "2U-Net" else 2, me_layer=True,
                    te_input=te_input, filters=cfg["n_G_filters"],
                    self_attention=cfg["FM_SelfAttention"], **kw)
    if g == "MDWF-Net":
        return MDWFNet(2 * cfg["n_echoes"], filters=cfg["n_G_filters"],
                       te_input=te_input, n_echoes=cfg["n_echoes"],
                       r2_self_attention=cfg["R2_SelfAttention"],
                       fm_self_attention=cfg["FM_SelfAttention"], **kw)
    raise NameError(f"Unrecognized generator {g!r}")


def build_r2_model(cfg) -> UNet:
    """The 2U-Net's second net G_A2R2: a U-Net with the ConvLSTM front on
    the echo magnitudes (Cin = 1), TE-AdaIN and a sigmoid R2* head."""
    return UNet(1, n_out=1, me_layer=True, te_input=cfg.get("te_input", True),
                filters=cfg["n_G_filters"], output_activation="sigmoid",
                self_attention=cfg["R2_SelfAttention"],
                dtype=compute_dtype(cfg), remat=bool(cfg.get("remat")))


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


def _magnitude(x):
    return torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))


def _synthesized(cfg, B, te, noise):
    """The acquisitions of B's maps at te (the synthesis kernel on the
    card, per-echo form: the TE trains are jittered) plus `noise_std`·noise;
    data, with no gradient."""
    A = synthesize_fused(B[:, :3], te, cfg["field"], uniform_te=False)
    return A + cfg["noise_std"] * noise


def _predict_pm(cfg, model, r2_model, A, te_vec):
    """G_A2B (with the 2U-Net, G_A2R2 on |A| without a gradient) → the PM
    row (nb, 1, H, W, [FM, R2*]) as float32."""
    g = cfg["G_model"]
    out = model(A, te_vec).float()
    if g in _VETNET:
        return out
    if g == "U-Net":
        return torch.cat([out[..., :1], (out[..., 1:] + 1.0) * 0.5], dim=-1)
    with torch.no_grad():  # 2U-Net: G_A2R2 gets no update in this step
        r2 = r2_model(_magnitude(A), te_vec).float()
    return torch.cat([out, r2], dim=-1)


def _wf_mae(cfg, A, pm, te, B_wf_abs):
    """The B→A→B̂ map consistency through the fit kernel (a diagnostic,
    without a gradient)."""
    with torch.no_grad():
        wf_hat = fit_rho_fused(A, pm.detach(), te, cfg["field"],
                               uniform_te=False)
        return torch.mean(torch.abs(B_wf_abs - _magnitude(wf_hat)))


def make_loss_fn(cfg, model, r2_model=None, tv_scale: float = 1.0):
    """The generator loss as `loss_fn(B, te, noise) -> (loss, metrics)` over
    G_A2B's current parameters. B (nb, ≥3, H, W, 2) ground-truth maps,
    te (nb, ne, 1), noise (nb, ne, H, W, 2) standard normal (the caller
    draws it; tests pass the JAX package's); `r2_model` is the 2U-Net's
    G_A2R2. `tv_scale` multiplies the batch-sum TV terms (a microbatched
    step's chunk count)."""
    g_model, out_vars = cfg["G_model"], cfg["out_vars"]
    zero = torch.zeros(())

    def loss_fn(B, te, noise):
        A = _synthesized(cfg, B, te, noise)
        te_vec = te[..., 0]
        B_pm = B[:, 2:3]
        B_wf_abs = _magnitude(B[:, :2])
        if out_vars == "WF":
            # G_A2B's species-last output (nb, 1, H, W, 2) against B's
            # species rows (nb, 2, H, W, 1), masked to |B| > 0
            wf_abs = model(A, te_vec).float().permute(0, 4, 2, 3, 1)
            wf_abs = torch.where(B_wf_abs != 0.0, wf_abs,
                                 torch.zeros_like(wf_abs))
            sup = torch.mean(torch.abs(B_wf_abs - wf_abs))
            z = zero.to(sup.device)
            return sup, {"PM_loss": sup, "WF_loss": sup, "TV_R2": z,
                         "TV_FM": z, "G_loss": sup}
        if g_model == "MDWF-Net":
            out = model(acqs_from_mebcrn(A), te_vec).float()[:, None]
            wf_abs = out[..., :2].permute(0, 4, 2, 3, 1)
            pm = torch.stack([out[..., 3], out[..., 2]], dim=-1)
            wf_mae = torch.mean(torch.abs(B_wf_abs - wf_abs))
            sup = wf_mae + torch.mean(torch.abs(B_pm - pm))
        else:
            pm = _predict_pm(cfg, model, r2_model, A, te_vec)
            # support mask of the GT PM rows, before the MAE and the TV terms
            pm = torch.where(B_pm != 0.0, pm, torch.zeros_like(pm))
            if cfg["sel_weight"]:
                sel_w = _selective_weight(cfg, B, A, te)
                sel_w = torch.cat([sel_w, sel_w], dim=-1)
            else:
                sel_w = 1.0
            sup = torch.mean(torch.abs(sel_w * B_pm - sel_w * pm))
            wf_mae = _wf_mae(cfg, A, pm, te, B_wf_abs)
        fm, r2 = pm[..., :1], pm[..., 1:]
        r2_tv = (torch.sum(total_variation_2d(r2[:, 0])) * cfg["R2_TV_weight"]
                 * tv_scale)
        fm_tv = (torch.sum(total_variation_2d(fm[:, 0])) * cfg["FM_TV_weight"]
                 * tv_scale)
        loss = sup + r2_tv + fm_tv
        return loss, {"PM_loss": sup, "WF_loss": wf_mae, "TV_R2": r2_tv,
                      "TV_FM": fm_tv, "G_loss": loss}

    return loss_fn


def make_r2_loss_fn(cfg, model, r2_model, tv_scale: float = 1.0):
    """The 2U-Net's second loss as `loss_fn(B, te, noise) -> (loss,
    metrics)` over G_A2R2's current parameters: its R2* (masked to B's
    support) against B's, plus its TV (times `tv_scale`); G_A2B runs
    frozen, without a gradient; `WF_loss_aux` fits ρ̂ as the first loss's
    diagnostic."""

    def loss_fn(B, te, noise):
        A = _synthesized(cfg, B, te, noise)
        te_vec = te[..., 0]
        with torch.no_grad():  # G_A2B frozen
            fm = model(A, te_vec).float()
        r2 = r2_model(_magnitude(A), te_vec).float()
        pm = torch.cat([fm, r2], dim=-1)
        pm = torch.where(B[:, 2:3] != 0.0, pm, torch.zeros_like(pm))
        r2_loss = torch.mean(torch.abs(B[:, 2:3, ..., 1:] - pm[..., 1:]))
        r2_tv = (torch.sum(total_variation_2d(pm[:, 0, ..., 1:]))
                 * cfg["R2_TV_weight"] * tv_scale)
        wf_mae = _wf_mae(cfg, A, pm, te, _magnitude(B[:, :2]))
        return r2_loss + r2_tv, {"R2_loss": r2_loss, "TV_R2_aux": r2_tv,
                                 "WF_loss_aux": wf_mae}

    return loss_fn


@dataclasses.dataclass
class TEAugState(ModelState):
    """G_A2B, its optimizer and the step count; with the 2U-Net also
    G_A2R2 and its own optimizer (the same recipe)."""
    r2_model: torch.nn.Module | None = None
    opt_r2: Adam | None = None

    def state_dict(self) -> dict:
        state = super().state_dict()
        if self.r2_model is not None:
            state["r2_model"] = {k: v.detach().cpu() for k, v in
                                 self.r2_model.state_dict().items()}
            state["opt_r2"] = self.opt_r2.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        if self.r2_model is not None:
            self.r2_model.load_state_dict(state["r2_model"])
            self.opt_r2.load_state_dict(state["opt_r2"])


def draw_noise(B, te, generator: torch.Generator, mesh=None,
               chunk: int = 0) -> torch.Tensor:
    """Standard normal acquisition noise (nb, ne, H, W, 2) from `generator`
    on B's device, drawn in chunks of `chunk` slices (at once where 0); on a
    mesh, the global batch's noise drawn so and this rank's rows of it."""
    return draw_rows(lambda k: torch.randn((k, te.shape[1], *B.shape[2:]),
                                           generator=generator,
                                           device=B.device),
                     B.shape[0], mesh, chunk)


def _schedule(cfg):
    total_steps = cfg.get("total_steps", cfg["epochs"])
    return linear_decay_schedule(
        cfg["lr"], total_steps,
        int(cfg["epoch_decay"] * total_steps / max(cfg["epochs"], 1)))


def make_grad_fn(cfg, model, r2_model=None, mesh=None):
    """G_A2B's gradients as `grad_fn(B, te, noise) -> (loss, metrics)`:
    they are left in the parameters' `.grad` (which the caller zeroes).
    With `microbatch` > 0 over chunks of that many slices
    (`accumulate_microbatch_grads`, the TV terms scaled by the chunk
    count), chunk i taking noise rows [i·micro, (i+1)·micro); else one
    backward of the full batch. On a mesh the TV terms also carry the data
    size."""
    micro = int(cfg.get("microbatch") or 0)
    params = [p for p in model.parameters() if p.requires_grad]

    def grad_fn(B, te, noise):
        n_chunks = B.shape[0] // micro if micro else 1
        loss_fn = make_loss_fn(cfg, model, r2_model,
                               tv_scale=float(n_chunks * data_size(mesh)))
        if micro:
            return accumulate_microbatch_grads(loss_fn, params,
                                               (B, te, noise), micro)
        loss, metrics = loss_fn(B, te, noise)
        loss.backward()
        return loss, metrics

    return grad_fn


def make_train_step(cfg, model, r2_model=None, mesh=None):
    """(train_step, tx): `train_step(state, (B, te), generator) -> (state,
    metrics)` draws the noise from `generator` (`draw_noise`; under
    `microbatch`, chunk by chunk, each its own; on a `mesh`, the global
    batch's) and takes one Adam step on G_A2B's loss (no gradient clipping,
    as the JAX trainer); tx is the optimizer recipe `params -> Adam`,
    averaging over the mesh's ranks. The state is updated in place and
    returned."""
    grad_fn = make_grad_fn(cfg, model, r2_model, mesh)
    micro = int(cfg.get("microbatch") or 0)
    tx = make_adam(_schedule(cfg), cfg["beta_1"], cfg["beta_2"], mesh=mesh)

    def train_step(state: TEAugState, batch, generator: torch.Generator):
        B, te = batch
        state.opt.zero_grad()
        noise = draw_noise(B, te, generator, mesh, micro)
        loss, metrics = grad_fn(B, te, noise)
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step, tx


def make_r2_train_step(cfg, model, r2_model, tx, mesh=None):
    """The 2U-Net's second step: `train_step(state, (B, te), generator) ->
    (state, metrics)` takes one step of G_A2R2's optimizer (the recipe
    `tx`, its own state) on `make_r2_loss_fn`, G_A2B frozen; the step
    count is G_A2B's and does not move. The JAX CLI hands both steps of a
    batch the same key: replay `generator`'s state to draw the same
    noise (on a `mesh`, the global batch's, as the first step's)."""
    loss_fn = make_r2_loss_fn(cfg, model, r2_model, data_size(mesh))

    def train_step(state: TEAugState, batch, generator: torch.Generator):
        B, te = batch
        state.opt_r2.zero_grad()
        loss, metrics = loss_fn(B, te, draw_noise(B, te, generator, mesh))
        loss.backward()
        state.opt_r2.step()
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def init_state(cfg, model, tx, generator: torch.Generator,
               device="cuda", r2_model=None) -> TEAugState:
    """Seeded random weights (`models.init_params`) on `device` (default
    the card; raises without one) and fresh optimizers from the recipe
    `tx` over the trainable parameters, for G_A2B and (2U-Net) G_A2R2."""
    dev = resolve_device(device)
    nets = [model] if r2_model is None else [model, r2_model]
    opts = []
    for net in nets:
        net.init_params(generator)
        net.to(dev)
        opts.append(tx([p for p in net.parameters() if p.requires_grad]))
    if r2_model is None:
        return TEAugState(model, opts[0])
    return TEAugState(model, opts[0], r2_model=r2_model, opt_r2=opts[1])
