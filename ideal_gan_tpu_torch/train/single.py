"""Self-supervised single-subject fitting (port of
`ideal_gan_tpu/train/single.py`, the rebuild of train-IDEAL-single.py).

Two multi-echo UNets, G_mag on |S| (sigmoid head) and G_pha on ∠S/π
(linear head), both with the ConvLSTM front (the ConvLSTM kernels at
Cin = 1), produce the magnitude and phase rows of the separate-phase
forward model (`physics.synthesize_mag_phase`, plain torch); the loss is
the full-batch self-consistency ‖A − Â‖ on the few slices of one subject,
with the bipolar-gradient regularizers (the x-gradient sign and the
left/right symmetry of the bipolar phase map). Both nets train under one
Adam.

With `bf16` both nets compute in bfloat16 (their ConvLSTM fronts in the
kernels' bf16 storage mode) while their parameters stay float32, and their
outputs are upcast to float32 before the physics, as in the JAX package;
`remat` rematerializes their blocks in the backward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import physics
from ..cli.common import resolve_device
from ..losses import l1_mean, total_variation_2d
from ..models import UNet
from .common import Adam, compute_dtype, linear_decay_schedule, make_adam

DEFAULTS = dict(
    dataset="WF-IDEAL", is_phantom=False, grad_mode="bipolar", n_echoes=6,
    data_idx=3, n_G_filters=36, epochs=7000, epoch_decay=24000,
    epoch_ckpt=500, lr=0.0008, beta_1=0.9, beta_2=0.999, main_loss="MSE",
    FM_TV_weight=0.0, FM_L1_weight=0.0, BP_GR_weight=0.0,
    BP_GR_sym_weight=1.0, D1_SelfAttention=False, D2_SelfAttention=True,
    bf16=False, remat=False,
)


@dataclasses.dataclass
class SingleState:
    """The trainer's state: both nets, their joint optimizer and the step
    count."""
    g_mag: torch.nn.Module
    g_pha: torch.nn.Module
    opt: Adam
    step: int = 0

    def state_dict(self) -> dict:
        """CPU tensors and ints, for `utils.Checkpoint`."""
        def cpu(sd):
            return {k: v.detach().cpu() for k, v in sd.items()}

        return {"g_mag": cpu(self.g_mag.state_dict()),
                "g_pha": cpu(self.g_pha.state_dict()),
                "opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.g_mag.load_state_dict(state["g_mag"])
        self.g_pha.load_state_dict(state["g_pha"])
        self.opt.load_state_dict(state["opt"])
        self.step = int(state["step"])


def build_models(cfg):
    """(g_mag, g_pha): G_mag on the echo magnitudes (3 sigmoid channels
    |W|, |F|, R2*) and G_pha on their phases (φ_W, φ_F, φ and, bipolar, the
    readout phase: linear), both Cin = 1 with the ConvLSTM front, in the
    config's compute dtype (`bf16`) and with its `remat`."""
    bipolar = cfg["grad_mode"] == "bipolar"
    kw = dict(dtype=compute_dtype(cfg), remat=bool(cfg.get("remat")))
    g_mag = UNet(1, n_out=3, me_layer=True, filters=cfg["n_G_filters"],
                 output_activation="sigmoid",
                 self_attention=cfg["D1_SelfAttention"], **kw)
    g_pha = UNet(1, n_out=4 if bipolar else 3, me_layer=True,
                 filters=cfg["n_G_filters"], output_activation="none",
                 self_attention=cfg["D2_SelfAttention"], **kw)
    return g_mag, g_pha


def _loss(name):
    if name == "MSE":
        return lambda a, b: torch.mean(torch.square(a - b))
    if name == "MAE":
        return lambda a, b: torch.mean(torch.abs(a - b))
    if name == "MSLE":
        return lambda a, b: torch.mean(torch.square(
            torch.log1p(torch.clamp(a, min=0)) - torch.log1p(
                torch.clamp(b, min=0))))
    raise NameError(f"Unrecognized Main Loss Function {name!r}")


def symmetry_halves(bp: torch.Tensor):
    """The bipolar map's left half-band, columns [w//4, w//2), and the
    mirrored right one, columns w−w//4−1 down to w−w//2 (the JAX package's
    negative-step slice −(w//4+1):−(w//2+1):−1, which torch has not), of
    bp (nb, H, W, C)."""
    wdt = bp.shape[2]
    left = bp[:, :, wdt // 4:wdt // 2]
    right = torch.flip(bp[:, :, wdt - wdt // 2:wdt - wdt // 4], dims=[2])
    return left, right


def make_loss_fn(cfg, g_mag, g_pha):
    """The single-subject separate-phase cycle loss as `loss_fn(A, B, te)
    -> (loss, metrics)` over the nets' current parameters: A the echoes
    (nb, ne, H, W, 2), B the maps (nb, 3, H, W, 2) that give the masks and
    the WF, R2 and FM metrics, te (nb, ne, 1)."""
    bipolar = cfg["grad_mode"] == "bipolar"
    field = 3.0 if cfg["is_phantom"] else 1.5
    loss_fn_pt = _loss(cfg["main_loss"])

    def loss_fn(A, B, te):
        a_mag = torch.sqrt(torch.sum(torch.square(A), dim=-1, keepdim=True))
        a_pha = torch.atan2(A[..., 1:], A[..., :1]) / np.pi
        b_wf_abs = torch.sqrt(torch.sum(torch.square(B[:, :2]), dim=-1,
                                        keepdim=True))  # (nb, 2, H, W, 1)
        b_wf_abs = b_wf_abs.permute(0, 4, 2, 3, 1)  # (nb, 1, H, W, 2)
        b_mag_msk = torch.cat([b_wf_abs, b_wf_abs[..., :1]], dim=-1)
        b_pha_msk = (torch.cat([b_mag_msk, b_wf_abs[..., :1]], dim=-1)
                     if bipolar else b_mag_msk)

        a2b_mag = g_mag(a_mag).float()
        a2b_pha = g_pha(a_pha).float()
        a2b_mag = torch.where(b_mag_msk != 0.0, a2b_mag, 0.0)
        a2b_pha = torch.where(b_pha_msk != 0.0, a2b_pha, 0.0)
        # both rows padded to 4 channels for the forward model
        a2b_mag = torch.cat([a2b_mag, torch.zeros_like(a2b_mag[..., :1])],
                            dim=-1)
        if not bipolar:
            a2b_pha = torch.cat([a2b_pha,
                                 torch.zeros_like(a2b_pha[..., :1])], dim=-1)
        a2b = torch.cat([a2b_mag, a2b_pha], dim=1)  # (nb, 2, H, W, 4)

        a2b2a = physics.synthesize_mag_phase(a2b, te, field=field)
        a2b2a = torch.where(A != 0.0, a2b2a, 0.0)
        cycle_loss = loss_fn_pt(A, a2b2a)

        wf_loss = loss_fn_pt(b_wf_abs, a2b[:, :1, :, :, :2])
        r2_loss = loss_fn_pt(B[:, 2:, ..., 1:], a2b[:, :1, :, :, 2:3])
        fm_loss = loss_fn_pt(B[:, 2:, ..., :1], a2b[:, 1:, :, :, 2:3])

        fm_tv = torch.sum(total_variation_2d(a2b[:, 1, :, :, 2:3]))
        fm_l1 = l1_mean(a2b[:, 1:, :, :, 2:3])
        g_loss = (cycle_loss + fm_tv * cfg["FM_TV_weight"]
                  + fm_l1 * cfg["FM_L1_weight"])

        bp_gr = torch.zeros((), device=A.device)
        if bipolar:
            bp = a2b[:, 1, :, :, -1:]
            dy = bp[:, 1:, :, :] - bp[:, :-1, :, :]
            dx = bp[:, :, 1:, :] - bp[:, :, :-1, :]
            bp_gr = torch.sum(torch.abs(dy)) - torch.sum(torch.sign(dx))
            left, right = symmetry_halves(bp)
            bp_gr = bp_gr + cfg["BP_GR_sym_weight"] * torch.sum(
                torch.abs(left + right))
            g_loss = g_loss + bp_gr * cfg["BP_GR_weight"]

        return g_loss, {"A2B2A_cycle_loss": cycle_loss, "WF_loss": wf_loss,
                        "R2_loss": r2_loss, "FM_loss": fm_loss,
                        "TV_FM": fm_tv, "L1_FM": fm_l1, "BP_GR": bp_gr,
                        "G_loss": g_loss}

    return loss_fn


def make_train_step(cfg, g_mag, g_pha):
    """(train_step, tx): `train_step(state, (A, B, te)) -> (state,
    metrics)` takes one Adam step on both nets together (no clipping; the
    rate decays over `epochs` steps after `epoch_decay`); tx is the
    optimizer recipe `params -> Adam`. The state is updated in place and
    returned."""
    loss_fn = make_loss_fn(cfg, g_mag, g_pha)
    schedule = linear_decay_schedule(cfg["lr"], cfg["epochs"],
                                     cfg["epoch_decay"])
    tx = make_adam(schedule, cfg["beta_1"], cfg["beta_2"])

    def train_step(state: SingleState, batch):
        A, B, te = batch
        state.opt.zero_grad()
        loss, metrics = loss_fn(A, B, te)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step, tx


def init_state(cfg, g_mag, g_pha, tx, generator: torch.Generator,
               device="cuda") -> SingleState:
    """Seeded random weights for both nets (`models.init_params`) on
    `device` (default the card; raises without one) and one fresh optimizer
    from the recipe `tx` over both nets' parameters."""
    dev = resolve_device(device)
    for net in (g_mag, g_pha):
        net.init_params(generator)
        net.to(dev)
    return SingleState(g_mag, g_pha,
                       tx(list(g_mag.parameters()) + list(g_pha.parameters())))
