"""AI-DEAL unsupervised physics-loss training (port of
`ideal_gan_tpu/train/unsup.py`, without uncertainty quantification).

The field-map net g_fm predicts φ from the complex multi-echo acquisitions
(and, in PM mode, the R2* net g_r2 predicts R2* from their magnitudes); the
loss is the self-consistency of the IDEAL cycle ‖A − Â‖² with Â = W⁺MM⁺W⁻A,
no ground-truth maps. The cycle runs in the fused kernel
(`ops.cycle_full_fused`), the nets' ConvLSTM fronts in the ConvLSTM kernels.

Not ported yet (ROADMAP Queue 1 item 6): UQ (Bayesian heads, `var_mse`,
`acq_uncertainty`), the σ-calibration step (UQ_calib), bf16 and remat
UNets. Those settings raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from ..cli.common import resolve_device
from ..losses import l1_mean, total_variation_2d
from ..models import UNet
from ..ops import cycle_full_fused
from .common import Adam, linear_decay_schedule, make_adam

DEFAULTS = dict(
    dataset="Unsup-v0", n_echoes=6, field=1.5, out_vars="FM",  # FM | PM
    UQ=False, UQ_R2s=False, UQ_calib=False, rand_ne=False, remove_ech1=False,
    bf16=False, remat=False,
    data_aug_p=0.4, n_G_filters=36, batch_size=8, epochs=100, epoch_decay=100,
    epoch_ckpt=10, lr=0.0002, beta_1=0.9, beta_2=0.9999, grad_clip=1.0,
    FM_TV_weight=0.0, FM_L1_weight=0.0, R2_TV_weight=0.0, R2_L1_weight=0.0,
    D1_SelfAttention=True, D2_SelfAttention=False, uniform_te=True,
    learn_fm_offset=False, fm_offset_lr=1e-3,
)


def _check_ported(cfg) -> None:
    unported = [k for k in ("UQ", "UQ_R2s", "UQ_calib", "bf16", "remat")
                if cfg.get(k)]
    if unported:
        raise NotImplementedError(
            f"unsup settings {unported} are not ported yet (ROADMAP Queue 1 "
            f"item 6: Bayesian heads, var_mse, acq_uncertainty and the "
            f"calibration step; bf16 / remat UNets)")


def build_models(cfg):
    """(g_fm, g_r2): the field-map net on the complex echoes (Cin = 2, tanh
    head) and the R2* net on their magnitudes (Cin = 1, sigmoid head)."""
    _check_ported(cfg)
    g_fm = UNet(2, n_out=1, bayesian=cfg["UQ"], me_layer=True,
                filters=cfg["n_G_filters"],
                self_attention=cfg["D1_SelfAttention"])
    g_r2 = UNet(1, n_out=1, bayesian=cfg["UQ_R2s"], me_layer=True,
                filters=cfg["n_G_filters"], output_activation="sigmoid",
                self_attention=cfg["D2_SelfAttention"])
    return g_fm, g_r2


@dataclasses.dataclass
class UnsupState:
    """The trainer's state: both nets (their parameters), their optimizers,
    the global field-map offset (normalized units) and the step count."""
    g_fm: torch.nn.Module
    opt_fm: Adam
    g_r2: torch.nn.Module
    opt_r2: Adam
    fm_offset: torch.Tensor
    step: int = 0

    def state_dict(self) -> dict:
        """CPU tensors and ints, for `utils.Checkpoint`."""
        def cpu(sd):
            return {k: v.detach().cpu() for k, v in sd.items()}

        return {"g_fm": cpu(self.g_fm.state_dict()),
                "g_r2": cpu(self.g_r2.state_dict()),
                "opt_fm": self.opt_fm.state_dict(),
                "opt_r2": self.opt_r2.state_dict(),
                "fm_offset": self.fm_offset.detach().cpu(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.g_fm.load_state_dict(state["g_fm"])
        self.g_r2.load_state_dict(state["g_r2"])
        self.opt_fm.load_state_dict(state["opt_fm"])
        self.opt_r2.load_state_dict(state["opt_r2"])
        self.fm_offset = state["fm_offset"].to(self.fm_offset.device)
        self.step = int(state["step"])


def _as_mean_sigma(out: torch.Tensor):
    """A deterministic head's output → (mean as float32, σ = None)."""
    return out.float(), None


def _uq_pipeline(cfg, g_fm, g_r2, fm_offset, A, te, stop_grad_r2=False,
                 stop_grad_fm=False, with_var=False):
    """Shared forward of the train steps: heads → fused physics cycle.
    A stop-gradient net runs under `torch.no_grad()`. Returns (fm_mean,
    r2_mean, a_hat, None); a_hat is masked to the acquisition support."""
    if with_var:
        raise NotImplementedError("the propagated acquisition variance (UQ) "
                                  "is not ported yet (ROADMAP Queue 1 item 6)")
    pm_mode = cfg["out_vars"] == "PM"
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_grad_fm):
        fm_mean, _ = _as_mean_sigma(g_fm(A))
        if cfg.get("learn_fm_offset"):
            # instance-normalized CNNs carry no DC channel, so the absolute
            # field-map level is weakly constrained; a learnable global
            # offset restores it, trained by the same cycle loss
            fm_mean = fm_mean + fm_offset
    if pm_mode:
        a_abs = torch.sqrt(torch.sum(torch.square(A), dim=-1, keepdim=True))
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not stop_grad_r2):
            r2_mean, _ = _as_mean_sigma(g_r2(a_abs))
    else:
        r2_mean = torch.zeros_like(fm_mean)
    pm = torch.cat([fm_mean, r2_mean], dim=-1)
    _, a_hat = cycle_full_fused(A, pm, te, cfg["field"],
                                uniform_te=cfg.get("uniform_te", False))
    a_hat = torch.where(A != 0.0, a_hat, torch.zeros_like(a_hat))
    return fm_mean, r2_mean, a_hat, None


def make_loss_fn(cfg, g_fm, g_r2):
    """The unsupervised cycle loss of the FM step as
    `loss_fn(fm_offset, A, te) -> (loss, metrics)` over the nets' current
    parameters (g_r2 frozen)."""
    _check_ported(cfg)

    def loss_fn(fm_offset, A, te):
        fm_mean, _, a_hat, _ = _uq_pipeline(cfg, g_fm, g_r2, fm_offset, A,
                                            te, stop_grad_r2=True)
        cycle_loss = torch.mean(torch.square(A - a_hat))
        fm_tv = torch.sum(total_variation_2d(fm_mean[:, 0])) \
            * cfg["FM_TV_weight"]
        fm_l1 = l1_mean(fm_mean) * cfg["FM_L1_weight"]
        loss = cycle_loss + fm_tv + fm_l1
        return loss, {"A2B2A_cycle_loss": cycle_loss, "TV_FM": fm_tv,
                      "L1_FM": fm_l1, "G_loss": loss}

    return loss_fn


def make_r2_loss_fn(cfg, g_fm, g_r2):
    """The R2 step's loss: the PM-mode cycle with g_fm frozen, as
    `loss_fn(fm_offset, A, te) -> (loss, metrics)`."""
    r2_cfg = cfg if cfg["out_vars"] == "PM" else dict(cfg, out_vars="PM")

    def loss_fn(fm_offset, A, te):
        _, r2_mean, a_hat, _ = _uq_pipeline(r2_cfg, g_fm, g_r2, fm_offset,
                                            A, te, stop_grad_fm=True)
        loss = torch.mean(torch.square(A - a_hat))
        r2_tv = torch.sum(total_variation_2d(r2_mean[:, 0])) \
            * cfg["R2_TV_weight"]
        r2_l1 = l1_mean(r2_mean) * cfg["R2_L1_weight"]
        return loss + r2_tv + r2_l1, {"R2_cycle_loss": loss, "TV_R2": r2_tv,
                                      "L1_R2": r2_l1}

    return loss_fn


def make_train_step(cfg, g_fm, g_r2):
    """(train_step, tx): `train_step(state, (A, te)) -> (state, metrics)`
    trains g_fm with Adam and takes a plain SGD step on fm_offset (a zero
    gradient unless learn_fm_offset); tx is the optimizer recipe
    `params -> Adam`. The state is updated in place and returned."""
    loss_fn = make_loss_fn(cfg, g_fm, g_r2)
    total_steps = cfg.get("total_steps", cfg["epochs"])
    schedule = linear_decay_schedule(
        cfg["lr"], total_steps,
        int(cfg["epoch_decay"] * total_steps / max(cfg["epochs"], 1)))
    tx = make_adam(schedule, cfg["beta_1"], cfg["beta_2"],
                   clip_norm=cfg["grad_clip"])

    def train_step(state: UnsupState, batch):
        A, te = batch
        state.opt_fm.zero_grad()
        fm_offset = state.fm_offset.detach().requires_grad_(True)
        loss, metrics = loss_fn(fm_offset, A, te)
        loss.backward()
        state.opt_fm.step()
        if fm_offset.grad is not None:
            state.fm_offset = (state.fm_offset
                               - cfg["fm_offset_lr"] * fm_offset.grad)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step, tx


def make_r2_train_step(cfg, g_fm, g_r2, tx):
    """Second phase: train the R2* net with the FM net frozen."""
    loss_fn = make_r2_loss_fn(cfg, g_fm, g_r2)

    def train_step(state: UnsupState, batch):
        A, te = batch
        state.opt_r2.zero_grad()
        loss, metrics = loss_fn(state.fm_offset, A, te)
        loss.backward()
        state.opt_r2.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def init_state(cfg, g_fm, g_r2, tx, generator: torch.Generator,
               device="cuda") -> UnsupState:
    """Seeded random weights for both nets (`models.init_params`), moved to
    `device` (default the card; raises without one), with fresh optimizers
    from the recipe `tx`."""
    dev = resolve_device(device)
    for net in (g_fm, g_r2):
        net.init_params(generator)
        net.to(dev)
    return UnsupState(g_fm, tx(g_fm.parameters()), g_r2,
                      tx(g_r2.parameters()),
                      torch.zeros((), dtype=torch.float32, device=dev))
