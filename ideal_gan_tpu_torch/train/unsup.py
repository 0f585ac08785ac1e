"""AI-DEAL unsupervised physics-loss training (port of
`ideal_gan_tpu/train/unsup.py`).

The field-map net g_fm predicts φ from the complex multi-echo acquisitions
(and, in PM mode, the R2* net g_r2 predicts R2* from their magnitudes); the
loss is the self-consistency of the IDEAL cycle ‖A − Â‖² with Â = W⁺MM⁺W⁻A,
no ground-truth maps. The cycle runs in the fused kernel
(`ops.cycle_full_fused`), the nets' ConvLSTM fronts in the ConvLSTM kernels.

With uncertainty quantification (UQ, UQ_R2s) the heads are Bayesian (a
`prob.Normal` φ posterior, a `prob.Rician` R2* posterior), and the FM
step's cycle loss becomes the heteroscedastic `var_mse` with per-echo
variances propagated through `physics.acq_uncertainty` (on the cycle
kernel's ρ, detached) and scaled by the per-echo non-negative calibration
`calib`. With UQ_calib, `make_calib_train_step` trains `calib` with plain
SGD on a calibration split while both nets stay frozen;
`eval_calibrated_nll` is the held-out NLL it is judged by.

The JAX steps split a key into `rngs={"bayes": ...}`, which no layer on
these paths reads (the AI-DEAL UNet has no Flipout layer, and no posterior
is sampled): the port's steps take no generator.

With `bf16` both nets compute in bfloat16 (their ConvLSTM fronts in the
kernels' bf16 storage mode) while the parameters stay float32, and the
heads' outputs are upcast to float32 before the cycle (`_as_mean_sigma`), as
in the JAX package; `remat` rematerializes the nets' blocks in the
backward.

On a data mesh (`mesh=`, `parallel.mesh`) each rank's step takes its rows
of the global batch, its batch-sum terms (the TV and L1 regularizers) carry
the data size, and the optimizers average the gradients over the ranks
before the clip, so that the step equals the one-process step on the whole
batch.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import physics
from ..cli.common import resolve_device
from ..losses import l1_mean, total_variation_2d, var_mse
from ..models import UNet
from ..ops import cycle_full_fused
from ..parallel.mesh import all_reduce_grads, data_size
from ..prob import Normal, Rician
from .common import (SGD, Adam, compute_dtype, linear_decay_schedule,
                     make_adam)

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


def build_models(cfg):
    """(g_fm, g_r2): the field-map net on the complex echoes (Cin = 2, tanh
    head; a `Normal` posterior with UQ) and the R2* net on their magnitudes
    (Cin = 1, sigmoid head; a `Rician` posterior with UQ_R2s), in the
    config's compute dtype (`bf16`) and with its `remat`."""
    kw = dict(dtype=compute_dtype(cfg), remat=bool(cfg.get("remat")))
    g_fm = UNet(2, n_out=1, bayesian=cfg["UQ"], me_layer=True,
                filters=cfg["n_G_filters"],
                self_attention=cfg["D1_SelfAttention"], **kw)
    g_r2 = UNet(1, n_out=1, bayesian=cfg["UQ_R2s"], me_layer=True,
                filters=cfg["n_G_filters"], output_activation="sigmoid",
                self_attention=cfg["D2_SelfAttention"], **kw)
    return g_fm, g_r2


@dataclasses.dataclass
class UnsupState:
    """The trainer's state: both nets (their parameters), their optimizers,
    the per-echo non-negative σ²-scale `calib` (n_echoes,) with its SGD,
    the global field-map offset (normalized units) and the step count."""
    g_fm: torch.nn.Module
    opt_fm: Adam
    g_r2: torch.nn.Module
    opt_r2: Adam
    calib: torch.Tensor
    opt_calib: SGD
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
                "calib": self.calib.detach().cpu().clone(),
                "opt_calib": self.opt_calib.state_dict(),
                "fm_offset": self.fm_offset.detach().cpu(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Checkpoints written before the calibration was ported have no
        `calib`: they get ones, the initial scale."""
        self.g_fm.load_state_dict(state["g_fm"])
        self.g_r2.load_state_dict(state["g_r2"])
        self.opt_fm.load_state_dict(state["opt_fm"])
        self.opt_r2.load_state_dict(state["opt_r2"])
        with torch.no_grad():
            self.calib.copy_(state.get("calib", torch.ones_like(self.calib)))
        if "opt_calib" in state:
            self.opt_calib.load_state_dict(state["opt_calib"])
        self.fm_offset = state["fm_offset"].to(self.fm_offset.device)
        self.step = int(state["step"])


def _as_mean_sigma(out):
    """A head's output → (mean, σ) as float32: (loc, scale) of a `Normal`,
    (ν, σ) of a `Rician`, (out, None) of a deterministic head."""
    if isinstance(out, Normal):
        return out.loc.float(), out.scale.float()
    if isinstance(out, Rician):
        return out.nu.float(), out.sigma.float()
    return out.float(), None


def _calib_scale(calib: torch.Tensor, ne: int) -> torch.Tensor:
    """The per-echo σ²-scale broadcast over (nb, ne, H, W, ch): the first
    `ne` entries of `calib` (the JAX package's indexing, also under
    rand_ne)."""
    return calib[:ne][None, :, None, None, None]


def _posterior(mean: torch.Tensor, sigma) -> physics.Posterior:
    """A (nb, 1, H, W, 1) head's (mean, σ) as the (nb, H, W) posterior
    (variance σ², or 0 for a deterministic head)."""
    mean = mean[:, 0, ..., 0]
    return physics.Posterior(mean, torch.zeros_like(mean) if sigma is None
                             else torch.square(sigma[:, 0, ..., 0]))


def _uq_pipeline(cfg, g_fm, g_r2, fm_offset, A, te, calib=None,
                 stop_grad_r2=False, stop_grad_fm=False, stop_grad_wf=False,
                 with_var=False):
    """Shared forward of the train steps, the calibration step and the
    held-out NLL: posterior heads → fused physics cycle → (with_var) the
    propagated per-echo acquisition variance, times the calibration scale
    where `calib` is given. A stop-gradient net runs under
    `torch.no_grad()`; with `stop_grad_wf` the variance propagates the
    cycle's ρ detached. Returns (fm_mean, r2_mean, a_hat, a_var); a_hat is
    masked to the acquisition support, a_var is None without with_var."""
    pm_mode = cfg["out_vars"] == "PM"
    with torch.set_grad_enabled(torch.is_grad_enabled() and not stop_grad_fm):
        fm_mean, fm_sigma = _as_mean_sigma(g_fm(A))
        if cfg.get("learn_fm_offset"):
            # instance-normalized CNNs carry no DC channel, so the absolute
            # field-map level is weakly constrained; a learnable global
            # offset restores it, trained by the same cycle loss
            fm_mean = fm_mean + fm_offset
    if pm_mode:
        a_abs = torch.sqrt(torch.sum(torch.square(A), dim=-1, keepdim=True))
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not stop_grad_r2):
            r2_mean, r2_sigma = _as_mean_sigma(g_r2(a_abs))
    else:
        r2_mean, r2_sigma = torch.zeros_like(fm_mean), None
    pm = torch.cat([fm_mean, r2_mean], dim=-1)
    wf, a_hat = cycle_full_fused(A, pm, te, cfg["field"],
                                 uniform_te=cfg.get("uniform_te", False))
    a_hat = torch.where(A != 0.0, a_hat, torch.zeros_like(a_hat))
    if not with_var:
        return fm_mean, r2_mean, a_hat, None
    a_var = physics.acq_uncertainty(
        wf.detach() if stop_grad_wf else wf, _posterior(fm_mean, fm_sigma),
        _posterior(r2_mean, r2_sigma), te, field=cfg["field"],
        rem_r2=not pm_mode)
    if calib is not None:
        a_var = a_var * _calib_scale(calib, a_var.shape[1])
    return fm_mean, r2_mean, a_hat, a_var


def _nll(A, a_hat, a_var) -> torch.Tensor:
    """The heteroscedastic cycle loss `var_mse` on [Â, Var Â]."""
    return var_mse(A, torch.cat([a_hat, a_var], dim=-1))


def make_loss_fn(cfg, g_fm, g_r2, tv_scale: float = 1.0):
    """The cycle loss of the FM step as `loss_fn(fm_offset, A, te,
    calib=None) -> (loss, metrics)` over the nets' current parameters (g_r2
    frozen): ‖A − Â‖², or with UQ `var_mse` on the variance propagated
    from the cycle's detached ρ and scaled by `calib` (ones where None).
    `tv_scale` multiplies the batch-sum terms (TV, L1)."""
    uq = cfg["UQ"]

    def loss_fn(fm_offset, A, te, calib=None):
        if uq and calib is None:
            calib = torch.ones(cfg["n_echoes"], device=A.device)
        fm_mean, _, a_hat, a_var = _uq_pipeline(
            cfg, g_fm, g_r2, fm_offset, A, te, calib, stop_grad_r2=True,
            stop_grad_wf=True, with_var=uq)
        cycle_loss = (_nll(A, a_hat, a_var) if uq
                      else torch.mean(torch.square(A - a_hat)))
        fm_tv = torch.sum(total_variation_2d(fm_mean[:, 0])) \
            * cfg["FM_TV_weight"] * tv_scale
        fm_l1 = l1_mean(fm_mean) * cfg["FM_L1_weight"] * tv_scale
        loss = cycle_loss + fm_tv + fm_l1
        return loss, {"A2B2A_cycle_loss": cycle_loss, "TV_FM": fm_tv,
                      "L1_FM": fm_l1, "G_loss": loss}

    return loss_fn


def make_r2_loss_fn(cfg, g_fm, g_r2, tv_scale: float = 1.0):
    """The R2 step's loss: the PM-mode cycle with g_fm frozen, as
    `loss_fn(fm_offset, A, te) -> (loss, metrics)`; `tv_scale` multiplies
    the batch-sum terms."""
    r2_cfg = cfg if cfg["out_vars"] == "PM" else dict(cfg, out_vars="PM")

    def loss_fn(fm_offset, A, te):
        _, r2_mean, a_hat, _ = _uq_pipeline(r2_cfg, g_fm, g_r2, fm_offset,
                                            A, te, stop_grad_fm=True)
        loss = torch.mean(torch.square(A - a_hat))
        r2_tv = torch.sum(total_variation_2d(r2_mean[:, 0])) \
            * cfg["R2_TV_weight"] * tv_scale
        r2_l1 = l1_mean(r2_mean) * cfg["R2_L1_weight"] * tv_scale
        return loss + r2_tv + r2_l1, {"R2_cycle_loss": loss, "TV_R2": r2_tv,
                                      "L1_R2": r2_l1}

    return loss_fn


def make_train_step(cfg, g_fm, g_r2, mesh=None):
    """(train_step, tx): `train_step(state, (A, te)) -> (state, metrics)`
    trains g_fm with Adam and takes a plain SGD step on fm_offset (a zero
    gradient unless learn_fm_offset); tx is the optimizer recipe
    `params -> Adam`, averaging over `mesh`'s ranks. The state is updated
    in place and returned; on a mesh the batch and the metrics are the
    rank's."""
    loss_fn = make_loss_fn(cfg, g_fm, g_r2, tv_scale=data_size(mesh))
    total_steps = cfg.get("total_steps", cfg["epochs"])
    schedule = linear_decay_schedule(
        cfg["lr"], total_steps,
        int(cfg["epoch_decay"] * total_steps / max(cfg["epochs"], 1)))
    tx = make_adam(schedule, cfg["beta_1"], cfg["beta_2"],
                   clip_norm=cfg["grad_clip"], mesh=mesh)

    def train_step(state: UnsupState, batch):
        A, te = batch
        state.opt_fm.zero_grad()
        fm_offset = state.fm_offset.detach().requires_grad_(True)
        loss, metrics = loss_fn(fm_offset, A, te, state.calib.detach())
        loss.backward()
        state.opt_fm.step()
        if fm_offset.grad is not None:
            all_reduce_grads([fm_offset], mesh)
            state.fm_offset = (state.fm_offset
                               - cfg["fm_offset_lr"] * fm_offset.grad)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step, tx


def make_r2_train_step(cfg, g_fm, g_r2, tx, mesh=None):
    """Second phase: train the R2* net with the FM net frozen (the
    optimizer from `tx`, the batch-sum terms scaled for `mesh`)."""
    loss_fn = make_r2_loss_fn(cfg, g_fm, g_r2, tv_scale=data_size(mesh))

    def train_step(state: UnsupState, batch):
        A, te = batch
        state.opt_r2.zero_grad()
        loss, metrics = loss_fn(state.fm_offset, A, te)
        loss.backward()
        state.opt_r2.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_calib_loss_fn(cfg, g_fm, g_r2):
    """The calibration step's loss as `loss_fn(calib, fm_offset, A, te) ->
    (loss, metrics)`: both nets frozen and run without a gradient, `var_mse`
    on the propagated variance scaled by `calib`, the only leaf that gets
    a gradient."""

    def loss_fn(calib, fm_offset, A, te):
        with torch.no_grad():
            _, _, a_hat, a_var = _uq_pipeline(cfg, g_fm, g_r2, fm_offset, A,
                                              te, with_var=True)
        loss = _nll(A, a_hat, a_var * _calib_scale(calib, a_var.shape[1]))
        return loss, {"calib_loss": loss}

    return loss_fn


def make_calib_train_step(cfg, g_fm, g_r2):
    """The σ-calibration stage's step: `calib_step(state, (A, te)) ->
    (state, metrics)` takes one plain SGD step at `lr` on
    `make_calib_loss_fn`'s loss, then projects `calib` to ≥ 0 (keras
    NonNeg's semantics). The state is updated in place and returned."""
    loss_fn = make_calib_loss_fn(cfg, g_fm, g_r2)

    def calib_step(state: UnsupState, batch):
        A, te = batch
        state.opt_calib.zero_grad()
        loss, metrics = loss_fn(state.calib, state.fm_offset, A, te)
        loss.backward()
        state.opt_calib.step()
        with torch.no_grad():
            state.calib.clamp_(min=0.0)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return calib_step


def eval_calibrated_nll(cfg, g_fm, g_r2):
    """The held-out heteroscedastic NLL at the state's calibration, as
    `nll(state, A, te) -> loss`: the calibration-quality metric of the CLI's
    report."""

    @torch.no_grad()
    def nll(state: UnsupState, A, te):
        _, _, a_hat, a_var = _uq_pipeline(cfg, g_fm, g_r2, state.fm_offset,
                                          A, te, state.calib, with_var=True)
        return _nll(A, a_hat, a_var)

    return nll


def init_state(cfg, g_fm, g_r2, tx, generator: torch.Generator,
               device="cuda", mesh=None) -> UnsupState:
    """Seeded random weights for both nets (`models.init_params`), moved to
    `device` (default the card; raises without one), with fresh optimizers
    from the recipe `tx`, `calib` ones and its SGD at `lr` (averaging over
    `mesh`'s ranks)."""
    dev = resolve_device(device)
    for net in (g_fm, g_r2):
        net.init_params(generator)
        net.to(dev)
    calib = torch.ones(cfg["n_echoes"], dtype=torch.float32, device=dev,
                       requires_grad=True)
    return UnsupState(g_fm, tx(g_fm.parameters()), g_r2,
                      tx(g_r2.parameters()), calib,
                      SGD([calib], cfg["lr"], mesh=mesh),
                      torch.zeros((), dtype=torch.float32, device=dev))
