"""Latent diffusion on the frozen PI-VAE latents (port of
`ideal_gan_tpu/train/ldm.py`, the rebuild of train-ldm.py and
gen_LDM_dataset.py).

Train: each batch is encoded by the frozen GAN encoder (its ConvLSTM front
runs the forward kernel, under `no_grad`), divided by the global latent std
z_std (`latent_std`, one pass), noised at a uniform timestep, and the
denoising U-Net takes one Adam step on the ε-prediction MSE, with optional
class conditioning. The rate is constant: the JAX step's
`linear_decay_schedule(lr, epochs, epochs)` never decays.

Sample: the reverse DDPM or DDIM chain (`diffusion`, a loop of denoiser
calls), times z_std, then (VQ) → the GAN decoders (`train.gan.decode_maps`)
→ `physics.synthesize_mag` at the default TE train: synthetic (echoes,
maps) pairs for `--DL_gen` training.

Random draws (t, ε, the samplers' noise) come from the caller's
`torch.Generator`, or are passed in (the tests pass JAX's draws).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .. import diffusion as dm
from .. import physics
from ..cli.common import resolve_device
from ..models import DenoiseUNet
from ..utils import Checkpoint
from . import gan
from .common import ModelState, linear_decay_schedule, make_adam

DEFAULTS = dict(
    experiment_dir="output/WF-IDEAL", n_timesteps=200, n_ldm_filters=64,
    batch_size=8, epochs=400, epoch_ckpt=20, lr=0.0001, beta_1=0.9,
    beta_2=0.999, scheduler="linear", class_cond=False, n_classes=4,
    in_res=16, dim_mults=(1, 2, 4), infer_steps=200, infer_sigma=0.0,
)


@dataclasses.dataclass
class LDMState(ModelState):
    """The denoiser, its optimizer, the step count and the latent std it
    was trained on; checkpointed as {"state": …, "z_std": float}, the JAX
    CLI's layout."""
    z_std: float = 1.0

    def state_dict(self) -> dict:
        return {"state": super().state_dict(), "z_std": float(self.z_std)}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state["state"])
        self.z_std = float(state["z_std"])


def build_model(cfg, channels: int) -> DenoiseUNet:
    return DenoiseUNet(dim=cfg["n_ldm_filters"],
                       dim_mults=tuple(cfg["dim_mults"]), channels=channels,
                       num_classes=cfg["n_classes"] if cfg["class_cond"]
                       else None, in_res=cfg["in_res"])


def build_schedule(cfg) -> dm.DiffusionSchedule:
    if cfg["scheduler"] == "cosine":
        return dm.cosine_beta_schedule(cfg["n_timesteps"])
    return dm.linear_beta_schedule(cfg["n_timesteps"])


def latent_std(encode_fn, batches) -> float:
    """The global latent std in one pass over `batches` (any iterable):
    Σz and Σz² summed in float64 on the latents' device, one host read at
    the end, Var = E[z²] − E[z]² (the reference's two-pass mean-then-
    variance, algebraically)."""
    s = ss = None
    count = 0
    for a in batches:
        z = encode_fn(a).double()
        s = z.sum() if s is None else s + z.sum()
        ss = z.square().sum() if ss is None else ss + z.square().sum()
        count += z.numel()
    mean = float(s) / count
    return float(np.sqrt(max(float(ss) / count - mean * mean, 0.0)))


def make_loss_fn(model, sched: dm.DiffusionSchedule):
    """loss_fn(z, labels, t, noise) → the ε-MSE of `model` on z noised at t
    (the schedule follows z to its device)."""
    tables = {sched.beta.device: sched}

    def loss_fn(z, labels, t, noise):
        if z.device not in tables:
            tables[z.device] = sched.to(z.device)
        z_noisy, noise = dm.forward_noise(z, t, tables[z.device], noise)
        eps_hat = model(z_noisy, t, labels)
        return torch.mean(torch.square(noise - eps_hat))

    return loss_fn


def make_train_step(cfg, model: DenoiseUNet, sched: dm.DiffusionSchedule,
                    generator: torch.Generator | None = None):
    """(train_step, tx). `train_step(state, (z, labels), t=None, noise=None)
    -> (state, metrics)`: z the normalized latents (nb, h, w, C), t (nb,)
    and noise the shape of z, drawn from `generator` (on z's device; seeded
    0 on first use where None) when not given, in that order. One Adam step
    of the ε-MSE; the metrics ("loss", "G_loss") are detached."""
    tx = make_adam(linear_decay_schedule(cfg["lr"], cfg["epochs"],
                                         cfg["epochs"]),
                   cfg["beta_1"], cfg["beta_2"])

    loss_fn = make_loss_fn(model, sched)

    def train_step(state: ModelState, batch, t=None, noise=None):
        nonlocal generator
        z, labels = batch
        if generator is None:
            generator = torch.Generator(device=z.device).manual_seed(0)
        if t is None:
            t = dm.sample_timesteps(z.shape[0], sched.timesteps, generator,
                                    z.device)
        if noise is None:
            noise = torch.randn(z.shape, generator=generator, device=z.device)
        state.opt.zero_grad()
        loss = loss_fn(z, labels, t, noise)
        loss.backward()
        state.opt.step()
        state.step += 1
        loss = loss.detach()
        return state, {"loss": loss, "G_loss": loss}

    return train_step, tx


def init_state(cfg, model: DenoiseUNet, tx, generator: torch.Generator,
               device="cuda", z_std: float = 1.0) -> LDMState:
    """Seeded random weights (`DenoiseUNet.init_params`) on `device`
    (default the card; raises without one) and a fresh optimizer."""
    model.init_params(generator)
    model.to(resolve_device(device))
    return LDMState(model, tx(list(model.parameters())), z_std=z_std)


@torch.no_grad()
def sample_latents(cfg, model: DenoiseUNet, sched: dm.DiffusionSchedule,
                   n: int, latent_hw, channels: int, z_std: float,
                   labels=None, method: str = "ddpm",
                   generator: torch.Generator | None = None,
                   x_init=None, zs=None) -> torch.Tensor:
    """The reverse chain (`method` "ddpm", or "ddim" with `infer_steps` and
    `infer_sigma`) of n latents (n, h, w, channels) on the model's device,
    times z_std. `x_init` and `zs` are the chain's noise, drawn from
    `generator` when not given."""
    dev = next(model.parameters()).device
    sched = sched.to(dev)
    if labels is None:
        labels = torch.zeros((n,), dtype=torch.long, device=dev)

    def denoise_fn(x, t):
        return model(x, t, labels)

    shape = (n, latent_hw[0], latent_hw[1], channels)
    if method == "ddim":
        z = dm.ddim_sample(denoise_fn, shape, sched, cfg["infer_steps"],
                           cfg["infer_sigma"], generator, x_init, zs, dev)
    else:
        z = dm.ddpm_sample(denoise_fn, shape, sched, generator, x_init, zs,
                           dev)
    return z * z_std


@torch.no_grad()
def generate_dataset(cfg, gan_cfg, models: gan.GANModels, ldm_model,
                     sched, n_samples: int, latent_hw, z_std: float,
                     ne: int = 6, method: str = "ddpm",
                     generator: torch.Generator | None = None,
                     x_init=None, zs=None):
    """Sampled latents → (VQ, with `VQ_encoder`) → the GAN decoders →
    `physics.synthesize_mag` at `te_train(ne)`: (acqs (n, ne, H, W, 2),
    maps (n, 3, H, W, 2)), float32 on the model's device."""
    z = sample_latents(cfg, ldm_model, sched, n_samples, latent_hw,
                       gan_cfg["encoded_size"], z_std, method=method,
                       generator=generator, x_init=x_init, zs=zs)
    if gan_cfg["VQ_encoder"]:
        z, _, _ = models.vq(z)
    maps = gan.decode_maps(models, z)
    te = physics.te_train(ne, bs=n_samples, device=maps.device)
    return physics.synthesize_mag(maps, te), maps


def load_gan(gan_cfg, experiment_dir, device,
             generator: torch.Generator | None = None) -> gan.GANModels:
    """The GAN run's encoder, decoders and VQ on `device`, frozen, in eval
    mode, restored from `<experiment_dir>/checkpoints` (its newest
    checkpoint; "restored PI-VAE checkpoint") or else seeded random
    (`generator`, seed 0 by default), as the JAX CLIs start from the GAN's
    init and restore over it. The discriminator is built but neither
    initialized nor moved; no VGG and no optimizer are built."""
    models = gan.build_models(gan_cfg)
    ckpt = Checkpoint(Path(experiment_dir) / "checkpoints")
    nets = [getattr(models, name) for name in gan.G_NETS]
    if ckpt.latest_step():
        state = ckpt.restore()
        for name, m in zip(gan.G_NETS, nets):
            m.load_state_dict(state["models"][name])
        print("restored PI-VAE checkpoint")
    else:
        gen = generator or torch.Generator().manual_seed(0)
        for m in nets:
            m.init_params(gen)
    for m in nets:
        m.to(device).eval().requires_grad_(False)
    return models


def make_encode(models: gan.GANModels, vq_encoder: bool):
    """encode(A) → the frozen encoder's latent (nb, h, w, D) in float32
    under `no_grad`: the posterior's `loc`, or the plain output in VQ
    mode."""
    @torch.no_grad()
    def encode(a: torch.Tensor) -> torch.Tensor:
        out = models.enc(a)
        return (out if vq_encoder else out.loc).float()

    return encode


def restore_ldm(cfg, experiment_dir, channels: int, device,
                generator: torch.Generator) -> LDMState:
    """The LDM of `<experiment_dir>/checkpoints_ldm` (its newest checkpoint,
    with z_std) at `cfg`'s shape, or seeded random weights with z_std 1
    where there is none."""
    model = build_model(cfg, channels)
    _, tx = make_train_step(cfg, model, build_schedule(cfg))
    state = init_state(cfg, model, tx, generator, device)
    ckpt = Checkpoint(Path(experiment_dir) / "checkpoints_ldm")
    if ckpt.latest_step():
        state.load_state_dict(ckpt.restore())
    return state
