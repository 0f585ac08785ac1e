"""PI-VAE generative training with the WGAN adversary (port of
`ideal_gan_tpu/train/gan.py`, the rebuild of train-IDEAL-GAN.py).

Encoder (its ConvLSTM front runs the ConvLSTM kernels) → latent (a Gaussian
posterior, sampled, with its KL term; or the vector quantizer) → split in
three → the FF, magnitude and phase decoders → mag/phase map rows →
`physics.synthesize_mag` (plain torch) → the echoes again. The G loss: the
VGG-perceptual (or pixel) cycle on the echoes, the map cycle (the phase
rows weighted by FM_loss_weight), the KL or VQ term, the optional latent
covariance whitening and Fourier cycle, and with `adv_train` the WGAN
generator term; the D loss: the WGAN critic terms with the R1 penalty, on
echoes from the replay pool.

The discriminator's spectral-norm statistics (`models.discriminator`) are
used as the JAX steps use them: the g-step calls it without updating them,
from the state's; in the d-step the real pass updates them, the fake pass
starts from the updated ones and updates them again, and the R1 critic
starts from those before the step and writes nothing.

The g-step takes the latent noise ε (the shape of the posterior) as an
argument, drawn from the step's generator when it is not given; in VQ mode
it takes none. With `bf16` the encoder and the decoders compute in
bfloat16 (the ConvLSTM front in the kernels' bf16 storage mode) while
their parameters stay float32; the posterior, the VQ, the discriminator,
the VGG and the synthesis run in float32, as in the JAX package.

On a data mesh (`mesh=`) each rank's steps take its rows of the global
batch: ε is drawn for the global batch and the rank keeps its rows, the
latent covariance is the global batch's (`parallel.mesh.all_gather_rows`,
differentiable), the VQ perplexity averages the code frequencies over the
ranks, and the optimizers average the gradients. The spectral-norm power
iterations and R1 run per rank on identical weights.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import physics
from ..cli.common import resolve_device
from ..eval.metrics import (covariance_map, echoes_to_vgg_input, init_vgg19,
                            perceptual_cosine_loss)
from ..losses import adversarial_losses, r1_regularization
from ..models import (Decoder, Encoder, PatchGAN, VectorQuantizer,
                      fourier_layer)
from ..parallel.mesh import all_gather_rows, draw_rows
from ..prob import Normal
from .common import Adam, compute_dtype, linear_decay_schedule, make_adam

DEFAULTS = dict(
    dataset="WF-IDEAL", data_size=192, rand_ne=False, rand_ph_offset=False,
    unwrap=True, n_G_filters=36, n_G_filt_list="", n_downsamplings=4,
    n_res_blocks=2,
    # the reference's default 256 is not divisible by 3 (its own
    # tf.split(z, 3) fails); the JAX package defaults to 258 = 3·86
    encoded_size=258, VQ_encoder=False, VQ_num_embed=64, VQ_commit_cost=0.5,
    adv_train=False, cGAN=False, n_D_filters=72, batch_size=1, epochs=100,
    epoch_decay=100, epoch_ckpt=20, lr=0.0002, D_lr_factor=1, beta_1=0.5,
    beta_2=0.9, critic_train_steps=1, R1_reg_weight=0.2, main_loss="MSE",
    A_loss="VGG", A_loss_weight=0.01, B_loss_weight=0.1, FM_loss_weight=1.0,
    ls_reg_weight=1e-7, cov_reg_weight=0.0, Fourier_reg_weight=0.0,
    NL_SelfAttention=True, pool_size=50, bf16=False,
)


class GANModels(NamedTuple):
    enc: Encoder
    dec_ff: Decoder
    dec_mag: Decoder
    dec_pha: Decoder
    disc: PatchGAN
    vq: VectorQuantizer


G_NETS = ("enc", "dec_ff", "dec_mag", "dec_pha", "vq")


@dataclasses.dataclass
class GANState:
    """The trainer's state: the models, the generator's optimizer (over the
    encoder, the decoders and the codebook), the discriminator's and the
    g-step count."""
    models: GANModels
    opt_g: Adam
    opt_d: Adam
    step: int = 0

    def state_dict(self) -> dict:
        """CPU tensors and ints (the discriminator's u and σ included), for
        `utils.Checkpoint`."""
        return {"models": {name: {k: v.detach().cpu()
                                  for k, v in m.state_dict().items()}
                           for name, m in self.models._asdict().items()},
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        for name, m in self.models._asdict().items():
            m.load_state_dict(state["models"][name])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.step = int(state["step"])


def g_parameters(models: GANModels) -> list:
    return [p for name in G_NETS
            for p in getattr(models, name).parameters()]


def parse_filt_list(cfg):
    """--n_G_filt_list: comma-separated per-level encoder widths; the
    decoders' are the list divided by 3 (magnitude, phase) and by 4 (FF).
    Returns (nfe, nfd, nfd2), each an int or a per-level tuple."""
    nd = 3
    raw = cfg.get("n_G_filt_list", "")
    if isinstance(raw, str) and raw:
        filt_list = [int(a) for a in raw.split(",")]
    elif isinstance(raw, (list, tuple)) and raw:
        filt_list = [int(a) for a in raw]
    else:
        filt_list = []
    if len(filt_list) == cfg["n_downsamplings"] + 1:
        return (tuple(filt_list),
                tuple(a // nd for a in filt_list),
                tuple(a // (nd + 1) for a in filt_list))
    if filt_list:
        raise ValueError(
            f"--n_G_filt_list needs n_downsamplings+1="
            f"{cfg['n_downsamplings'] + 1} entries, got {len(filt_list)}")
    return (cfg["n_G_filters"], cfg["n_G_filters"] // nd,
            cfg["n_G_filters"] // (nd + 1))


def build_models(cfg, in_channels: int = 2) -> GANModels:
    """The encoder and decoders in the config's compute dtype (`bf16`); the
    PatchGAN (multi-echo, cGAN per the config) and the VQ in float32."""
    if cfg["encoded_size"] % 3 != 0:
        raise ValueError(
            f"encoded_size must be divisible by 3 (the latent splits into "
            f"ff/mag/pha decoder thirds), got {cfg['encoded_size']}; use "
            f"e.g. {cfg['encoded_size'] + (3 - cfg['encoded_size'] % 3)}.")
    nfe, nfd, nfd2 = parse_filt_list(cfg)
    dtype = compute_dtype(cfg)
    d3 = cfg["encoded_size"] // 3
    enc = Encoder(in_channels, cfg["encoded_size"], filters=nfe,
                  num_layers=cfg["n_downsamplings"],
                  num_res_blocks=cfg["n_res_blocks"],
                  sd_out=not cfg["VQ_encoder"],
                  nl_self_attention=cfg["NL_SelfAttention"], dtype=dtype)
    common = dict(num_layers=cfg["n_downsamplings"],
                  num_res_blocks=cfg["n_res_blocks"],
                  nl_self_attention=cfg["NL_SelfAttention"], dtype=dtype)
    dec_ff = Decoder(d3, 1, filters=nfd2, output_activation="sigmoid",
                     **common)
    dec_mag = Decoder(d3, 2, filters=nfd, output_activation="relu", **common)
    dec_pha = Decoder(d3, 2, filters=nfd, output_activation="none", **common)
    disc = PatchGAN(in_channels, dim=cfg["n_D_filters"], cgan=cfg["cGAN"],
                    multi_echo=True, self_attention=cfg["NL_SelfAttention"])
    vq = VectorQuantizer(cfg["encoded_size"], cfg["VQ_num_embed"],
                         cfg["VQ_commit_cost"])
    return GANModels(enc, dec_ff, dec_mag, dec_pha, disc, vq)


def _cgan_pair(a_even_src, a_odd_src):
    """cGAN echo pairing: the even echoes of the reference condition the
    odd echoes under judgment (one fewer where the count is odd)."""
    a_ref = a_even_src[:, 0::2]
    a_x = a_odd_src[:, 1::2]
    if a_x.shape[1] < a_ref.shape[1]:
        a_ref = a_ref[:, :-1]
    return a_ref, a_x


def _point_loss(name):
    if name == "MSE":
        return lambda a, b: torch.mean(torch.square(a - b))
    if name == "MAE":
        return lambda a, b: torch.mean(torch.abs(a - b))
    if name == "MSLE":
        return lambda a, b: torch.mean(torch.square(
            torch.log1p(torch.clamp(a, min=0))
            - torch.log1p(torch.clamp(b, min=0))))
    raise NameError(f"Unrecognized Main Loss Function {name!r}")


def decode_maps(models: GANModels, z: torch.Tensor) -> torch.Tensor:
    """Latent (nb, h, w, D) → the map rows [(FF, 0), (PD, R2*), (phase, φ)]
    (nb, 3, H, W, 2) in float32."""
    z_ff, z_mag, z_pha = torch.chunk(z, 3, dim=-1)
    b_ff = models.dec_ff(z_ff).float()
    b_mag = models.dec_mag(z_mag).float()
    b_pha = models.dec_pha(z_pha).float()
    b_ff = torch.cat([b_ff, torch.zeros_like(b_ff)], dim=-1)
    return torch.cat([b_ff, b_mag, b_pha], dim=1)


def make_g_loss_fn(cfg, models: GANModels, vgg=None,
                   generator: torch.Generator | None = None, mesh=None):
    """The G loss as `g_loss(A, B, te, eps=None) -> (loss, metrics,
    a2b2a)`: A the echoes (nb, ne, H, W, 2), B the mag/phase map rows (nb,
    3, H, W, 2), te (nb, ne, 1), eps the posterior's noise (nb, h, w, D),
    drawn from `generator` (on A's device; seeded 0 on first use where
    None) when not given. The discriminator is called without updating its
    statistics; its parameters take part, so the caller freezes them. On a
    `mesh` A is the rank's rows and eps its rows of the global draw."""
    cycle_loss = _point_loss(cfg["main_loss"])
    _, g_adv_fn = adversarial_losses("wgan")

    def g_loss(A, B, te, eps=None):
        nonlocal generator
        zero = A.new_zeros(())
        out = models.enc(A)
        vq_loss = kl = perplexity = zero
        if cfg["VQ_encoder"]:
            z, vq_loss, perplexity = models.vq(out.float(), mesh)
        else:
            post = Normal(loc=out.loc.float(), scale=out.scale.float())
            if eps is None:
                if generator is None:
                    generator = torch.Generator(device=A.device).manual_seed(0)
                eps = draw_rows(
                    lambda k: torch.randn((k,) + post.loc.shape[1:],
                                          generator=generator,
                                          device=A.device),
                    post.loc.shape[0], mesh)
            z = post.loc + post.scale * eps
            kl = torch.mean(post.kl_to_std_normal())
        a2b = decode_maps(models, z)
        a2b2a = physics.synthesize_mag(a2b, te)

        if cfg["adv_train"]:
            if cfg["cGAN"]:
                a_ref, a_g = _cgan_pair(A, a2b2a)
                logits = models.disc(a_g, a_ref, update_stats=False)
            else:
                logits = models.disc(a2b2a, update_stats=False)
            g_adv = g_adv_fn(logits)
        else:
            g_adv = zero

        if cfg["A_loss"] == "VGG":
            vgg.to(A.device)
            with torch.no_grad():
                fa = vgg(echoes_to_vgg_input(A))
            fb = vgg(echoes_to_vgg_input(a2b2a))
            a_cycle = perceptual_cosine_loss(fa, fb)
        else:
            a_cycle = cycle_loss(A, a2b2a)

        b_cycle = (cycle_loss(B[:, :2], a2b[:, :2])
                   + cycle_loss(B[:, 2:], a2b[:, 2:]) * cfg["FM_loss_weight"])
        if cfg["Fourier_reg_weight"] > 0.0:
            f_cycle = torch.mean(torch.square(
                torch.log1p(torch.abs(fourier_layer(A)))
                - torch.log1p(torch.abs(fourier_layer(a2b2a)))))
        else:
            f_cycle = zero
        # the D×D covariance only where its weight asks for it (the
        # reference builds it always)
        if cfg["cov_reg_weight"] > 0.0:
            z_cov = covariance_map(all_gather_rows(z, mesh))
            eye = torch.eye(z_cov.shape[-1], device=z.device)
            cov_loss = torch.mean(torch.square(z_cov - eye))
        else:
            cov_loss = zero

        loss = (cfg["A_loss_weight"] * a_cycle
                + cfg["B_loss_weight"] * b_cycle + g_adv
                + kl * cfg["ls_reg_weight"] + vq_loss * cfg["ls_reg_weight"]
                + cov_loss * cfg["cov_reg_weight"]
                + f_cycle * cfg["Fourier_reg_weight"])
        metrics = {"A2B2A_g_loss": g_adv, "A2B2A_cycle_loss": a_cycle,
                   "B2A2B_cycle_loss": b_cycle, "A2B2A_f_cycle_loss": f_cycle,
                   "LS_reg": kl, "Cov_reg": cov_loss, "VQ_loss": vq_loss,
                   "VQ_perplexity": perplexity, "G_loss": loss}
        return loss, metrics, a2b2a

    return g_loss


def make_d_loss_fn(cfg, disc: PatchGAN):
    """The D loss as `d_loss(A, fake) -> (loss, metrics)`: the WGAN critic
    terms on the real and the (pooled) generated echoes, each pass updating
    the spectral-norm statistics in turn, plus R1_reg_weight × the R1
    penalty on the real echoes, whose critic starts from the statistics of
    before the call and writes none."""
    d_loss_fn, _ = adversarial_losses("wgan")

    def d_loss(A, fake):
        before = disc.stats()
        if cfg["cGAN"]:
            a_ref, a_r = _cgan_pair(A, A)
            _, a_f = _cgan_pair(A, fake)
            real_logits = disc(a_r, a_ref, update_stats=True)
            fake_logits = disc(a_f, a_ref, update_stats=True)

            def critic(x):
                return disc(x, a_ref, update_stats=False, stats=before)

            r1_input = a_r
        else:
            real_logits = disc(A, update_stats=True)
            fake_logits = disc(fake, update_stats=True)

            def critic(x):
                return disc(x, update_stats=False, stats=before)

            r1_input = A
        a_d_loss, f_d_loss = d_loss_fn(real_logits, fake_logits)
        r1 = r1_regularization(critic, r1_input)
        loss = a_d_loss + f_d_loss + r1 * cfg["R1_reg_weight"]
        return loss, {"D_loss": a_d_loss + f_d_loss, "A_d_loss": a_d_loss,
                      "A2B2A_d_loss": f_d_loss, "D_A_r1": r1}

    return d_loss


def make_train_steps(cfg, models: GANModels, vgg=None,
                     generator: torch.Generator | None = None, mesh=None):
    """(g_step, d_step, (tx_g, tx_d)).

    `g_step(state, (A, B, te), eps=None) -> (state, metrics, a2b2a)` takes
    one Adam step of the encoder, the decoders and the codebook (the
    discriminator frozen); `d_step(state, A, fake) -> (state, metrics)` one
    of the discriminator. The learning rates decay linearly after
    `epoch_decay`'s share of `total_steps` (default `epochs`) g-steps, and
    of that many times `critic_train_steps` d-steps. With A_loss "VGG" and
    no `vgg`, the VGG19 of `eval.metrics.init_vgg19`. The state is updated
    in place and returned; the metrics are detached tensors. On a `mesh`
    the batches are the rank's rows and the optimizers average the
    gradients over its ranks."""
    if cfg["A_loss"] == "VGG" and vgg is None:
        vgg = init_vgg19()
    g_loss = make_g_loss_fn(cfg, models, vgg, generator, mesh)
    d_loss = make_d_loss_fn(cfg, models.disc)
    total_steps = cfg.get("total_steps", cfg["epochs"])
    epochs = max(cfg["epochs"], 1)
    tx_g = make_adam(linear_decay_schedule(
        cfg["lr"], total_steps, int(cfg["epoch_decay"] * total_steps
                                    / epochs)), cfg["beta_1"], cfg["beta_2"],
        mesh=mesh)
    d_total = total_steps * cfg["critic_train_steps"]
    tx_d = make_adam(linear_decay_schedule(
        cfg["lr"] * cfg["D_lr_factor"], d_total,
        int(cfg["epoch_decay"] * d_total / epochs)),
        cfg["beta_1"], cfg["beta_2"], mesh=mesh)

    def g_step(state: GANState, batch, eps=None):
        A, B, te = batch
        state.opt_g.zero_grad()
        disc = state.models.disc
        disc.requires_grad_(False)
        try:
            loss, metrics, a2b2a = g_loss(A, B, te, eps)
            loss.backward()
        finally:
            disc.requires_grad_(True)
        state.opt_g.step()
        state.step += 1
        return (state, {k: v.detach() for k, v in metrics.items()},
                a2b2a.detach())

    def d_step(state: GANState, A, fake):
        state.opt_d.zero_grad()
        loss, metrics = d_loss(A, fake)
        loss.backward()
        state.opt_d.step()
        return state, {k: v.detach() for k, v in metrics.items()}

    return g_step, d_step, (tx_g, tx_d)


def init_state(cfg, models: GANModels, txs, generator: torch.Generator,
               device="cuda") -> GANState:
    """Seeded random weights for every model (the discriminator's u ~ N(0, 1)
    and σ = 1 too) on `device` (default the card; raises without one) and
    fresh optimizers from the recipes `txs`."""
    dev = resolve_device(device)
    tx_g, tx_d = txs
    for m in models:
        m.init_params(generator)
        m.to(dev)
    return GANState(models, tx_g(g_parameters(models)),
                    tx_d(list(models.disc.parameters())))
