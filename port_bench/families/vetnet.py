"""VET-Net (jpmeneses/IDEAL-GAN `train-IDEAL-TEaug.py`,
`PM_Generator(te_input=True)`): a ConvLSTM over the echoes, a shared
encoder conditioned on the TE train by AdaIN, and two decoders (R2*, and
the field map with self-attention).

Serving: the program's `make_infer_run` VET-Net closure (the net on the
echoes and the TE vector, then the plain phase-constrained fit) carrying
the harness's weights. Training: the program's generator step
(`train.teaug.make_train_step`, its acquisitions synthesized by the
synthesis kernel at a sampled TE train plus noise), fed as
`cli/train_teaug.py`'s loop body feeds it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import nets as ref_nets
from ..reference import physics as ref_physics
from ..reference import train as ref_train
from . import closure_modules, load_weights

NETS = ("model",)


def reference_nets(cfg) -> dict:
    return {"model": ref_nets.VETNet(2, cfg["n_G_filters"],
                                     r2_attention=cfg["R2_SelfAttention"],
                                     fm_attention=cfg["FM_SelfAttention"])}


def _program_cfg(cfg, bf16=False) -> dict:
    from ideal_gan_tpu_torch.train import teaug
    keys = ("n_echoes", "field", "G_model", "out_vars", "n_G_filters",
            "batch_size", "lr", "beta_1", "beta_2", "noise_std",
            "data_aug_p", "te_input", "R2_SelfAttention", "FM_SelfAttention")
    out = dict(teaug.DEFAULTS, **{k: cfg[k] for k in keys}, bf16=bf16)
    out["total_steps"] = out["epochs"] * (cfg["cohort_slices"]
                                          // cfg["batch_size"])
    return out


# ---- serving -------------------------------------------------------------

def serve_program(cfg, weights, dev):
    """`make_infer_run`'s VET-Net closure on `dev`, its net carrying
    `weights`."""
    from ideal_gan_tpu_torch.cli.roi_analysis import make_infer_run
    run = make_infer_run({"model_sel": "VET-Net", "map": "PDFF",
                          "field": cfg["field"], "rem_R2": False,
                          "experiment_dir": "", "weights": "", "seed": 0},
                         None, dev, [dev])
    load_weights(closure_modules(run)["model"], weights["model"])
    return run


def serve_control(cfg, weights, dev):
    """The control: the closure's `vetnet_maps` on the program's bfloat16
    net (its `bf16` compute dtype)."""
    from ideal_gan_tpu_torch.cli.roi_analysis import vetnet_maps
    from ideal_gan_tpu_torch.train import teaug
    model = teaug.build_model(_program_cfg(cfg, bf16=True))
    load_weights(model, weights["model"])
    model = model.to(dev).eval()
    field = cfg["field"]

    @torch.inference_mode()
    def run(a, te_b):
        return vetnet_maps(model, a, te_b, field)

    return run


def reference_fit(cfg, a, pm, te):
    """The map fit the closure makes (the phase-constrained one)."""
    return ref_physics.fit_rho(a, pm, te, cfg["field"], phase_constraint=True)


@torch.no_grad()
def reference_chunk(cfg, nets, a, te):
    pm = nets["model"](a, te[..., 0])
    return torch.cat([reference_fit(cfg, a, pm, te), pm], dim=1)


def serve_calls(cfg, nb):
    h = cfg["data_size"]
    return [(nb, h, h, 2, cfg["n_G_filters"], cfg["n_echoes"], False)], []


# ---- training ------------------------------------------------------------

class Trainer:
    """The program's state (VET-Net and its Adam) carrying `weights`, its
    generator step with its noise generator, and the loop body's feed."""

    def __init__(self, cfg, weights, dev, bf16=False, noise_seed=0):
        from ideal_gan_tpu_torch.parallel import data_mesh_for_batch
        from ideal_gan_tpu_torch.train import teaug
        tcfg = _program_cfg(cfg, bf16)
        self.cfg, self.dev = tcfg, dev
        self.mesh = data_mesh_for_batch(tcfg["batch_size"], device=dev)
        model = teaug.build_model(tcfg)
        self.step_fn, tx = teaug.make_train_step(tcfg, model, None,
                                                 self.mesh)
        self.state = teaug.init_state(tcfg, model, tx,
                                      torch.Generator().manual_seed(0), dev)
        load_weights(model, weights["model"])
        self.noise_gen = torch.Generator(device=dev).manual_seed(noise_seed)
        self.nets = {"model": model}
        self.opts = {"model": self.state.opt}

    def prepare(self, rows, rng, gen):
        """`cli/train_teaug.py`'s loop body before the copy: the host
        augmentation and the sampled TE train."""
        from ideal_gan_tpu_torch.data import random_geometric
        from ideal_gan_tpu_torch.train import teaug
        (B,) = rows
        B = torch.from_numpy(B)
        if rng.random() <= self.cfg["data_aug_p"]:
            B = random_geometric(gen, B)
        return B.contiguous(), teaug.sample_te(gen, self.cfg, len(B))

    def place(self, batch):
        """The loop body's host-to-card copy."""
        from ideal_gan_tpu_torch.parallel import shard_batch
        return shard_batch(batch, self.mesh)

    def step(self, batch):
        self.state, m = self.step_fn(self.state, batch, self.noise_gen)
        return [m["G_loss"]]


def cohort(cfg, maps, acqs, te):
    return (maps,)


def te_sampler(cfg):
    return dict(cfg["te_sampler"], ne=cfg["n_echoes"])


def reference_steps(cfg, nets, batches, dev, noise_seed, on_step=None):
    """The reference's steps on the replayed `batches`: each step's
    losses, the first gradient as the update received it ({leaf: tensor})
    and the net's output in the first step; `on_step(i)` after step i."""
    net = nets["model"]
    params = [(k, p) for k, p in net.named_parameters() if p.requires_grad]
    opt = ref_train.Adam([p for _, p in params], cfg["lr"], cfg["beta_1"],
                         cfg["beta_2"])
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
    losses, first, outputs = [], None, None
    for i, (B, te) in enumerate(batches):
        B = torch.from_numpy(np.ascontiguousarray(B)).to(dev)
        te = torch.from_numpy(te).to(dev)
        noise = torch.randn((B.shape[0], te.shape[1], *B.shape[2:]),
                            generator=gen, device=dev)
        loss, out = ref_train.vetnet_loss(net, B, te, noise,
                                          cfg["noise_std"], cfg["field"])
        loss.backward()
        g = opt.step()
        losses.append([loss.item()])
        if first is None:
            first = {f"model.{k}": v for (k, _), v in zip(params, g)}
            outputs = {"model": out.detach()}
        if on_step is not None:
            on_step(i)
    return losses, first, outputs


def reference_grad(cfg, nets, batch, dev, noise_seed, dtype=torch.float32):
    """The first step's gradient {leaf: tensor} of the replayed `batch`
    with its noise, in `dtype` (the net's own), slice by slice (the loss
    is the mean of the slices' means; a slice at a time holds a float64
    net's activations)."""
    net = nets["model"]
    B, te = batch
    B = torch.from_numpy(np.ascontiguousarray(B)).to(dev, dtype)
    te = torch.from_numpy(te).to(dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(noise_seed)
    noise = torch.randn((B.shape[0], te.shape[1], *B.shape[2:]),
                        generator=gen, device=dev).to(dtype)
    for b in range(len(B)):
        loss, _ = ref_train.vetnet_loss(net, B[b:b + 1], te[b:b + 1],
                                        noise[b:b + 1], cfg["noise_std"],
                                        cfg["field"])
        (loss / len(B)).backward()
    return {f"model.{k}": p.grad.detach()
            for k, p in net.named_parameters() if p.requires_grad}


def train_calls(cfg):
    nb, h, ne = cfg["batch_size"], cfg["data_size"], cfg["n_echoes"]
    return ([(nb, h, h, 2, cfg["n_G_filters"], ne, True)],
            [("synth", nb, h, h, ne), ("fit", nb, h, h, ne)])


def count_unit(cfg, nets, dev, train: bool):
    nb = cfg["batch_size"] if train else cfg["infer_batch"]
    h, ne = cfg["data_size"], cfg["n_echoes"]
    A = torch.zeros((nb, ne, h, h, 2), device=dev)
    te = torch.zeros((nb, ne), device=dev)
    with torch.set_grad_enabled(train):
        out = nets["model"](A, te)
    if train:
        out.sum().backward()
