"""AI-DEAL (jpmeneses/IDEAL-GAN `train-IDEAL-unsup.py`): the field-map
U-Net on the complex echoes (tanh head, self-attention at the first
decoder level) and the R2* U-Net on their magnitudes (sigmoid head), both
behind a ConvLSTM over the echoes.

Serving: the program's `make_infer_run` AI-DEAL closure (the nets, then
the map fit kernel) carrying the harness's weights. Training: the
program's PM step pair, the FM step (`train.unsup.make_train_step`) then
the R2 step (`make_r2_train_step`) on the same batch, fed as
`cli/train_unsup.py`'s loop body feeds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import nets as ref_nets
from ..reference import physics as ref_physics
from ..reference import train as ref_train
from . import closure_modules, load_weights, magnitude

NETS = ("g_fm", "g_r2")


def reference_nets(cfg) -> dict:
    f = cfg["n_G_filters"]
    return {"g_fm": ref_nets.UNet(2, f, activation="tanh",
                                  attention=cfg["D1_SelfAttention"]),
            "g_r2": ref_nets.UNet(1, f, activation="sigmoid",
                                  attention=cfg["D2_SelfAttention"])}


def _program_cfg(cfg, bf16=False) -> dict:
    from ideal_gan_tpu_torch.train import unsup
    keys = ("n_echoes", "field", "out_vars", "n_G_filters", "batch_size",
            "lr", "beta_1", "beta_2", "grad_clip", "data_aug_p",
            "D1_SelfAttention", "D2_SelfAttention")
    out = dict(unsup.DEFAULTS, **{k: cfg[k] for k in keys}, bf16=bf16)
    out["total_steps"] = out["epochs"] * (cfg["cohort_slices"]
                                          // cfg["batch_size"])
    return out


# ---- serving -------------------------------------------------------------

def serve_program(cfg, weights, dev):
    """`make_infer_run`'s AI-DEAL closure on `dev` (`--map PDFF`), its
    nets carrying `weights`."""
    from ideal_gan_tpu_torch.cli.roi_analysis import make_infer_run
    run = make_infer_run({"model_sel": "AI-DEAL", "map": "PDFF",
                          "field": cfg["field"], "rem_R2": False,
                          "experiment_dir": "", "weights": "", "seed": 0},
                         None, dev, [dev])
    mods = closure_modules(run)
    for net in NETS:
        load_weights(mods[net], weights[net])
    return run


def serve_control(cfg, weights, dev):
    """The control: the closure's arithmetic on the program's bfloat16
    nets (its `bf16` compute dtype, the ConvLSTM's bf16 storage mode), the
    heads upcast to float32 before the fit kernel, as the trainers upcast
    them."""
    from ideal_gan_tpu_torch.ops import fit_rho_fused
    from ideal_gan_tpu_torch.train import unsup
    g_fm, g_r2 = unsup.build_models(_program_cfg(cfg, bf16=True))
    load_weights(g_fm, weights["g_fm"])
    load_weights(g_r2, weights["g_r2"])
    g_fm, g_r2 = g_fm.to(dev).eval(), g_r2.to(dev).eval()
    field = cfg["field"]

    @torch.inference_mode()
    def run(a, te_b):
        pm = torch.cat([g_fm(a).float(), g_r2(magnitude(a)).float()], -1)
        rho = fit_rho_fused(a, pm, te_b, field=field)
        return torch.cat([rho, pm], dim=1), torch.zeros_like(pm)

    return run


def reference_fit(cfg, a, pm, te):
    """The map fit the closure makes (the fit kernel's)."""
    return ref_physics.fit_rho(a, pm, te, cfg["field"])


@torch.no_grad()
def reference_chunk(cfg, nets, a, te):
    pm = torch.cat([nets["g_fm"](a), nets["g_r2"](magnitude(a))], dim=-1)
    return torch.cat([reference_fit(cfg, a, pm, te), pm], dim=1)


def serve_calls(cfg, nb):
    """(ConvLSTM calls, per-voxel kernel calls) of one chunk."""
    h = w = cfg["data_size"]
    ne, f = cfg["n_echoes"], cfg["n_G_filters"]
    return ([(nb, h, w, 2, f, ne, False), (nb, h, w, 1, f, ne, False)],
            [("fit", nb, h, w, ne)])


# ---- training ------------------------------------------------------------

class Trainer:
    """The program's state (both nets, their Adams) carrying `weights`,
    its step pair and the loop body's feed."""

    def __init__(self, cfg, weights, dev, bf16=False, noise_seed=0):
        from ideal_gan_tpu_torch.parallel import data_mesh_for_batch
        from ideal_gan_tpu_torch.train import unsup
        ucfg = _program_cfg(cfg, bf16)
        self.cfg, self.dev = ucfg, dev
        self.mesh = data_mesh_for_batch(ucfg["batch_size"], device=dev)
        g_fm, g_r2 = unsup.build_models(ucfg)
        self.fm_step, tx = unsup.make_train_step(ucfg, g_fm, g_r2, self.mesh)
        self.r2_step = unsup.make_r2_train_step(ucfg, g_fm, g_r2, tx,
                                                self.mesh)
        self.state = unsup.init_state(ucfg, g_fm, g_r2, tx,
                                      torch.Generator().manual_seed(0), dev,
                                      self.mesh)
        load_weights(g_fm, weights["g_fm"])
        load_weights(g_r2, weights["g_r2"])
        self.nets = {"g_fm": g_fm, "g_r2": g_r2}
        self.opts = {"g_fm": self.state.opt_fm, "g_r2": self.state.opt_r2}

    def prepare(self, rows, rng, gen):
        """`cli/train_unsup.py`'s loop body before the copy: the host
        augmentation."""
        from ideal_gan_tpu_torch.data import random_geometric
        A, te_b = rows
        A = torch.from_numpy(A)
        if rng.random() <= self.cfg["data_aug_p"]:
            A = random_geometric(gen, A)
        return A.contiguous(), np.ascontiguousarray(te_b)

    def place(self, batch):
        """The loop body's host-to-card copy."""
        from ideal_gan_tpu_torch.parallel import shard_batch
        return shard_batch(batch, self.mesh)

    def step(self, batch):
        """One FM step and one R2 step on `batch`; their losses."""
        self.state, m = self.fm_step(self.state, batch)
        self.state, m2 = self.r2_step(self.state, batch)
        return [m["G_loss"], m2["R2_cycle_loss"]]


def cohort(cfg, maps, acqs, te):
    """The arrays the feed batches over."""
    return (acqs, te)


def reference_steps(cfg, nets, batches, dev, noise_seed, on_step=None):
    """The reference's first steps on the replayed `batches`: the losses
    of each pair, the gradients of the first pair as the update received
    them ({leaf: tensor}) and the nets' outputs in the first FM step;
    `on_step(i)` after pair i."""
    opts = {n: ref_train.Adam(nets[n].parameters(), cfg["lr"],
                              cfg["beta_1"], cfg["beta_2"], cfg["grad_clip"])
            for n in NETS}
    names = {n: [k for k, _ in nets[n].named_parameters()] for n in NETS}
    losses, first, outputs = [], None, None
    for i, (A, te) in enumerate(batches):
        A = torch.from_numpy(np.ascontiguousarray(A)).to(dev)
        te = torch.from_numpy(np.ascontiguousarray(te)).to(dev)
        pair, grads = [], {}
        for n, train in (("g_fm", "fm"), ("g_r2", "r2")):
            loss, out = ref_train.cycle_loss(nets["g_fm"], nets["g_r2"], A,
                                             te, cfg["field"], train)
            loss.backward()
            g = opts[n].step()
            grads.update({f"{n}.{k}": v for k, v in zip(names[n], g)})
            pair.append(loss.item())
            if outputs is None:
                outputs = {k: v.detach() for k, v in out.items()}
        losses.append(pair)
        first = grads if first is None else first
        if on_step is not None:
            on_step(i)
    return losses, first, outputs


def train_calls(cfg):
    """(ConvLSTM calls, per-voxel kernel calls) of one step pair."""
    nb, h = cfg["batch_size"], cfg["data_size"]
    ne, f = cfg["n_echoes"], cfg["n_G_filters"]
    return ([(nb, h, h, 2, f, ne, True), (nb, h, h, 1, f, ne, False),
             (nb, h, h, 2, f, ne, False), (nb, h, h, 1, f, ne, True)],
            [("cycle", nb, h, h, ne), ("cycle", nb, h, h, ne)])


def count_unit(cfg, nets, dev, train: bool):
    """Run one unit of the reference on `dev` (the FLOP counter's meta
    device): a chunk of `infer_batch` slices or a step pair."""
    nb = cfg["batch_size"] if train else cfg["infer_batch"]
    h, ne = cfg["data_size"], cfg["n_echoes"]
    A = torch.zeros((nb, ne, h, h, 2), device=dev)
    te = torch.zeros((nb, ne, 1), device=dev)
    if not train:
        with torch.no_grad():
            nets["g_fm"](A)
            nets["g_r2"](magnitude(A))
        return
    for train_net in ("fm", "r2"):
        with torch.set_grad_enabled(train_net == "fm"):
            fm = nets["g_fm"](A)
        with torch.set_grad_enabled(train_net == "r2"):
            r2 = nets["g_r2"](magnitude(A))
        torch.cat([fm, r2], dim=-1).sum().backward()
