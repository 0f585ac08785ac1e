"""CLI: in-vivo ROI bias evaluation on the card, headless (port of
`ideal_gan_tpu/cli/roi_analysis.py`), and the per-chunk model inference it
shares with the serving CLI (`make_infer_run`, `_restore`, `_per_slice`).

    python -m ideal_gan_tpu_torch.cli.roi_analysis --model_sel AI-DEAL \
        --experiment_dir output/Unsup-v0 [--synthetic 16] --data_size 384 \
        --infer_batch 8 --map PDFF --crops_file crops.npy \
        [--te_suffix 1 --te1 0.0014 --dte 0.0022] --output_base output

`main` runs the selected model family over the cohort (`infer_maps`: chunks
of `--infer_batch` slices on `--device`), computes the PDFF, R2* or Water
maps, or with `--map PDFF-var` the propagated PDFF variance, evaluates the
ROI crops of `--crops_file` (default
`ROI_files/<dataset>_slices_crops.npy`; `--interactive` opens the picker
first, on a workstation with matplotlib) against the cohort's ground-truth
maps (PDFF by the ROI median, the others by the mean), prints the mean
bias and the share within the envelope (±0.03 PDFF, ±10 s⁻¹ R2*, ±0.05
Water) and writes the RHL/LHL workbook (`--out_xlsx`, or with
`--te_suffix` `<map>_ROIs_<te1·1e4>_<dte·1e4>.xlsx`) and settings_roi.yml
under <output_base>/<dataset>/.

Weights come from `--weights` (an `.npz` of Flax parameters), or else from
the experiment directory a port trainer wrote (`--experiment_dir`: its
`settings.yml` overlaid on the family's `DEFAULTS`, and its newest
`checkpoints/ckpt-*.pt`), or else, with a printed line, from a seeded
random initialization, as the JAX package serves its initial weights where
the experiment has no checkpoint.

AI-DEAL reads posterior heads where the experiment trained them (UQ,
UQ_R2s): the Normal's loc and variance, the Rician's ν and variance. With
`--map PDFF-var` it serves ρ and its covariance `rho_var` from
`physics.pdff_uncertainty` (with `rem_R2`); `pdff_variance_map` turns them
into the PDFF variance.

Serving uses every local card (one process, as JAX's single controller
does): with more than one card and `--infer_batch` > 1, `make_infer_run`
builds one replica of the net per card from the same weights and
`_per_slice` splits each chunk over the largest card count that divides
it, the rows coming back in order. `devices=` (not a flag) names the
cards; a list may name one card twice.

`GraphCuts` consumes precomputed maps and raises SystemExit, as in the JAX
package (`cli.roi_realphantom` fits them).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .. import convert, ops, physics
from ..data import layouts
from ..eval import roi as roi_mod
from ..prob import Normal, Rician
from ..train import mag, sup, teaug, unsup
from ..utils import Checkpoint
from .common import (load_cohorts, load_settings, resolve_device,
                     setup_experiment)

FAMILIES = ("AI-DEAL", "VET-Net", "Mag", "2D-Net", "U-Net", "MDWF")

DEFAULTS = dict(
    dataset="Unsup-v0", experiment_dir="output/Unsup-v0",
    # U-Net | MDWF | 2D-Net | VET-Net | AI-DEAL | Mag
    model_sel="AI-DEAL",
    map="PDFF",  # PDFF | R2s | Water | PDFF-var
    n_echoes=6, field=1.5, batch_size=1, crops_file="",
    te1=0.0013, dte=0.0021, out_xlsx="ROI_analysis.xlsx", te_suffix=False,
    interactive=False, rem_R2=False, infer_batch=1, weights="",
)


class Replicas(list):
    """One inference closure per device of `devices` (`make_infer_run` on
    more than one device), each on its replica of the net."""

    def __init__(self, runs, devices):
        super().__init__(runs)
        self.devices = [torch.device(d) for d in devices]


def serving_devices(device, devices=None) -> list:
    """The devices serving splits its chunks over: `devices` where given,
    else for a card every local card (`device` first), else `device`."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [dev] + [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())
                    if i != dev.index]


# the profiler ranges of the serving loop: one `VOLUME_RANGE` a call of
# `_per_slice`, holding the others
VOLUME_RANGE = "serve volume"
PAD_RANGE = "serve pad"
TO_CARD_RANGE = "serve to card"
RUN_RANGE = "serve run"
TO_HOST_RANGE = "serve to host"
ASSEMBLE_RANGE = "serve assemble"


@dataclasses.dataclass
class ServeCount:
    """What `_per_slice` has served: chunks run, slices served and slices
    computed as padding of a last chunk. The difference of two readings
    counts what was served between them."""
    chunks: int = 0
    slices: int = 0
    padded: int = 0

    def __sub__(self, other: ServeCount) -> ServeCount:
        return ServeCount(self.chunks - other.chunks,
                          self.slices - other.slices,
                          self.padded - other.padded)

    @property
    def padded_share(self) -> float:
        """The padding's share of the computed slices."""
        computed = self.slices + self.padded
        return self.padded / computed if computed else 0.0


# every call of `_per_slice` in the process
SERVED = ServeCount()


def _per_slice(run, acqs, te, batch_size: int = 1, device="cuda"):
    """Chunked inference over the cohort: chunks of `batch_size` slices (the
    last padded by repeating its final slice, then trimmed) go to `device`,
    through `run`, and back to the host. Where `run` is `Replicas`, each
    chunk is split over the first `parallel.mesh.split_count` of its
    devices (the most that divide the chunk), every part
    launched before any comes back (the cards run at once), and the rows
    returned in order. Returns the tuple of `run`'s outputs concatenated
    over the cohort, as numpy arrays.

    Each step is a profiler range inside `VOLUME_RANGE`: `PAD_RANGE` the
    padding, per part `TO_CARD_RANGE` the copies to its device and
    `RUN_RANGE` the call of `run`, per chunk `TO_HOST_RANGE` every output's
    copy back (the wait for the card included) and `ASSEMBLE_RANGE` the
    concatenation over parts and the trim; the last chunk's
    `ASSEMBLE_RANGE` also holds the concatenation over chunks. `SERVED`
    counts the chunks and slices."""
    from ..parallel.mesh import split_count
    from ..parallel.serving import device_context
    rf = torch.profiler.record_function
    bs = max(int(batch_size), 1)
    if isinstance(run, Replicas):
        n = split_count(bs, len(run))
        parts = list(zip(run[:n], run.devices[:n]))
    else:
        n, parts = 1, [(run, resolve_device(device))]
    per = bs // n
    outs, volume = [], ()
    with rf(VOLUME_RANGE):
        for i in range(0, len(acqs), bs):
            a = np.asarray(acqs[i:i + bs])
            t = np.asarray(te[i:i + bs])
            k = len(a)
            if k < bs:
                with rf(PAD_RANGE):
                    a = np.concatenate([a, np.repeat(a[-1:], bs - k, axis=0)])
                    t = np.concatenate([t, np.repeat(t[-1:], bs - k, axis=0)])
            pending = []
            for j, (fn, dev) in enumerate(parts):
                rows = slice(j * per, (j + 1) * per)
                with device_context(dev):
                    with rf(TO_CARD_RANGE):
                        a_dev = torch.from_numpy(a[rows]).to(dev)
                        t_dev = torch.from_numpy(t[rows]).to(dev)
                    with rf(RUN_RANGE):
                        pending.append(fn(a_dev, t_dev))
                    del a_dev, t_dev  # freed as the call returns
            with rf(TO_HOST_RANGE):
                host = [[p[m].cpu() for p in pending]
                        for m in range(len(pending[0]))]
            with rf(ASSEMBLE_RANGE):
                o = tuple(np.concatenate([h.numpy() for h in hs])
                          for hs in host)
                del host  # freed before the next chunk's copies
                outs.append(tuple(x[:k] for x in o))
                if i + bs >= len(acqs):
                    volume = tuple(np.concatenate(xs) for xs in zip(*outs))
            SERVED.chunks += 1
            SERVED.slices += k
            SERVED.padded += bs - k
    return volume


def experiment_settings(cfg, defaults: dict) -> dict:
    """The family's `defaults` overlaid with the settings the experiment of
    `cfg["experiment_dir"]` was trained with, on the keys of `defaults`
    only (so `device` or `output_dir` never come from the file)."""
    fcfg = dict(defaults)
    if cfg.get("experiment_dir"):
        try:
            saved = load_settings(cfg["experiment_dir"])
        except FileNotFoundError:
            saved = {}
        fcfg.update({k: v for k, v in saved.items() if k in fcfg})
    return fcfg


def restore_checkpoint(cfg) -> dict | None:
    """The newest checkpoint of `cfg["experiment_dir"]` (the trainer's state
    dict, tensors on the CPU), or None where there is none. Creates no
    directory."""
    exp = cfg.get("experiment_dir")
    if not exp or not (Path(exp) / "checkpoints").is_dir():
        return None
    ckpt = Checkpoint(Path(exp) / "checkpoints")
    step = ckpt.latest_step()
    if step is None:
        return None
    print(f"serving the epoch-{step} checkpoint of {exp}")
    return ckpt.restore(step)


def _seeded(cfg, *nets) -> None:
    """Seeded random weights (`cfg["seed"]`) for `nets`, with a printed
    line: the JAX package serves its initial weights here too."""
    print(f"no checkpoint under --experiment_dir "
          f"{cfg.get('experiment_dir') or '(none)'}: serving seeded random "
          f"weights (--seed {int(cfg.get('seed', 0))})")
    gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
    for net in nets:
        net.init_params(gen)


def load_models(cfg, device="cuda"):
    """The AI-DEAL generators on `device`, in eval mode, and the global FM
    offset. Weights come from `cfg["weights"]`, an `.npz` of the Flax state's
    `params_fm/...`, `params_r2/...` (and optional `fm_offset`) paths, whose
    shapes also give the width, the attention flags and the Bayesian heads
    (UQ, UQ_R2s: a σ head's `Conv_1`); or else from the
    experiment's checkpoint (`g_fm`, `g_r2`, `fm_offset`) at its settings;
    or else from a seeded random initialization."""
    dev = resolve_device(device)
    if cfg.get("weights"):
        ucfg = dict(unsup.DEFAULTS)
        tree = convert.load_npz(cfg["weights"])
        lstm = tree["params_fm"]["ConvLSTM_0"]["input_conv"]["kernel"]
        ucfg.update(n_G_filters=int(lstm.shape[-1]) // 4,
                    D1_SelfAttention="SelfAttention_0" in tree["params_fm"],
                    D2_SelfAttention="SelfAttention_0" in tree["params_r2"],
                    UQ="Conv_1" in tree["params_fm"],
                    UQ_R2s="Conv_1" in tree["params_r2"])
        g_fm, g_r2 = unsup.build_models(ucfg)
        g_fm.load_state_dict(convert.unet(tree["params_fm"]))
        g_r2.load_state_dict(convert.unet(tree["params_r2"]))
        fm_offset = float(tree.get("fm_offset", 0.0))
    else:
        g_fm, g_r2 = unsup.build_models(experiment_settings(cfg,
                                                            unsup.DEFAULTS))
        state = restore_checkpoint(cfg)
        if state is None:
            _seeded(cfg, g_fm, g_r2)
            fm_offset = 0.0
        else:
            g_fm.load_state_dict(state["g_fm"])
            g_r2.load_state_dict(state["g_r2"])
            fm_offset = float(state["fm_offset"])
    return g_fm.to(dev).eval(), g_r2.to(dev).eval(), fm_offset


def load_vetnet(cfg, device="cuda"):
    """VET-Net on `device`, in eval mode, and its `train.teaug` settings.
    Weights come from `cfg["weights"]`, an `.npz` of the Flax state's
    `params/...` paths, whose shapes also give the width, the TE input and
    the attention flags; or else from the experiment's checkpoint
    (`model`) at its settings; or else from a seeded random
    initialization."""
    dev = resolve_device(device)
    if cfg.get("weights"):
        tcfg = dict(teaug.DEFAULTS)
        p = convert.load_npz(cfg["weights"])["params"]
        lstm = p["ConvLSTM_0"]["input_conv"]["kernel"]
        tcfg.update(n_G_filters=int(lstm.shape[-1]) // 4,
                    te_input="TEEncoder_0" in p["_SharedEncoder_0"],
                    R2_SelfAttention="SelfAttention_0" in p["dec_r2"],
                    FM_SelfAttention="SelfAttention_0" in p["dec_fm"])
        model = teaug.build_model(tcfg)
        model.load_state_dict(convert.vetnet(p))
    else:
        tcfg = experiment_settings(cfg, teaug.DEFAULTS)
        model = teaug.build_model(tcfg)
        state = restore_checkpoint(cfg)
        if state is None:
            _seeded(cfg, model)
        else:
            model.load_state_dict(state["model"])
    return model.to(dev).eval(), tcfg


def load_mag_model(cfg, device="cuda"):
    """The magnitude UNet on `device`, in eval mode, and its `train.mag`
    settings. Weights come from `cfg["weights"]`, an `.npz` of the Flax
    state's `params/...` paths, whose shapes also give the width, the
    attention flag, the TE input (supervised training) and the Rician head
    (main_loss="Rice"); or else from the experiment's checkpoint (`model`)
    at its settings; or else from a seeded random initialization."""
    dev = resolve_device(device)
    if cfg.get("weights"):
        mcfg = dict(mag.DEFAULTS)
        p = convert.load_npz(cfg["weights"])["params"]
        lstm = p["ConvLSTM_0"]["input_conv"]["kernel"]
        mcfg.update(n_G_filters=int(lstm.shape[-1]) // 4,
                    D1_SelfAttention="SelfAttention_0" in p,
                    training_mode="supervised" if "TEEncoder_0" in p
                    else "unsupervised",
                    main_loss="Rice" if "Conv_1" in p else "MSE")
        model = mag.build_model(mcfg)
        model.load_state_dict(convert.unet(p))
    else:
        mcfg = experiment_settings(cfg, mag.DEFAULTS)
        model = mag.build_model(mcfg)
        state = restore_checkpoint(cfg)
        if state is None:
            _seeded(cfg, model)
        else:
            model.load_state_dict(state["model"])
    return model.to(dev).eval(), mcfg


def _sup_settings(sel: str, scfg: dict) -> dict:
    """The supervised net a selector serves: 2D-Net the PM-mode U-Net
    (pinned before the experiment's settings are overlaid, as the JAX
    package does), U-Net a U-Net and MDWF the WF-PM multi-decod net
    (pinned after them)."""
    if sel == "U-Net":
        return dict(scfg, G_model="U-Net")
    if sel == "MDWF":
        return dict(scfg, G_model="multi-decod", out_vars="WF-PM")
    return scfg


def load_sup_model(cfg, device="cuda"):
    """The supervised net of `cfg["model_sel"]` (2D-Net, U-Net or MDWF) on
    `device`, in eval mode, and its `train.sup` settings. Weights come from
    `cfg["weights"]`, an `.npz` of the Flax state's `params/...` paths,
    whose shapes also give the width, the echo count, the attention flags
    and, for a U-Net with a 4-channel head, out_vars WF-PM (a WFc net is
    served from its experiment directory, where its settings name it); or
    else from the experiment's checkpoint (`model`) at its settings; or
    else from a seeded random initialization."""
    dev = resolve_device(device)
    sel = cfg["model_sel"]
    pinned = (dict(sup.DEFAULTS, G_model="U-Net", out_vars="PM")
              if sel == "2D-Net" else sup.DEFAULTS)
    if cfg.get("weights"):
        scfg = dict(pinned)
        p = convert.load_npz(cfg["weights"])["params"]
        if sel == "MDWF":
            k = p["_SharedEncoder_0"]["ConvBlock_0"]["Conv_0"]["kernel"]
            scfg.update({f"D{i}_SelfAttention": "SelfAttention_0" in p[d]
                         for i, d in ((1, "dec_wf"), (2, "dec_r2"),
                                      (3, "dec_fm"))})
        else:
            k = p["ConvBlock_0"]["Conv_0"]["kernel"]
            scfg["D1_SelfAttention"] = "SelfAttention_0" in p
            if sel == "U-Net" and p["Conv_0"]["kernel"].shape[-1] == 4:
                scfg["out_vars"] = "WF-PM"
        scfg.update(n_G_filters=int(k.shape[-1]),
                    n_echoes=int(k.shape[2]) // 2)
        scfg = _sup_settings(sel, scfg)
        model = sup.build_model(scfg)
        model.load_state_dict(convert.mdwfnet(p) if sel == "MDWF"
                              else convert.unet(p))
    else:
        scfg = _sup_settings(sel, experiment_settings(cfg, pinned))
        model = sup.build_model(scfg)
        state = restore_checkpoint(cfg)
        if state is None:
            _seeded(cfg, model)
        else:
            model.load_state_dict(state["model"])
    return model.to(dev).eval(), scfg


def make_infer_run(cfg, acqs, device="cuda", devices=None):
    """Model dispatch → the per-chunk inference closure run(a, te_b) ->
    (maps (nb, 3, H, W, 2), rho_var (nb, 4, H, W, 1)). Builds the models
    once; callers reuse the closure across chunks. `acqs` is accepted for
    parity with the JAX signature and not read. `--map` PDFF, R2s and Water
    serve the same maps, as in the JAX package; AI-DEAL's PDFF-var serves
    the GLS ρ and its covariance. Where `serving_devices(device, devices)`
    names more than one device, `Replicas`: one closure per device, each
    built from the same weights."""
    devs = serving_devices(device, devices)
    if len(devs) > 1:
        return Replicas([_make_run(cfg, d) for d in devs], devs)
    return _make_run(cfg, device)


def _make_run(cfg, device):
    """`make_infer_run`'s closure on one device."""
    sel = cfg["model_sel"]
    if sel == "GraphCuts":
        raise SystemExit("GraphCuts mode consumes precomputed maps; "
                         "use the library API (eval.roi) directly")
    if sel not in FAMILIES:
        raise SystemExit(f"model_sel {sel!r} is not ported yet (ROADMAP "
                         f"Queue 1); the port serves {', '.join(FAMILIES)}")
    if sel == "Mag":
        return _mag_run(cfg, device)
    if sel == "VET-Net":
        return _vetnet_run(cfg, device)
    if sel == "2D-Net":
        return _twod_net_run(cfg, device)
    if sel in ("U-Net", "MDWF"):
        return _sup_run(cfg, device)
    g_fm, g_r2, fm_offset = load_models(cfg, device)
    pdff_var = cfg.get("map", "PDFF") == "PDFF-var"
    field, rem_r2 = cfg["field"], bool(cfg.get("rem_R2", False))

    @torch.inference_mode()
    def run(a, te_b):
        return aideal_maps(g_fm, g_r2, fm_offset, a, te_b, field, pdff_var,
                           rem_r2)

    return run


def infer_maps(cfg, acqs, te, devices=None):
    """Model dispatch → (maps (n, 3, H, W, 2), rho_var (n, 4, H, W, 1)) as
    numpy, in chunks of `cfg["infer_batch"]` (default 1) slices on
    `cfg["device"]` (default `cuda`), split over `devices` (default every
    local card)."""
    device = cfg.get("device", "cuda")
    return _per_slice(make_infer_run(cfg, acqs, device, devices), acqs, te,
                      int(cfg.get("infer_batch", 1)), device)


def aideal_heads(g_fm, g_r2, fm_offset, a):
    """The AI-DEAL nets' (φ, R2*) posteriors on one chunk as ((φ mean, φ
    variance), (R2* mean, R2* variance)), each (nb, 1, H, W, 1): a Normal
    head's loc (plus `fm_offset`) and variance, a Rician head's ν and
    variance, a deterministic head's output and zeros."""
    out_fm = g_fm(a)
    if isinstance(out_fm, Normal):
        fm_mean, fm_var = out_fm.loc, out_fm.variance()
    else:
        fm_mean, fm_var = out_fm, torch.zeros_like(out_fm)
    a_abs = torch.sqrt(torch.sum(torch.square(a), dim=-1, keepdim=True))
    out_r2 = g_r2(a_abs)
    if isinstance(out_r2, Rician):
        r2_mean, r2_var = out_r2.nu, out_r2.variance()
    else:
        r2_mean, r2_var = out_r2, torch.zeros_like(out_r2)
    return (fm_mean + fm_offset, fm_var), (r2_mean, r2_var)


def aideal_maps(g_fm, g_r2, fm_offset, a, te_b, field: float,
                pdff_var: bool = False, rem_r2: bool = False):
    """The AI-DEAL branch on one chunk: the heads (`aideal_heads`), then
    the map fit kernel and a zero rho_var, or with `pdff_var` the plain
    `physics.pdff_uncertainty` (ρ and rho_var); maps [ρ_w, ρ_f, (φ,
    R2*)]."""
    (fm_mean, fm_var), (r2_mean, r2_var) = aideal_heads(g_fm, g_r2,
                                                        fm_offset, a)
    pm = torch.cat([fm_mean, r2_mean], dim=-1)
    if pdff_var:
        rho, rho_var = physics.pdff_uncertainty(
            a, physics.Posterior(fm_mean[:, 0, ..., 0], fm_var[:, 0, ..., 0]),
            physics.Posterior(r2_mean[:, 0, ..., 0], r2_var[:, 0, ..., 0]),
            te_b, field=field, rem_r2=rem_r2)
    else:
        rho = ops.fit_rho_fused(a, pm, te_b, field=field)
        rho_var = _zero_var(rho)
    return torch.cat([rho, pm], dim=1), rho_var


def pdff_variance_map(maps: np.ndarray, rho_var: np.ndarray) -> np.ndarray:
    """The PDFF variance by first-order propagation from the W/F covariance
    entries: rho_var's rows are the flattened 2×2 covariance [W_var,
    WF_var, FW_var, F_var]; 0 where |F| or |W + F| is 0."""
    f = np.abs(maps[:, 1, ..., 0] + 1j * maps[:, 1, ..., 1])
    tot = np.abs((maps[:, 0, ..., 0] + maps[:, 1, ..., 0])
                 + 1j * (maps[:, 0, ..., 1] + maps[:, 1, ..., 1]))
    w_var = rho_var[:, 0, ..., 0]
    wf_var = rho_var[:, 1, ..., 0]
    f_var = rho_var[:, 3, ..., 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        pdff_var = f_var / np.where(f > 0, f ** 2, 1.0)
        pdff_var -= 2 * wf_var / np.where(f * tot > 0, f * tot, 1.0)
        pdff_var += (w_var + f_var + 2 * wf_var) / np.where(tot > 0, tot,
                                                            1.0)
        pdff_var *= np.where(tot > 0, f ** 2 / tot ** 2, 0.0)
    return np.nan_to_num(pdff_var)


def _zero_var(rho):
    """The all-zero rho_var (nb, 4, H, W, 1) of the deterministic heads."""
    return rho.new_zeros(rho.shape[:1] + (4,) + rho.shape[2:4] + (1,))


def vetnet_maps(model, a, te_b, field: float):
    """The VET-Net branch on one chunk: (φ, R2*) from the net on the echoes
    and the TE vector (as float32, whatever the net's dtype), then the plain
    phase-constrained fit; maps [ρ_w, ρ_f, (φ, R2*)] and a zero rho_var."""
    pm = model(a, te_b[..., 0]).float()
    rho = physics.fit_rho(a, pm, te_b, field=field, phase_constraint=True)
    return torch.cat([rho, pm], dim=1), _zero_var(rho)


def _vetnet_run(cfg, device):
    """The VET-Net branch (`vetnet_maps` on each chunk)."""
    model, _ = load_vetnet(cfg, device)
    field = cfg["field"]

    @torch.inference_mode()
    def run(a, te_b):
        return vetnet_maps(model, a, te_b, field)

    return run


def _mag_run(cfg, device):
    """The Mag branch: |a| → the magnitude UNet (with the TE vector when it
    was trained supervised) → R2* (the Rician's mean for a Bayesian head)
    → the magnitude fit. Maps [|W|, 0], [|F|, 0], [0, R2*]; rho_var the
    rank-1 ratio repeated 4 times."""
    model, mcfg = load_mag_model(cfg, device)
    supervised = mcfg["training_mode"] == "supervised"
    field = cfg["field"]

    @torch.inference_mode()
    def run(a, te_b):
        a_mag = torch.sqrt(torch.sum(torch.square(a), dim=-1, keepdim=True))
        out = model(a_mag, te_b[..., 0]) if supervised else model(a_mag)
        r2 = out.mean() if isinstance(out, Rician) else out
        res = ops.cse_mag_fused(a_mag, r2, te_b, field=field)
        wf = torch.cat([res.rho, torch.zeros_like(res.rho)], dim=-1)
        pm = torch.cat([torch.zeros_like(r2), r2], dim=-1)
        return (torch.cat([wf, pm], dim=1),
                torch.cat([res.uncertainty] * 4, dim=1))

    return run


def twod_net_maps(model, a, te_b, field: float):
    """The 2D-Net branch on one chunk: the PM U-Net on the legacy echoes →
    (R2*, (FM − 0.5)·2) as float32 → the map fit; maps [ρ_w, ρ_f, (φ,
    R2*)] and a zero rho_var."""
    out = model(layouts.acqs_from_mebcrn(a)).float()
    r2, fm = out[..., :1], (out[..., 1:] - 0.5) * 2.0
    pm = layouts.maps_to_mebcrn(torch.cat([r2, fm], dim=-1), mode="PM")
    rho = ops.fit_rho_fused(a, pm, te_b, field=field)
    return torch.cat([rho, pm], dim=1), _zero_var(rho)


def _twod_net_run(cfg, device):
    """The 2D-Net branch (`twod_net_maps` on each chunk)."""
    model, _ = load_sup_model(cfg, device)
    field = cfg["field"]

    @torch.inference_mode()
    def run(a, te_b):
        return twod_net_maps(model, a, te_b, field)

    return run


def _sup_run(cfg, device):
    """The U-Net and MDWF branches: the net on the legacy echoes, its
    channels [|W|, |F|(, R2*, FM)] as maps [|W|, 0], [|F|, 0], [FM, R2*]
    (zero where the net has two channels), no fit."""
    model, _ = load_sup_model(cfg, device)

    @torch.inference_mode()
    def run(a, te_b):
        out = model(layouts.acqs_from_mebcrn(a))
        wf_abs = out[..., :2]
        pm = out[..., 2:4] if out.shape[-1] >= 4 else torch.zeros_like(
            wf_abs)
        zero = torch.zeros_like(wf_abs[..., 0])
        w = torch.stack([wf_abs[..., 0], zero], -1)[:, None]
        f = torch.stack([wf_abs[..., 1], zero], -1)[:, None]
        pm_row = torch.stack([pm[..., 1], pm[..., 0]], -1)[:, None]
        maps = torch.cat([w, f, pm_row], dim=1)
        return maps, maps.new_zeros(maps.shape[:1] + (4,) + maps.shape[2:4]
                                    + (1,))

    return run


def map_stacks(cfg, maps, rho_var, gt_maps):
    """The `--map` stacks of the served and the ground-truth maps, the ROI
    statistic and the bias envelope: PDFF (median, 0.03), R2s in s⁻¹
    (mean, 10), Water |W| (mean, 0.05), PDFF-var (the propagated variance
    against the ground-truth PDFF, mean, 0.03)."""
    pdff, r2s, w_abs = roi_mod.maps_to_display(maps)
    pdff_gt, r2s_gt, w_gt = roi_mod.maps_to_display(gt_maps)
    if cfg["map"] == "PDFF-var":
        return pdff_variance_map(maps, rho_var), pdff_gt, "mean", 0.03
    return {
        "PDFF": (pdff, pdff_gt, "median", 0.03),
        "R2s": (r2s * physics.R2_SC, r2s_gt * physics.R2_SC, "mean", 10.0),
        "Water": (w_abs, w_gt, "mean", 0.05),
    }[cfg["map"]]


def xlsx_name(cfg) -> str:
    """`--out_xlsx`, or with `--te_suffix` the per-protocol name
    `<map>_ROIs_<round(te1·1e4)>_<round(dte·1e4)>.xlsx` (e.g.
    PDFF_ROIs_14_22.xlsx) that the statistics enumerate."""
    if cfg.get("te_suffix"):
        return (f"{cfg['map']}_ROIs_{round(cfg['te1'] * 1e4)}_"
                f"{round(cfg['dte'] * 1e4)}.xlsx")
    return cfg["out_xlsx"]


def main(argv=None) -> dict:
    """Runs the evaluation; returns {"maps", "rho_var" (numpy), "stack",
    "stack_gt", "stat", "res_model", "res_ref" (`eval.roi.ROIResult`),
    "errors", "within", "xlsx" (the workbook's path)}."""
    cfg = setup_experiment(DEFAULTS, argv, settings_name="settings_roi.yml")
    acqs, gt_maps, te = load_cohorts(cfg)
    maps, rho_var = infer_maps(cfg, acqs, te)
    stack, stack_gt, stat, env = map_stacks(cfg, maps, rho_var, gt_maps)
    crops_file = cfg["crops_file"] or str(
        Path("ROI_files") / f"{cfg['dataset']}_slices_crops.npy")
    if cfg["interactive"]:
        from ..eval.tracker import run_interactive
        run_interactive(np.transpose(stack, (1, 2, 0)),
                        lims=(0, 1) if "PDFF" in cfg["map"] else
                        (0, physics.R2_SC), npy_file=crops_file)
    if not Path(crops_file).exists():
        raise SystemExit(f"no crops file at {crops_file}; run with "
                         "--interactive on a workstation or provide one")
    res_m = roi_mod.roi_stats(stack, crops_file, stat=stat)
    res_r = roi_mod.roi_stats(stack_gt, crops_file, stat=stat)
    err, within = roi_mod.bias_histogram(res_m.values_1, res_r.values_1, env)
    print(f"{cfg['map']}: mean bias {np.mean(err):+.4f}, "
          f"{100 * within:.1f}% within ±{env}")
    out = Path(cfg["output_dir"]) / xlsx_name(cfg)
    roi_mod.export_roi_xlsx(str(out), res_m, res_r, map_name=cfg["map"])
    print(f"wrote {out}")
    return dict(maps=maps, rho_var=rho_var, stack=stack, stack_gt=stack_gt,
                stat=stat, res_model=res_m, res_ref=res_r, errors=err,
                within=within, xlsx=out)


if __name__ == "__main__":
    main()
