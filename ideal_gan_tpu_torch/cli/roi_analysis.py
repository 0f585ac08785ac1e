"""Per-chunk model inference for the serving CLI (port of the AI-DEAL branch
of `ideal_gan_tpu/cli/roi_analysis.py`'s `make_infer_run` and `_per_slice`).

The other model families (VET-Net, Mag, U-Net, MDWF, 2D-Net), the PDFF-var
map and the ROI evaluation are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import convert, ops
from ..train import unsup
from .common import resolve_device


def _per_slice(run, acqs, te, batch_size: int = 1, device="cuda"):
    """Chunked inference over the cohort: chunks of `batch_size` slices (the
    last padded by repeating its final slice, then trimmed) go to `device`,
    through `run`, and back to the host. Returns the tuple of `run`'s
    outputs concatenated over the cohort, as numpy arrays."""
    bs = max(int(batch_size), 1)
    dev = resolve_device(device)
    outs = []
    for i in range(0, len(acqs), bs):
        a = np.asarray(acqs[i:i + bs])
        t = np.asarray(te[i:i + bs])
        k = len(a)
        if k < bs:
            a = np.concatenate([a, np.repeat(a[-1:], bs - k, axis=0)])
            t = np.concatenate([t, np.repeat(t[-1:], bs - k, axis=0)])
        o = run(torch.from_numpy(a).to(dev), torch.from_numpy(t).to(dev))
        outs.append(tuple(x.cpu().numpy()[:k] for x in o))
    return tuple(np.concatenate(xs) for xs in zip(*outs))


def load_models(cfg, device="cuda"):
    """The AI-DEAL generators on `device`, in eval mode, and the global FM
    offset. Weights come from `cfg["weights"]`, an `.npz` of the Flax state's
    `params_fm/...`, `params_r2/...` (and optional `fm_offset`) paths, whose
    shapes also give the width and the attention flags; or else from a
    seeded random initialization (`cfg["seed"]`) at `unsup.DEFAULTS`."""
    dev = resolve_device(device)
    ucfg = dict(unsup.DEFAULTS)
    fm_offset = 0.0
    if cfg.get("weights"):
        tree = convert.load_npz(cfg["weights"])
        lstm = tree["params_fm"]["ConvLSTM_0"]["input_conv"]["kernel"]
        ucfg.update(n_G_filters=int(lstm.shape[-1]) // 4,
                    D1_SelfAttention="SelfAttention_0" in tree["params_fm"],
                    D2_SelfAttention="SelfAttention_0" in tree["params_r2"])
        g_fm, g_r2 = unsup.build_models(ucfg)
        g_fm.load_state_dict(convert.unet(tree["params_fm"]))
        g_r2.load_state_dict(convert.unet(tree["params_r2"]))
        fm_offset = float(tree.get("fm_offset", 0.0))
    else:
        g_fm, g_r2 = unsup.build_models(ucfg)
        gen = torch.Generator().manual_seed(int(cfg.get("seed", 0)))
        g_fm.init_params(gen)
        g_r2.init_params(gen)
    return g_fm.to(dev).eval(), g_r2.to(dev).eval(), fm_offset


def make_infer_run(cfg, acqs, device="cuda"):
    """Model dispatch → the per-chunk inference closure run(a, te_b) ->
    (maps (nb, 3, H, W, 2), rho_var (nb, 4, H, W, 1)). Builds the models
    once; callers reuse the closure across chunks. `acqs` is accepted for
    parity with the JAX signature and not read."""
    del acqs
    sel = cfg["model_sel"]
    if sel != "AI-DEAL":
        raise SystemExit(f"model_sel {sel!r} is not ported yet (ROADMAP "
                         "Queue 1); the port serves AI-DEAL")
    if cfg.get("map", "PDFF") != "PDFF":
        raise SystemExit(f"map {cfg['map']!r} is not ported yet (ROADMAP "
                         "Queue 1)")
    g_fm, g_r2, fm_offset = load_models(cfg, device)
    field = cfg["field"]

    @torch.inference_mode()
    def run(a, te_b):
        fm_mean = g_fm(a) + fm_offset
        a_abs = torch.sqrt(torch.sum(torch.square(a), dim=-1, keepdim=True))
        r2_mean = g_r2(a_abs)
        pm = torch.cat([fm_mean, r2_mean], dim=-1)
        rho = ops.fit_rho_fused(a, pm, te_b, field=field)
        rho_var = rho.new_zeros(rho.shape[:1] + (4,) + rho.shape[2:4] + (1,))
        return torch.cat([rho, pm], dim=1), rho_var

    return run
