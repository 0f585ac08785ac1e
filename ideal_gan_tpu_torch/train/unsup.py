"""AI-DEAL unsupervised model family (port of `ideal_gan_tpu/train/unsup.py`):
the settings and the two generators. The trainer itself is not ported yet
(ROADMAP Queue 1)."""

from __future__ import annotations

from ..models import UNet

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
    head) and the R2* net on their magnitudes (Cin = 1, sigmoid head)."""
    if cfg.get("bf16") or cfg.get("remat"):
        raise NotImplementedError("bf16 / remat UNets are not ported yet "
                                  "(ROADMAP Queue 1)")
    g_fm = UNet(2, n_out=1, bayesian=cfg["UQ"], me_layer=True,
                filters=cfg["n_G_filters"],
                self_attention=cfg["D1_SelfAttention"])
    g_r2 = UNet(1, n_out=1, bayesian=cfg["UQ_R2s"], me_layer=True,
                filters=cfg["n_G_filters"], output_activation="sigmoid",
                self_attention=cfg["D2_SelfAttention"])
    return g_fm, g_r2
