"""CLI: the gradient-flow check of the uncertainty path (port of
`ideal_gan_tpu/cli/test_gradients.py`): do gradients reach the Bayesian
R2* net through the IDEAL cycle, the propagated acquisition variance and
the heteroscedastic loss, on a downsampled batch?

    python -m ideal_gan_tpu_torch.cli.test_gradients --synthetic 2 \\
        --data_size 384

The nets are `train.unsup`'s UQ nets (`out_vars` PM, `UQ`, `UQ_R2s`) at
`--n_G_filters`, seeded random weights (`--seed`); the batch is the first
`--batch_size` slices of the cohort, every `--downsample`-th pixel. The
loss is `var_mse` on [Â, Var Â]: Â from the cycle kernel
(`ops.cycle_full_fused`, the function the JAX harness computes with the
plain `physics.cycle_full`), Var Â from `physics.acq_uncertainty` on the
cycle's ρ (detached) and the two posteriors. Its gradient is taken with
respect to the R2* net's parameters only (the field-map net runs without
a gradient). Prints the loss and the gradient leaves' counts, and raises
if a leaf is not finite or none is non-zero. Runs on the card unless
`--device` says otherwise.
"""

from __future__ import annotations

import torch

from .. import physics
from ..losses import var_mse
from ..ops import cycle_full_fused
from ..train import unsup
from .common import load_cohorts, resolve_device, setup_experiment

DEFAULTS = dict(
    dataset="grad-check", n_echoes=6, field=1.5, n_G_filters=8,
    downsample=8, batch_size=2,
)


def unsup_config(cfg) -> dict:
    """The UQ trainer's settings at the harness's width and batch."""
    return dict(unsup.DEFAULTS, n_G_filters=cfg["n_G_filters"],
                out_vars="PM", UQ=True, UQ_R2s=True,
                batch_size=cfg["batch_size"])


def make_loss_fn(cfg, g_fm, g_r2):
    """`loss_fn(A, te) -> loss`: the harness's loss (module docstring), the
    field-map net run without a gradient."""

    def loss_fn(A, te):
        with torch.no_grad():
            fm_mean, fm_sigma = unsup._as_mean_sigma(g_fm(A))
        a_abs = torch.sqrt(torch.sum(torch.square(A), dim=-1, keepdim=True))
        r2_mean, r2_sigma = unsup._as_mean_sigma(g_r2(a_abs))
        pm = torch.cat([fm_mean, r2_mean], dim=-1)
        wf, a_hat = cycle_full_fused(A, pm, te, cfg["field"])
        a_var = physics.acq_uncertainty(
            wf.detach(), unsup._posterior(fm_mean, fm_sigma),
            unsup._posterior(r2_mean, r2_sigma), te, field=cfg["field"])
        return var_mse(A, torch.cat([a_hat, a_var], dim=-1))

    return loss_fn


def grad_check(cfg, g_fm, g_r2, A, te) -> dict:
    """The loss and its gradient with respect to every parameter of g_r2
    ({name: tensor}, zeros where it does not reach), on the nets' device."""
    loss = make_loss_fn(cfg, g_fm, g_r2)(A, te)
    names, params = zip(*g_r2.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {"loss": loss.detach(),
            "grads": {n: torch.zeros_like(p) if g is None else g
                      for n, p, g in zip(names, params, grads)}}


def main(argv=None) -> dict:
    cfg = setup_experiment(DEFAULTS, argv,
                           settings_name="settings_gradcheck.yml")
    dev = resolve_device(cfg["device"])
    acqs, _, te = load_cohorts(cfg)
    ds, bs = cfg["downsample"], cfg["batch_size"]
    A = torch.from_numpy(acqs[:bs, :, ::ds, ::ds].copy()).to(dev)
    te = torch.from_numpy(te[:bs]).to(dev)

    g_fm, g_r2 = unsup.build_models(unsup_config(cfg))
    gen = torch.Generator().manual_seed(int(cfg["seed"]))
    for net in (g_fm, g_r2):
        net.init_params(gen)
        net.to(dev)
    res = grad_check(cfg, g_fm, g_r2, A, te)
    leaves = list(res["grads"].values())
    n_finite = sum(bool(torch.isfinite(g).all()) for g in leaves)
    g_max = max(float(g.abs().max()) for g in leaves)
    g_nonzero = sum(bool(g.abs().max() > 0) for g in leaves)
    loss = float(res["loss"])
    print(f"loss = {loss:.6f}")
    print(f"grad leaves: {len(leaves)}, finite: {n_finite}, "
          f"nonzero: {g_nonzero}, max|g| = {g_max:.3e}")
    if n_finite != len(leaves):
        raise AssertionError("non-finite gradients detected")
    if g_nonzero == 0:
        raise AssertionError("no gradient signal through the R2* path")
    print("gradient flow through Bayesian R2* + uncertainty loss: OK")
    return {"loss": loss, "max_grad": g_max,
            "grads": {n: g.cpu() for n, g in res["grads"].items()}}


if __name__ == "__main__":
    main()
