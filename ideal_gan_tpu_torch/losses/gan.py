"""Adversarial losses and the R1 penalty (port of
`ideal_gan_tpu/losses/gan.py`'s `adversarial_losses` and
`r1_regularization`; `gradient_penalty` has no caller on a ported path).

`adversarial_losses(mode)` returns (d_loss_fn, g_loss_fn) over logits for
mode ∈ {gan, hinge_v1, hinge_v2, lsgan, wgan}. The R1 penalty takes the
critic as a function of images and differentiates it twice: its gradient
with respect to the images is built with `create_graph=True`, so that the
penalty's own gradient reaches the critic's parameters.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _bce_logits(labels, logits):
    """Stable sigmoid cross-entropy, mean-reduced."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def adversarial_losses(mode: str) -> Tuple[Callable, Callable]:
    if mode == "gan":
        def d_loss_fn(r_logit, f_logit):
            return (_bce_logits(torch.ones_like(r_logit), r_logit),
                    _bce_logits(torch.zeros_like(f_logit), f_logit))

        def g_loss_fn(f_logit):
            return _bce_logits(torch.ones_like(f_logit), f_logit)
    elif mode in ("hinge_v1", "hinge_v2"):
        def d_loss_fn(r_logit, f_logit):
            return (torch.mean(torch.clamp(1.0 - r_logit, min=0.0)),
                    torch.mean(torch.clamp(1.0 + f_logit, min=0.0)))

        if mode == "hinge_v1":
            def g_loss_fn(f_logit):
                return torch.mean(torch.clamp(1.0 - f_logit, min=0.0))
        else:
            def g_loss_fn(f_logit):
                return torch.mean(-f_logit)
    elif mode == "lsgan":
        def d_loss_fn(r_logit, f_logit):
            return (torch.mean(torch.square(r_logit - 1.0)),
                    torch.mean(torch.square(f_logit)))

        def g_loss_fn(f_logit):
            return torch.mean(torch.square(f_logit - 1.0))
    elif mode == "wgan":
        def d_loss_fn(r_logit, f_logit):
            return -torch.mean(r_logit), torch.mean(f_logit)

        def g_loss_fn(f_logit):
            return -torch.mean(f_logit)
    else:
        raise ValueError(f"unknown adversarial mode {mode!r}")
    return d_loss_fn, g_loss_fn


def r1_regularization(critic: Callable, real: torch.Tensor) -> torch.Tensor:
    """R1 = E[‖∇ₓ D(x)‖²] on the real samples, differentiable with respect
    to the critic's parameters (a double backward)."""
    x = real.detach().requires_grad_()
    grad, = torch.autograd.grad(torch.sum(critic(x)), x, create_graph=True)
    return torch.mean(torch.sum(torch.square(grad.reshape(grad.shape[0], -1)),
                                dim=1))
