"""Adversarial losses and the gradient penalties (port of
`ideal_gan_tpu/losses/gan.py`).

`adversarial_losses(mode)` returns (d_loss_fn, g_loss_fn) over logits for
mode ∈ {gan, hinge_v1, hinge_v2, lsgan, wgan}. The penalties (WGAN-GP and
DRAGAN in `gradient_penalty`, R1) take the critic as a function of images
and differentiate it twice: its gradient with respect to the images is
built with `create_graph=True`, so that the penalty's own gradient reaches
the critic's parameters.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..prob.noise import as_noise


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


def gradient_penalty(critic: Callable, real: torch.Tensor,
                     fake: torch.Tensor | None, mode: str,
                     noise=None) -> torch.Tensor:
    """The interpolated gradient penalty E[(‖∇ₓ D(x̂)‖ − 1)²] with the norm
    √(Σ g² + 1e-12) per sample, x̂ = real + α·(fake − real), α ~ U[0, 1)
    of shape (nb, 1, …, 1). mode "wgan-gp" interpolates towards `fake`,
    "dragan" towards real + ½·std(real)·β (the population std over every
    element, β ~ U[0, 1) of real's shape; `fake` is not read), "none" is
    0. The draws come from `noise` (a `torch.Generator` on real's device or
    a `prob.noise` source), β before α as in the JAX package. The penalty
    is differentiable with respect to the critic's parameters and, through
    x̂, to real and fake where they carry a gradient."""
    if mode == "none":
        return torch.zeros((), dtype=real.dtype, device=real.device)
    if mode not in ("wgan-gp", "dragan"):
        raise ValueError(f"unknown gp mode {mode!r}")
    src = as_noise(noise)
    if mode == "dragan":
        beta = src.uniform(real.shape, real)
        fake = real + 0.5 * torch.std(real, correction=0) * beta
    alpha = src.uniform((real.shape[0],) + (1,) * (real.ndim - 1), real)
    inter = real + alpha * (fake - real)
    if not inter.requires_grad:
        inter = inter.detach().requires_grad_()
    grad, = torch.autograd.grad(torch.sum(critic(inter)), inter,
                                create_graph=True)
    norm = torch.sqrt(torch.sum(torch.square(grad.reshape(grad.shape[0], -1)),
                                dim=1) + 1e-12)
    return torch.mean(torch.square(norm - 1.0))


def r1_regularization(critic: Callable, real: torch.Tensor) -> torch.Tensor:
    """R1 = E[‖∇ₓ D(x)‖²] on the real samples, differentiable with respect
    to the critic's parameters (a double backward)."""
    x = real.detach().requires_grad_()
    grad, = torch.autograd.grad(torch.sum(critic(x)), x, create_graph=True)
    return torch.mean(torch.sum(torch.square(grad.reshape(grad.shape[0], -1)),
                                dim=1))
