"""Flipout variational convolution (port of `ideal_gan_tpu/models/bayes.py`).

A mean-field Gaussian posterior over the kernel, N(μ, σ²) with σ = exp(log
σ), and the Flipout estimator of its perturbation (Wen et al. 2018): one
extra convolution of the input under per-example random signs,
conv(x·s_in, σ·ε)·s_out, added to conv(x, μ). NCHW inside; the draws are
asked for in the JAX package's layouts (ε (kh, kw, Cin, Cout), the signs
(nb, 1, 1, C)) and in its order (ε, s_in, s_out), so that a `prob.Replay`
of the JAX draws gives the JAX layer's output.

The JAX layer sows its KL(q ‖ N(0, 1)) into the `losses` collection, which
its trainers sum into the objective; here it is `FlipoutConv.kl()`, and
`kl_sum(module)` sums it over every Flipout convolution of a module tree.
"""

from __future__ import annotations

import torch
from torch import nn

from ..prob.noise import as_noise
from .blocks import get_activation, he_normal_, same_conv2d


class FlipoutConv(nn.Module):
    """A "SAME" convolution of `features` outputs with a Gaussian posterior
    over its kernel (he_normal μ, log σ = −3, zero bias), then
    `activation` (`blocks.get_activation`: leaky_relu with slope 0.2)."""

    def __init__(self, in_channels: int, features: int, kernel_size=(3, 3),
                 strides: int = 1, activation: str | None = None):
        super().__init__()
        kh, kw = kernel_size
        self.strides = strides
        self.activation = activation
        self.kernel_mean = nn.Parameter(
            torch.empty(features, in_channels, kh, kw))
        self.kernel_log_sigma = nn.Parameter(
            torch.full((features, in_channels, kh, kw), -3.0))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, deterministic: bool = False, noise=None):
        """x (nb, Cin, H, W) → (nb, features, H', W'). Stochastic unless
        `deterministic`, with the draws from `noise` (a `torch.Generator`
        on x's device or a `prob.noise` source)."""
        out = same_conv2d(x, self.kernel_mean, None, self.strides)
        if not deterministic:
            src = as_noise(noise)
            cout, cin, kh, kw = self.kernel_mean.shape
            eps = src.normal((kh, kw, cin, cout), x).permute(3, 2, 0, 1)
            sign_in = src.rademacher((x.shape[0], 1, 1, cin), x)
            sign_out = src.rademacher((x.shape[0], 1, 1, cout), x)
            delta = torch.exp(self.kernel_log_sigma) * eps
            out = out + same_conv2d(x * sign_in.permute(0, 3, 1, 2), delta,
                                    None, self.strides) \
                * sign_out.permute(0, 3, 1, 2)
        out = out + self.bias[:, None, None]
        return get_activation(self.activation)(out)

    def kl(self) -> torch.Tensor:
        """KL(N(μ, σ²) ‖ N(0, 1)) summed over the kernel:
        ½·Σ(μ² + σ² − 2 log σ − 1)."""
        log_sigma = self.kernel_log_sigma
        return 0.5 * torch.sum(torch.square(self.kernel_mean)
                               + torch.exp(2.0 * log_sigma)
                               - 2.0 * log_sigma - 1.0)

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            he_normal_(self.kernel_mean, self.kernel_mean[0].numel(),
                       generator)
            self.kernel_log_sigma.fill_(-3.0)
            self.bias.zero_()


def kl_sum(module: nn.Module) -> torch.Tensor:
    """The sum of `kl()` over every `FlipoutConv` in `module`'s tree (0 where
    there is none): the JAX trainers' sum of the `losses` collection."""
    kls = [m.kl() for m in module.modules() if isinstance(m, FlipoutConv)]
    if not kls:
        return torch.zeros(())
    return torch.stack(kls).sum()
