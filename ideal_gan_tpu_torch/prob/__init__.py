"""Map posteriors of the port's Bayesian heads, and the noise sources of its
stochastic layers."""

from .distributions import Normal, Rician, softplus_lb
from .noise import GeneratorNoise, Replay, as_noise

__all__ = ["GeneratorNoise", "Normal", "Replay", "Rician", "as_noise",
           "softplus_lb"]
