"""Map posteriors of the port's Bayesian heads."""

from .distributions import Normal, Rician, softplus_lb

__all__ = ["Normal", "Rician", "softplus_lb"]
