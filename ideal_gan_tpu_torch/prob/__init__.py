"""Map posteriors of the port's Bayesian heads."""

from .distributions import Rician

__all__ = ["Rician"]
