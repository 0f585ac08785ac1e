"""Data layer of the port (augmentation only so far)."""

from .augment import random_echo_count, random_geometric

__all__ = ["random_echo_count", "random_geometric"]
