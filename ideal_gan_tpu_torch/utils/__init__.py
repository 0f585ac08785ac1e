"""Utilities of the port."""

from .checkpoint import Checkpoint

__all__ = ["Checkpoint"]
