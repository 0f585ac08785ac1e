"""Data layer of the port (augmentation only so far)."""

from .augment import (bipolar_phase_row, random_echo_count, random_fm_scale,
                      random_geometric)

__all__ = ["bipolar_phase_row", "random_echo_count", "random_fm_scale",
           "random_geometric"]
