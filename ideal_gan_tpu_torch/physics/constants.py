"""Multi-peak fat spectrum constants and map normalization scales.

PyTorch-port copy of `ideal_gan_tpu/physics/constants.py` (pure data, no
framework): the 7-peak water/fat spectrum, the 9-peak fatty-acid spectrum,
the proton gyromagnetic ratio, the reference TE protocols, and the fixed
normalization constants (fm_sc, r2_sc, rho_sc) that every map is divided by.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Proton gyromagnetic ratio (Hz/T), as used by the reference (42.58 MHz/T).
GYRO_HZ_PER_T = 42.58e6

# Map normalization scales.
FM_SC = 300.0   # field-map scale, Hz
R2_SC = 200.0   # R2* scale, 1/s
RHO_SC = 1.4    # water/fat magnitude scale

# Reference TE protocols.
TE1_1p5T = 1.3e-3
DTE_1p5T = 2.1e-3
TE1_3T = 0.879e-3
DTE_3T = 0.6623e-3


@dataclasses.dataclass(frozen=True)
class SpeciesModel:
    """A chemical-species signal model.

    freqs_ppm : (n_peaks,) chemical shifts in ppm (water = 0).
    amps      : (n_peaks, n_species) relative amplitude of each peak in each
                species column.
    r2_peak   : optional (n_peaks,) per-peak R2 (1/s) folded into the
                complex frequency; None means no per-peak decay.
    names     : species names, for reporting.
    """

    freqs_ppm: tuple
    amps: tuple
    r2_peak: tuple | None
    names: tuple

    @property
    def n_species(self) -> int:
        return len(self.names)

    @property
    def n_peaks(self) -> int:
        return len(self.freqs_ppm)

    def freqs_hz(self, field: float) -> np.ndarray:
        """Peak frequencies in Hz at the given field strength (T)."""
        return np.asarray(self.freqs_ppm, np.float64) * 1e-6 * GYRO_HZ_PER_T * field

    def amps_matrix(self) -> np.ndarray:
        """(n_peaks, n_species) float64 amplitude matrix."""
        return np.asarray(self.amps, np.float64)

    def r2_peak_vec(self) -> np.ndarray | None:
        if self.r2_peak is None:
            return None
        return np.asarray(self.r2_peak, np.float64)


# 7-peak water/fat model.
WATER_FAT_7PEAK = SpeciesModel(
    freqs_ppm=(0.0, -3.80, -3.40, -2.60, -1.94, -0.39, 0.60),
    amps=(
        (1.0, 0.0),
        (0.0, 0.087),
        (0.0, 0.693),
        (0.0, 0.128),
        (0.0, 0.004),
        (0.0, 0.039),
        (0.0, 0.048),
    ),
    r2_peak=None,
    names=("water", "fat"),
)

# 9-peak, 5-species fatty-acid model (per-peak decay taken verbatim from the
# reference's t2_p array, used as a rate).
FATTY_ACID_9PEAK = SpeciesModel(
    freqs_ppm=(0.0, 0.47, -0.64, -2.09, -2.60, -2.82, -3.23, -3.54, -3.95),
    amps=(
        # water  fat  ndb nmidb  cl
        (1.0,   0.0,  0.0,  0.0, 0.0),
        (0.0,   1.0,  2.0,  0.0, 0.0),
        (0.0,   4.0,  0.0,  0.0, 0.0),
        (0.0,   0.0,  0.0,  2.0, 0.0),
        (0.0,   6.0,  0.0,  0.0, 0.0),
        (0.0,   0.0,  4.0, -4.0, 0.0),
        (0.0,   6.0,  0.0,  0.0, 0.0),
        (0.0, -24.0, -8.0,  2.0, 6.0),
        (0.0,   9.0,  0.0,  0.0, 0.0),
    ),
    r2_peak=(0.022, 0.044, 0.055, 0.046, 0.052, 0.052, 0.055, 0.055, 0.080),
    names=("water", "fat", "ndb", "nmidb", "cl"),
)
