"""IDEAL physics for the PyTorch port: species tables, TE trains, modeling
matrices, the plain-PyTorch signal operators, the fatty-acid model and
the first-order uncertainty propagation."""

from .constants import (DTE_1p5T, DTE_3T, FATTY_ACID_9PEAK, FM_SC,
                        GYRO_HZ_PER_T, R2_SC, RHO_SC, TE1_1p5T, TE1_3T,
                        WATER_FAT_7PEAK, SpeciesModel)
from .fa import fa_cycle, fa_forward, fa_get_rho
from .matrix import (eigenvals_2x2, mag_design_matrix, model_matrix,
                     null_projector, phase_constraint_matrix, pinv_normal,
                     small_inv)
from .ops import (CSEMagResult, cse_mag_fit, cycle, cycle_full, fit_rho,
                  mag_cycle, mag_demod, synthesize, synthesize_mag,
                  synthesize_mag_phase)
from .te import sample_te_train, te_train, te_train_for_field
from .uncertainty import Posterior, acq_uncertainty, pdff_uncertainty

__all__ = [
    "DTE_1p5T", "DTE_3T", "FATTY_ACID_9PEAK", "FM_SC", "GYRO_HZ_PER_T",
    "R2_SC", "RHO_SC", "TE1_1p5T", "TE1_3T", "WATER_FAT_7PEAK",
    "CSEMagResult", "Posterior", "SpeciesModel", "acq_uncertainty",
    "cse_mag_fit", "cycle", "cycle_full", "eigenvals_2x2", "fit_rho",
    "mag_cycle", "mag_demod", "mag_design_matrix", "model_matrix",
    "null_projector", "pdff_uncertainty", "phase_constraint_matrix",
    "pinv_normal", "sample_te_train", "small_inv", "synthesize",
    "synthesize_mag", "synthesize_mag_phase", "te_train",
    "te_train_for_field", "fa_cycle", "fa_forward", "fa_get_rho",
]
