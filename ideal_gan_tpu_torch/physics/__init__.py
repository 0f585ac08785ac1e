"""IDEAL physics for the PyTorch port: species tables, TE trains, modeling
matrices and the plain-PyTorch signal operators."""

from .constants import (DTE_1p5T, DTE_3T, FATTY_ACID_9PEAK, FM_SC,
                        GYRO_HZ_PER_T, R2_SC, RHO_SC, TE1_1p5T, TE1_3T,
                        WATER_FAT_7PEAK, SpeciesModel)
from .matrix import model_matrix, pinv_normal, small_inv
from .ops import fit_rho, synthesize
from .te import te_train, te_train_for_field

__all__ = [
    "DTE_1p5T", "DTE_3T", "FATTY_ACID_9PEAK", "FM_SC", "GYRO_HZ_PER_T",
    "R2_SC", "RHO_SC", "TE1_1p5T", "TE1_3T", "WATER_FAT_7PEAK",
    "SpeciesModel", "fit_rho", "model_matrix", "pinv_normal", "small_inv",
    "synthesize", "te_train", "te_train_for_field",
]
