"""Hand-written CUDA kernels of the port and their entry points. For CUDA
tensors the entry points launch the kernels; for CPU tensors they call the
kernels' plain PyTorch versions."""

from .convlstm import CONVLSTM_KERNEL, convlstm_forward, convlstm_reference
from .ideal import (FIT_KERNEL, fit_rho_fused, fit_rho_planar,
                    precompute_fit_matrices)

KERNELS = (FIT_KERNEL, CONVLSTM_KERNEL)

__all__ = [
    "CONVLSTM_KERNEL", "FIT_KERNEL", "KERNELS", "convlstm_forward",
    "convlstm_reference", "fit_rho_fused", "fit_rho_planar",
    "precompute_fit_matrices",
]
