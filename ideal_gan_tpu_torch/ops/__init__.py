"""Hand-written CUDA kernels of the port and their entry points. For CUDA
tensors the entry points launch the kernels; for CPU tensors they call the
kernels' plain PyTorch versions."""

from .convlstm import (CONVLSTM_BF16_KERNEL, CONVLSTM_BWD_BF16_KERNEL,
                       CONVLSTM_BWD_KERNEL, CONVLSTM_KERNEL,
                       convlstm_backward, convlstm_backward_reference,
                       convlstm_forward, convlstm_fused, convlstm_reference,
                       kink_masked_gradient)
from .ideal import (CYCLE_KERNEL, FIT_KERNEL, FORWARD_KERNEL, MAG_FIT_KERNEL,
                    cse_mag_fused, cycle_full_fused, cycle_fused,
                    fit_rho_fused, fit_rho_planar, precompute_cycle_matrices,
                    precompute_fit_matrices, precompute_mag_matrices,
                    precompute_synth_matrices, synthesize_fused)

KERNELS = (FIT_KERNEL, CONVLSTM_KERNEL, CYCLE_KERNEL, CONVLSTM_BWD_KERNEL,
           FORWARD_KERNEL, MAG_FIT_KERNEL, CONVLSTM_BF16_KERNEL,
           CONVLSTM_BWD_BF16_KERNEL)

__all__ = [
    "CONVLSTM_BF16_KERNEL", "CONVLSTM_BWD_BF16_KERNEL",
    "CONVLSTM_BWD_KERNEL", "CONVLSTM_KERNEL", "CYCLE_KERNEL", "FIT_KERNEL",
    "FORWARD_KERNEL", "KERNELS", "MAG_FIT_KERNEL", "convlstm_backward",
    "convlstm_backward_reference", "convlstm_forward", "convlstm_fused",
    "convlstm_reference", "cse_mag_fused", "cycle_full_fused", "cycle_fused",
    "fit_rho_fused", "fit_rho_planar", "kink_masked_gradient",
    "precompute_cycle_matrices",
    "precompute_fit_matrices", "precompute_mag_matrices",
    "precompute_synth_matrices", "synthesize_fused",
]
