"""ideal_gan_tpu_torch — the PyTorch / CUDA port of ideal_gan_tpu.

The package runs on an NVIDIA Hopper card (H100): plain tensor code is
PyTorch, and every kernel the JAX package wrote in Pallas for the TPU gets a
hand-written CUDA kernel here (`csrc/`, built with nvcc on first use).
It imports neither JAX nor `ideal_gan_tpu`. Entry points take a `device`
argument that defaults to "cuda" and raise when no card is present; CPU
tensors run the kernels' plain PyTorch versions.

Ported so far: the AI-DEAL serving slice — physics (species tables, TE
trains, model matrices, synthesis and the map fit), the map-fit and
ConvLSTM-forward kernels, the UNet model stack, the Flax weight converter
and the `cli.infer` entry point. See ROADMAP.md for what is queued.
"""

__version__ = "0.1.0"
