"""The reference's precision: float32 with TF32 off in cuDNN's
convolutions and in matmuls, restored afterwards."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev
