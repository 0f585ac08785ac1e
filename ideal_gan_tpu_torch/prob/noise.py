"""Noise sources of the port's stochastic layers and penalties (the Flipout
convolutions, `Rician.sample`, the gradient penalty's interpolation).

A noise source has three draws, each given the shape in the JAX package's
layout and a tensor whose dtype and device the draw takes:
`normal(shape, like)` ~ N(0, 1), `rademacher(shape, like)` ±1 with
probability ½ each, and `uniform(shape, like)` ~ U[0, 1). `GeneratorNoise`
draws them from a `torch.Generator` (on `like`'s device), `Replay` hands
out given arrays in call order, so that a run can take the draws another
one made (the CPU tests replay the JAX package's, whose `jax.random`
streams PyTorch cannot reproduce). Every callee accepts a
`torch.Generator` where it takes a source (`as_noise`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class GeneratorNoise:
    """Draws from a `torch.Generator`, which must live on the device of the
    tensors it is asked to draw like."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def normal(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           dtype=like.dtype, device=like.device)

    def rademacher(self, shape, like: torch.Tensor) -> torch.Tensor:
        bits = torch.randint(0, 2, tuple(shape), generator=self.generator,
                             device=like.device)
        return (2 * bits - 1).to(like.dtype)

    def uniform(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          dtype=like.dtype, device=like.device)


class Replay:
    """Given draws handed out in call order: `draws` is a sequence of
    (kind, array) with kind "normal", "rademacher" or "uniform". A call whose
    kind or shape is not the next draw's raises, and so does a call past
    the last; `remaining` counts the draws not yet taken."""

    def __init__(self, draws: Sequence[tuple[str, np.ndarray]]):
        self._draws = list(draws)
        self._next = 0

    @property
    def remaining(self) -> int:
        return len(self._draws) - self._next

    def _take(self, kind: str, shape, like: torch.Tensor) -> torch.Tensor:
        if self._next >= len(self._draws):
            raise IndexError(f"no draw left for a {kind} draw of {shape}")
        got_kind, arr = self._draws[self._next]
        arr = np.array(arr)  # a writable copy
        if got_kind != kind or tuple(arr.shape) != tuple(shape):
            raise ValueError(f"draw {self._next} is {got_kind} "
                             f"{tuple(arr.shape)}, asked for {kind} "
                             f"{tuple(shape)}")
        self._next += 1
        return torch.as_tensor(arr).to(dtype=like.dtype, device=like.device)

    def normal(self, shape, like: torch.Tensor) -> torch.Tensor:
        return self._take("normal", shape, like)

    def rademacher(self, shape, like: torch.Tensor) -> torch.Tensor:
        return self._take("rademacher", shape, like)

    def uniform(self, shape, like: torch.Tensor) -> torch.Tensor:
        return self._take("uniform", shape, like)


def as_noise(source):
    """A noise source from `source`: a `torch.Generator` is wrapped in
    `GeneratorNoise`, a source is returned as it is, None raises."""
    if source is None:
        raise ValueError("a stochastic call needs a noise source (a "
                         "torch.Generator or a prob.noise source)")
    if isinstance(source, torch.Generator):
        return GeneratorNoise(source)
    return source
