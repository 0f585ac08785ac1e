"""Shared training machinery (port of `ideal_gan_tpu/train/common.py`).

- `linear_decay_schedule`: constant LR until step_decay, then linear to 0.
- `SGD`: plain SGD at a constant rate (optax.sgd without momentum).
- `make_adam`: Adam with optional global-norm clipping, matching optax's
  `chain(clip_by_global_norm(c), adam(schedule, b1, b2))` step for step:
  the clip divides by the norm itself (no ε, unlike
  `torch.nn.utils.clip_grad_norm_`), and the learning rate is the schedule
  at the count before the step, as optax's `scale_by_schedule` reads it.
- `batch_iterator`: host-side shuffled batches over aligned numpy arrays.
- `ModelState`: one net, its optimizer and the step count, as checkpointed.

Not ported yet: `TrainLoop` and `accumulate_microbatch_grads` (ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch


def linear_decay_schedule(lr: float, total_steps: int,
                          step_decay: int) -> Callable[[int], float]:
    """step → learning rate, as float32."""
    if total_steps <= step_decay:
        return lambda step: float(np.float32(lr))

    def schedule(step: int) -> float:
        frac = (step - step_decay) / max(total_steps - step_decay, 1)
        return float(np.float32(lr * (1.0 - frac) if step >= step_decay
                                else lr))

    return schedule


# the profiler range around an optimizer step
STEP_RANGE = "adam step"


class Adam:
    """Adam (ε = 1e-8) over a list of parameters, with optional clipping of
    the gradients' global norm to `clip_norm`, with optax's semantics. It
    reads each parameter's `.grad` (None counts as zero) and updates the
    parameters in place."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], beta_1: float = 0.9,
                 beta_2: float = 0.9999, clip_norm: float | None = None,
                 eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.beta_1, self.beta_2 = beta_1, beta_2
        self.clip_norm = clip_norm
        self.eps = eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    @torch.profiler.record_function(STEP_RANGE)
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.clip_norm:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            keep = norm < self.clip_norm
            grads = [torch.where(keep, g, g / norm * self.clip_norm)
                     for g in grads]
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = np.float32(self.beta_1), np.float32(self.beta_2)
        bc1 = float(np.float32(1) - b1 ** np.float32(self.count))
        bc2 = float(np.float32(1) - b2 ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(self.beta_1).add_(g, alpha=1 - self.beta_1)
            v.mul_(self.beta_2).addcmul_(g, g, value=1 - self.beta_2)
            upd = (m / bc1) / ((v / bc2).sqrt() + self.eps)
            p.sub_(upd * lr)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [m.cpu() for m in self.mu],
                "nu": [v.cpu() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)


class SGD:
    """Plain SGD at a constant learning rate over a list of leaf tensors
    (optax.sgd without momentum, whose state is empty: the step count is
    kept for checkpoints only)."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float):
        self.params = list(params)
        self.lr = float(np.float32(lr))
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is not None:
                p.sub_(p.grad * self.lr)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])


def make_adam(schedule, beta_1: float = 0.9, beta_2: float = 0.9999,
              clip_norm: float | None = None) -> Callable[[Iterable], Adam]:
    """The optimizer recipe: params → `Adam` with these settings (the
    counterpart of the optax transform the JAX package builds)."""
    return lambda params: Adam(params, schedule, beta_1, beta_2, clip_norm)


def batch_iterator(arrays, batch_size: int, rng: np.random.Generator,
                   shuffle: bool = True, drop_remainder: bool = True):
    """Host-side shuffled batch iterator over aligned numpy arrays."""
    n = len(arrays[0])
    idx = rng.permutation(n) if shuffle else np.arange(n)
    stop = n - (n % batch_size) if drop_remainder else n
    for i in range(0, stop, batch_size):
        sel = idx[i:i + batch_size]
        yield tuple(a[sel] for a in arrays)


@dataclasses.dataclass
class ModelState:
    """A one-net trainer's state: the net, its optimizer and the step
    count."""
    model: torch.nn.Module
    opt: Adam
    step: int = 0

    def state_dict(self) -> dict:
        """CPU tensors and ints, for `utils.Checkpoint`."""
        return {"model": {k: v.detach().cpu()
                          for k, v in self.model.state_dict().items()},
                "opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])
        self.step = int(state["step"])
