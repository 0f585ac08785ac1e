"""Shared training machinery (port of `ideal_gan_tpu/train/common.py`).

- `linear_decay_schedule`: constant LR until step_decay, then linear to 0.
- `SGD`: plain SGD at a constant rate (optax.sgd without momentum).
- `make_adam`: Adam with optional global-norm clipping, matching optax's
  `chain(clip_by_global_norm(c), adam(schedule, b1, b2))` step for step:
  the clip divides by the norm itself (no ε, unlike
  `torch.nn.utils.clip_grad_norm_`), and the learning rate is the schedule
  at the count before the step, as optax's `scale_by_schedule` reads it.
  On a data mesh (`parallel.mesh`) both optimizers average the gradients
  over the ranks before anything else, the clip included: optax clips the
  global gradient, and clipping each rank's share would differ.
- `batch_iterator`: host-side shuffled batches over aligned numpy arrays.
- `ModelState`: one net, its optimizer and the step count, as checkpointed.
- `accumulate_microbatch_grads`: a step's gradients over equal chunks of
  its batch, accumulated in float32 and averaged (on a mesh: chunks of the
  rank's rows, the ranks averaged by the optimizer).
- `compute_dtype`: a trainer config's CNN compute dtype (`bf16`).
- `RunRecord`: a run's checkpoints, resume, summaries every 20 steps and
  preemption guard, the one owner of that policy for the trainer CLIs and
  `TrainLoop`; on a mesh rank 0 writes, every rank resumes and a signal to
  any rank stops them all.
- `TrainLoop`: the epoch skeleton on a `RunRecord`: resume from the newest
  checkpoint, steps with a dict summary every 20 steps, checkpoints every
  `epoch_ckpt` epochs and at the end. The batches go to its `device`, or
  with a `mesh` each rank's rows to its device, as the JAX loop shards
  them over its data mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from ..parallel.mesh import (Mesh, all_reduce_grads, any_rank,
                             reduce_metrics, shard_batch)
from ..utils import Checkpoint, DictSummaryWriter
from ..utils.preempt import PreemptionGuard


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
# the profiler range around `batch_iterator`'s gather of one batch
GATHER_RANGE = "batch gather"


def compute_dtype(cfg):
    """The nets' compute dtype of a trainer config: bfloat16 with `bf16`
    (parameters stay float32, the physics runs in float32), else None, the
    parameters' own dtype."""
    return torch.bfloat16 if cfg.get("bf16") else None


def accumulate_microbatch_grads(loss_fn, params, batch, micro: int):
    """A step's loss, metrics and gradients over `nb // micro` equal chunks
    of its batch (the JAX package's `accumulate_microbatch_grads`).

    `loss_fn(*chunk) -> (loss, metrics)` is called on each chunk in order,
    rows [i·micro, (i+1)·micro) of every tensor of `batch` (None entries
    pass through), and its loss is backpropagated at once, so that only
    one chunk's activations are alive; a chunk that needs noise draws its
    own inside `loss_fn`, as the JAX step splits its key per chunk. The
    gradients add up in the float32 `.grad` of `params` and are scaled by
    1/n_chunks, as are the returned loss and metrics (detached). Batch-sum
    terms of the loss must carry the chunk count themselves (the trainers'
    `tv_scale`), times the data size on a mesh, where `batch` is the rank's
    rows and the optimizer averages the ranks. A batch that `micro` does
    not divide raises ValueError."""
    nb = next(t for t in batch if t is not None).shape[0]
    if micro <= 0 or nb % micro:
        raise ValueError(f"batch {nb} not divisible by microbatch {micro}")
    n_chunks = nb // micro
    loss_sum, metrics_sum = 0.0, {}
    for i in range(n_chunks):
        rows = slice(i * micro, (i + 1) * micro)
        loss, metrics = loss_fn(*(None if t is None else t[rows]
                                  for t in batch))
        loss.backward()
        loss_sum = loss_sum + loss.detach()
        for k, v in metrics.items():
            metrics_sum[k] = metrics_sum.get(k, 0.0) + v.detach()
    inv = 1.0 / n_chunks
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.grad.mul_(inv)
    return loss_sum * inv, {k: v * inv for k, v in metrics_sum.items()}


class Adam:
    """Adam (ε = 1e-8) over a list of parameters, with optional clipping of
    the gradients' global norm to `clip_norm`, with optax's semantics. It
    reads each parameter's `.grad` (None counts as zero) and updates the
    parameters in place. With a `mesh` the gradients are first averaged
    over its ranks (`all_reduce_grads`, written back to `.grad`)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], beta_1: float = 0.9,
                 beta_2: float = 0.9999, clip_norm: float | None = None,
                 eps: float = 1e-8, mesh: Mesh | None = None):
        self.params = list(params)
        self.mesh = mesh
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
        all_reduce_grads(self.params, self.mesh)
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
    kept for checkpoints only). With a `mesh` the gradients are first
    averaged over its ranks."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 mesh: Mesh | None = None):
        self.params = list(params)
        self.mesh = mesh
        self.lr = float(np.float32(lr))
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        all_reduce_grads(self.params, self.mesh)
        for p in self.params:
            if p.grad is not None:
                p.sub_(p.grad * self.lr)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])


def make_adam(schedule, beta_1: float = 0.9, beta_2: float = 0.9999,
              clip_norm: float | None = None,
              mesh: Mesh | None = None) -> Callable[[Iterable], Adam]:
    """The optimizer recipe: params → `Adam` with these settings (the
    counterpart of the optax transform the JAX package builds), averaging
    the gradients over `mesh`'s ranks."""
    return lambda params: Adam(params, schedule, beta_1, beta_2, clip_norm,
                               mesh=mesh)


def batch_iterator(arrays, batch_size: int, rng: np.random.Generator,
                   shuffle: bool = True, drop_remainder: bool = True):
    """Host-side shuffled batch iterator over aligned numpy arrays. Each
    batch's gather is the profiler range `GATHER_RANGE`, closed before the
    batch is yielded."""
    n = len(arrays[0])
    idx = rng.permutation(n) if shuffle else np.arange(n)
    stop = n - (n % batch_size) if drop_remainder else n
    for i in range(0, stop, batch_size):
        sel = idx[i:i + batch_size]
        with torch.profiler.record_function(GATHER_RANGE):
            batch = tuple(a[sel] for a in arrays)
        yield batch


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


def metrics_to_host(metrics: Mapping, mesh: Mesh | None = None) -> dict:
    """A step's metrics as host numpy arrays (one synchronisation with the
    card), the counterpart of `jax.device_get`: called only where a summary
    is written, so the steps between stay free of host syncs. On a mesh
    they are first averaged over its ranks (`reduce_metrics`: every rank
    calls it), so that they equal the one-process run's."""
    metrics = reduce_metrics(dict(metrics), mesh)
    return {k: v.detach().float().cpu().numpy()
            if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in metrics.items()}


class RunRecord:
    """A trainer run's record, as the JAX trainer CLIs keep it: checkpoints
    under <output_dir>/checkpoints (resumed from the newest, with "resumed
    from epoch N"), the `G_losses` summaries under summaries/train every
    `summary_every` global steps (host floats only on those steps),
    with `val` a validation writer under summaries/validation, and the
    preemption guard. The global step count starts at
    `start · steps_per_epoch`. `ckpt_dir`, `summary_dir` and `summary_name`
    put the checkpoints and the train summaries elsewhere (the LDM CLI's
    layout). `close()` restores the signal handlers and closes the event
    files.

    On a `mesh` (`parallel.mesh`) every rank resumes from the same newest
    checkpoint and averages the summary steps' metrics over the ranks, and
    rank 0 alone writes summaries and checkpoints and prints (`log`); the
    preemption decision is the or of every rank's signal, so that no rank
    stops while another waits in a collective."""

    def __init__(self, cfg, state, steps_per_epoch: int,
                 summary_every: int = 20, val: bool = False,
                 ckpt_dir: str | None = None, summary_dir: str | None = None,
                 summary_name: str = "G_losses", mesh: Mesh | None = None):
        out = cfg["output_dir"]
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.ckpt = Checkpoint(ckpt_dir or f"{out}/checkpoints")
        self.writer = self.val_writer = None
        if self.is_main:
            self.writer = DictSummaryWriter(summary_dir
                                            or f"{out}/summaries/train")
            if val:
                self.val_writer = DictSummaryWriter(
                    f"{out}/summaries/validation")
        self.summary_name = summary_name
        self.start = self.ckpt.latest_step() or 0
        if self.start:
            state.load_state_dict(self.ckpt.restore(self.start))
            self.log(f"resumed from epoch {self.start}")
        self.gstep = self.start * steps_per_epoch
        self.summary_every = summary_every
        self.epochs = cfg["epochs"]
        self.epoch_ckpt = cfg["epoch_ckpt"]
        self.guard = PreemptionGuard()

    def log(self, msg: str) -> None:
        """Print `msg` on rank 0."""
        if self.is_main:
            print(msg)

    def step(self, metrics) -> None:
        """Count one global step; write its metrics every `summary_every`."""
        self.gstep += 1
        if self.gstep % self.summary_every == 0:
            host = metrics_to_host(metrics, self.mesh)
            if self.writer is not None:
                self.writer.write(host, self.gstep, name=self.summary_name)

    def validation(self, metrics) -> None:
        host = metrics_to_host(metrics, self.mesh)
        if self.val_writer is not None:
            self.val_writer.write(host, self.gstep, name="G_losses")

    def save(self, step: int, state) -> None:
        """Checkpoint `state` at `step` (rank 0)."""
        if self.is_main:
            self.ckpt.save(step, state.state_dict())

    def end_epoch(self, ep: int, state) -> bool:
        """Checkpoint at `epoch_ckpt` epochs, at the last one and on a
        preemption signal to any rank; True (after "preempted: checkpointed
        epoch N, exiting") when the run must stop."""
        stop = any_rank(self.guard.should_stop, self.mesh)
        if (ep + 1) % self.epoch_ckpt == 0 or ep + 1 == self.epochs or stop:
            self.save(ep + 1, state)
        if stop:
            self.log(f"preempted: checkpointed epoch {ep + 1}, exiting")
        return stop

    def close(self) -> None:
        self.guard.restore()
        for w in (self.writer, self.val_writer):
            if w is not None:
                w.close()


@dataclasses.dataclass
class TrainLoop:
    """Epoch loop: resume → (step → summaries) → periodic checkpoint
    (port of the JAX package's `TrainLoop`), kept by a `RunRecord`, so a
    preemption signal also checkpoints the epoch and ends the run, as in
    the trainer CLIs.

    `step_fn(state, batch) -> (state, metrics)`; `state` has
    `state_dict()` (CPU tensors, for `utils.Checkpoint`) and
    `load_state_dict()`. A step that needs noise closes over its own
    generator (the JAX loop hands each step a split key). With a `mesh`
    each batch is the global one and the step gets the rank's rows
    (`shard_batch`), on the mesh's device. `record` is the last run's.
    """

    step_fn: Callable
    output_dir: str
    epoch_ckpt: int = 10
    device: str | torch.device = "cuda"
    mesh: Mesh | None = None

    def run(self, state, epochs: int, batches_fn: Callable[[], Iterable],
            hooks: Mapping[str, Callable] | None = None):
        """`batches_fn()` yields one epoch's batches (tuples of numpy arrays
        or tensors); hooks: {'on_epoch_end': fn(epoch, state)}. The global
        step count starts at 0 in every run, resumed or not, as in the JAX
        loop (a `RunRecord` of 0 steps an epoch)."""
        hooks = hooks or {}
        self.record = RunRecord(
            dict(output_dir=self.output_dir, epochs=epochs,
                 epoch_ckpt=self.epoch_ckpt), state, 0, mesh=self.mesh)
        try:
            for ep in range(self.record.start, epochs):
                for batch in batches_fn():
                    if self.mesh is not None:
                        batch = shard_batch(tuple(batch), self.mesh)
                    else:
                        batch = tuple(torch.as_tensor(x).to(self.device)
                                      for x in batch)
                    state, metrics = self.step_fn(state, batch)
                    self.record.step(metrics)
                if "on_epoch_end" in hooks:
                    hooks["on_epoch_end"](ep, state)
                if self.record.end_epoch(ep, state):
                    break
        finally:
            self.record.close()
        return state
