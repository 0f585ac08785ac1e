"""Training traffic: the program's training step back to back, fed as the
trainer CLI's loop body feeds it (shuffled epochs of the in-memory cohort
by `train.common.batch_iterator`, the host augmentation, the family's TE
sampling, the host-to-card copy).

The traffic file gives `trace_steps`, the steps of the traced
sub-window, and `check_steps`, the first steps the reference follows.
The configuration gives the cohort (`cohort_slices` synthetic slices at
the field's reference TE train) and the batch.

Set-up builds the program's state once, drives it through the first
`check_steps` steps (the first is the warm-up) and keeps, of them, each
step's losses, each net's output in the first step (by a forward hook),
the first gradient as the optimizer received it (from Adam's first moment
after one step) and the parameters' change after the first step and after
the last; then the window runs the same state on. `attempted` counts the
window's steps, `failed` those whose loss is not finite.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import compare, synth, weights as wmod
from ..reference import precision
from ..reference import train as ref_train
from ..trace import profiled
from .serve_volumes import TE_FIELD, reference_nets

TRAINS = True
STEP_RANGES = ("adam step",)


@dataclass
class State:
    env: object
    trainer: object = None
    cohort: tuple = ()
    batches: object = None
    rng: object = None
    gen: object = None
    readings: dict = field(default_factory=dict)
    host_s: float = 0.0


def _batches(state):
    from ideal_gan_tpu_torch.train.common import batch_iterator
    bs = state.env.cfg["batch_size"]
    while True:
        yield from batch_iterator(state.cohort, bs, state.rng)


def _leaves(trainer):
    """{leaf: (parameter, optimizer, index)} of every trained leaf."""
    out = {}
    for net, module in trainer.nets.items():
        opt = trainer.opts[net]
        index = {id(p): i for i, p in enumerate(opt.params)}
        for name, p in module.named_parameters():
            if id(p) in index:
                out[f"{net}.{name}"] = (p, opt, index[id(p)])
    return out


# planted faults that leave leaves unchanged: all of them, or the TE
# encoders' (VET-Net's `encoder.te.*`)
FROZEN = {"frozen_state": "", "frozen_te": ".encoder.te."}


def _step(state):
    """One loop body: the host work (timed), the copy, the step."""
    t0 = time.perf_counter()
    rows = next(state.batches)
    batch = state.trainer.prepare(rows, state.rng, state.gen)
    state.host_s += time.perf_counter() - t0
    batch = state.trainer.place(batch)
    if "half_batch" in state.env.faults:
        batch = tuple(t[: len(t) // 2] for t in batch)
    frozen = [FROZEN[f] for f in state.env.faults if f in FROZEN]
    if frozen:
        keep = {k: p.detach().clone()
                for k, (p, _, _) in _leaves(state.trainer).items()
                if frozen[0] in k}
        losses = state.trainer.step(batch)
        with torch.no_grad():
            for k, (p, _, _) in _leaves(state.trainer).items():
                if k in keep:
                    p.copy_(keep[k])
        return losses
    return state.trainer.step(batch)


def _first_outputs(nets: dict):
    """({net: its first output, on the host}, hook handles to remove)."""
    outputs, handles = {}, []
    for name, module in nets.items():
        def hook(_module, _args, out, name=name):
            if name not in outputs:
                outputs[name] = out.detach().float().cpu()
        handles.append(module.register_forward_hook(hook))
    return outputs, handles


def cohort_arrays(env):
    """(maps, acqs, te) of the cohort, as numpy."""
    cfg, dev = env.cfg, env.device
    gen = torch.Generator(device=dev).manual_seed(env.seeds["inputs"])
    maps = synth.maps(gen, cfg["cohort_slices"], cfg["data_size"], dev)
    te = synth.te_train(cfg["n_echoes"], *TE_FIELD[cfg["field"]], dev)
    acqs = synth.acquisitions(maps, te, cfg["field"])
    te = te.expand(len(maps), -1, -1).contiguous()
    return synth.host(maps), synth.host(acqs), synth.host(te)


def setup(env, bf16=False) -> State:
    cfg, dev = env.cfg, env.device
    state = State(env)
    with torch.device("meta"):
        spec = env.family.reference_nets(cfg)
    w = wmod.make(spec, env.seeds["weights"], dev)
    state.trainer = env.family.Trainer(cfg, w, dev, bf16=bf16,
                                       noise_seed=env.seeds["noise"])
    del w
    env.stage("weights and the trainer's state")
    state.cohort = env.family.cohort(cfg, *cohort_arrays(env))
    env.stage("the cohort, on the host")
    state.rng = np.random.default_rng(env.seeds["feed_np"])
    state.gen = torch.Generator().manual_seed(env.seeds["feed_torch"])
    state.batches = _batches(state)
    leaves = _leaves(state.trainer)
    start = {k: p.detach().clone() for k, (p, _, _) in leaves.items()}

    def change():
        return {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
                for k, (p, _, _) in leaves.items()}

    r = state.readings = {"losses": []}
    outputs, hooks = _first_outputs(state.trainer.nets)
    for i in range(env.traffic["check_steps"]):
        r["losses"].append([float(x) for x in _step(state)])
        if i == 0:
            for h in hooks:
                h.remove()
            r["outputs"] = outputs
            first = {k: opt.mu[j] / (1.0 - opt.beta_1)
                     for k, (_, opt, j) in leaves.items()}
            r["grad_norms"] = {k: float(torch.linalg.vector_norm(g))
                               for k, g in first.items()}
            r["first_grads"] = {k: g.cpu() for k, g in first.items()}
            r["change1_norms"] = change()
            del first
    r["change_norms"] = change()
    del start
    env.stage(f"the first {env.traffic['check_steps']} steps")
    state.host_s = 0.0
    return state


def window(state, seconds: float) -> dict:
    losses, steps = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses.extend(_step(state))
        steps += 1
    if state.env.device.type == "cuda":
        torch.cuda.synchronize(state.env.device)
    dt = time.perf_counter() - t0
    bad = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    return {"window_s": dt, "steps": steps,
            "slices": steps * state.env.cfg["batch_size"],
            "host_s": state.host_s, "attempted": steps, "failed": bad}


def traced(state):
    with profiled(state.env.device, STEP_RANGES) as tr:
        for _ in range(state.env.traffic["trace_steps"]):
            _step(state)
        tr.units = state.env.traffic["trace_steps"]
    return tr


def calls(state):
    return state.env.family.train_calls(state.env.cfg)


def replay(env):
    """The reference's view of the first `check_steps` batches of the feed,
    replayed from the run's seeds: (echoes or maps, TE train) each."""
    cfg, fam = env.cfg, env.family
    arrays = fam.cohort(cfg, *cohort_arrays(env))
    sampler = fam.te_sampler(cfg) if hasattr(fam, "te_sampler") else None
    batches = ref_train.replay_feed(arrays, cfg["batch_size"],
                                    env.traffic["check_steps"],
                                    env.seeds["feed_np"],
                                    env.seeds["feed_torch"],
                                    cfg["data_aug_p"], sampler)
    return [b[:2] for b in batches]


def reference_readings(env, got: dict, steps_fn=None) -> dict:
    """The reference's first steps on the same weights, batches and
    noise, and the numbers comparing the program's readings `got` (a
    State's `readings`) with them. `steps_fn` stands in for the family's
    reference steps (a test's planted fault)."""
    nets = reference_nets(env)
    params = {f"{n}.{k}": p for n, m in nets.items()
              for k, p in m.named_parameters() if p.requires_grad}
    start = {k: p.detach().clone() for k, p in params.items()}
    ref_change1 = {}

    def on_step(i):
        if i == 0:
            ref_change1.update({k: float(torch.linalg.vector_norm(
                p.detach() - start[k])) for k, p in params.items()})

    with precision.float32():
        ref_losses, first, outputs = (steps_fn or env.family.reference_steps)(
            env.cfg, nets, replay(env), env.device, env.seeds["noise"],
            on_step)
    ref_grad = {k: float(torch.linalg.vector_norm(v))
                for k, v in first.items()}
    ref_change = {k: float(torch.linalg.vector_norm(p.detach() - start[k]))
                  for k, p in params.items()}
    keep = compare.moving_leaves(ref_grad)
    diff = {k: float(torch.linalg.vector_norm(
        got["first_grads"][k].to(env.device) - first[k])) for k in first}
    losses, grads = got["losses"], got["grad_norms"]
    change, change1 = got["change_norms"], got["change1_norms"]
    return {"fwd_gap": compare.output_gap(got["outputs"], outputs),
            "loss1_gap": compare.loss_gap(losses[:1], ref_losses[:1]),
            "loss_gap": compare.loss_gap(losses, ref_losses),
            "grad_diff_gap": compare.diff_gap(diff, ref_grad),
            "grad_gap": compare.leaf_gap(grads, ref_grad),
            "grad_median_gap": compare.leaf_gap(grads, ref_grad, None,
                                                np.median),
            "change1_gap": compare.leaf_gap(change1, ref_change1, keep),
            "change_gap": compare.leaf_gap(change, ref_change, keep),
            "change_median_gap": compare.leaf_gap(change, ref_change, keep,
                                                  np.median),
            "worst_grad_leaves": compare.worst_leaves(grads, ref_grad),
            "worst_change1_leaves": compare.worst_leaves(change1,
                                                         ref_change1, keep),
            "worst_leaves": compare.worst_leaves(change, ref_change, keep),
            "leaves": {k: [grads[k], ref_grad[k], diff[k], change1[k],
                           ref_change1[k], change[k], ref_change[k]]
                       for k in first},
            "ref_losses": ref_losses,
            "left_out": sorted(set(start) - set(keep))}


def check(state) -> list:
    env = state.env
    got = state.readings
    state.trainer = state.batches = state.readings = None
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    r = reference_readings(env, got)
    env.log(f"program losses {got['losses']}, reference {r['ref_losses']}; "
            f"{len(r['left_out'])} leaves left out of the change")
    return [(k, r[k], lim) for k, lim in env.cfg["limits"]["train"].items()]
