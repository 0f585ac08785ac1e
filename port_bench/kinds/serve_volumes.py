"""Serving traffic: one client in a closed loop sends study volumes, each
one call of the program's chunked serving entry
(`cli/roi_analysis.py::_per_slice`) over the configuration's serving
closure, and sends the next when the last one's maps are on the host.

The traffic file gives:
- `pool_slices`: distinct synthetic slices in host memory;
- `volume_slices` [lo, hi]: every size from lo to hi once a cycle, the
  order of each cycle shuffled by the seed (every seed serves the same
  sizes);
- `te`: "protocol" (the field's reference TE train for every volume) or
  "sampled" (`protocols` TE trains drawn as the TE-augmentation sampler
  draws them, `te1`, `dte`, `jitter`; each volume takes one, and its
  slices are synthesized at it);
- `check_volumes`: how many volumes the check compares (the longest of the
  first cycle and others of it drawn by the seed);
- `trace_volumes`: how many volumes the traced sub-window serves.

The window runs volumes until `--seconds` have passed and ends when the
last of them is back; every volume in it is complete. `attempted` counts
them; a call that fails raises and ends the run.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import synth, weights as wmod
from ..compare import rel_rms_by_slice
from ..trace import profiled

TRAINS = False
TE_FIELD = {1.5: (1.3e-3, 2.1e-3), 3.0: (0.879e-3, 0.6623e-3)}


@dataclass
class State:
    env: object
    run: object = None
    acqs: list = field(default_factory=list)   # per protocol (n, ne, H, W, 2)
    tes: list = field(default_factory=list)    # per protocol (hi, ne, 1)
    plan: list = field(default_factory=list)   # (size, protocol, start)
    sample: dict = field(default_factory=dict)  # plan index -> maps
    next: int = 0
    rng: object = None


def _extend_plan(state):
    tr = state.env.traffic
    lo, hi = tr["volume_slices"]
    n_pool = state.acqs[0].shape[0]
    for size in state.rng.permutation(np.arange(lo, hi + 1)):
        p = int(state.rng.integers(len(state.acqs)))
        start = int(state.rng.integers(0, n_pool - size + 1))
        state.plan.append((int(size), p, start))


def _volume(state, i):
    while i >= len(state.plan):
        _extend_plan(state)
    size, p, start = state.plan[i]
    return (state.acqs[p][start:start + size], state.tes[p][:size])


def _serve(state, i, run=None):
    from ideal_gan_tpu_torch.cli.roi_analysis import _per_slice
    acqs, te = _volume(state, i)
    maps, _ = _per_slice(run or state.run, acqs, te,
                         state.env.cfg["infer_batch"], state.env.device)
    if "alter_answer" in state.env.faults and i == min(state.sample):
        maps = maps.copy()
        maps[-1] = maps[0]  # the last slice answered with the first's maps
    return maps


def setup(env) -> State:
    cfg, tr, dev = env.cfg, env.traffic, env.device
    state = State(env, rng=np.random.default_rng(env.seeds["order"]))
    with torch.device("meta"):
        spec = env.family.reference_nets(cfg)
    w = wmod.make(spec, env.seeds["weights"], dev)
    state.run = env.family.serve_program(cfg, w, dev)
    del w
    env.stage("weights and the serving closure")
    gen = torch.Generator(device=dev).manual_seed(env.seeds["inputs"])
    size, ne, field_t = cfg["data_size"], cfg["n_echoes"], cfg["field"]
    maps = synth.maps(gen, tr["pool_slices"], size, dev)
    hi = tr["volume_slices"][1]
    if tr["te"] == "protocol":
        tes = [synth.te_train(ne, *TE_FIELD[field_t], dev)]
        subsets = [torch.arange(len(maps), device=dev)]
    else:
        tes = [synth.sampled_te(gen, ne, tr["te1"], tr["dte"], tr["jitter"],
                                dev) for _ in range(tr["protocols"])]
        per = tr["protocol_slices"]
        subsets = [torch.randperm(len(maps), generator=gen, device=dev)[:per]
                   for _ in tes]
    for te, rows in zip(tes, subsets):
        state.acqs.append(synth.host(synth.acquisitions(maps[rows], te,
                                                        field_t)))
        state.tes.append(synth.host(te.expand(hi, -1, -1).contiguous()))
    del maps
    env.stage("the cohort, on the host")
    _extend_plan(state)
    first = state.plan[:hi - tr["volume_slices"][0] + 1]
    longest = max(range(len(first)), key=lambda i: first[i][0])
    others = [i for i in state.rng.permutation(len(first)) if i != longest]
    state.sample = {i: None for i in [longest] + [int(i) for i in others[
        :tr["check_volumes"] - 1]]}
    # warm-up: one volume of 1.5 chunks (the padded chunk), not from the plan
    from ideal_gan_tpu_torch.cli.roi_analysis import _per_slice
    nb = cfg["infer_batch"]
    n = nb + nb // 2
    _per_slice(state.run, state.acqs[0][:n], state.tes[0][:n], nb, dev)
    env.stage("warm-up volume")
    return state


def _median_ms(fn, dev, n: int = 5) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def _host_log(state, lat, sizes) -> None:
    """After the window, on standard error: each volume's latency over its
    chunks (quartiles), and the parts of one chunk timed apart (medians of
    five): the closure on a chunk already on the card, the chunk's
    pageable copy to the card, its outputs' copy back, and a host copy of
    the chunk's bytes."""
    env, dev, nb = state.env, state.env.device, state.env.cfg["infer_batch"]
    per = [t / -(-n // nb) * 1e3 for t, n in zip(lat, sizes)]
    q = np.percentile(per, [25, 50, 75])
    a, te = state.acqs[0][:nb], state.tes[0][:nb]
    a_dev, te_dev = torch.from_numpy(a).to(dev), torch.from_numpy(te).to(dev)
    out = state.run(a_dev, te_dev)
    parts = [_median_ms(lambda: state.run(a_dev, te_dev), dev),
             _median_ms(lambda: torch.from_numpy(a).to(dev), dev),
             _median_ms(lambda: [o.cpu() for o in out], dev),
             _median_ms(lambda: np.copy(a), dev)]
    env.log("window host: ms a chunk by volume q1 %.2f median %.2f q3 %.2f; "
            "one chunk apart (ms): on the card %.2f, to the card %.2f "
            "(%.1f MB pageable), back %.2f, host copy %.2f"
            % (*q, parts[0], parts[1], a.nbytes / 1e6, *parts[2:]))


def window(state, seconds: float) -> dict:
    lat, sizes, slices = [], [], 0
    t0 = time.perf_counter()
    while True:
        i = state.next
        ts = time.perf_counter()
        maps = _serve(state, i)
        te_ = time.perf_counter()
        state.next += 1
        lat.append(te_ - ts)
        sizes.append(len(maps))
        slices += len(maps)
        if i in state.sample:
            state.sample[i] = maps
        if te_ - t0 >= seconds:
            break
    _host_log(state, lat, sizes)
    return {"window_s": te_ - t0, "slices": slices, "latencies_s": lat,
            "attempted": len(lat), "failed": 0}


def traced(state):
    nb = state.env.cfg["infer_batch"]
    with profiled(state.env.device) as tr:
        chunks = 0
        for _ in range(state.env.traffic["trace_volumes"]):
            maps = _serve(state, state.next)
            state.next += 1
            chunks += -(-len(maps) // nb)
        tr.units = chunks
    return tr


def calls(state):
    return state.env.family.serve_calls(state.env.cfg,
                                        state.env.cfg["infer_batch"])


def reference_nets(env):
    """The reference nets on the device, carrying the run's weights made
    again from its seed."""
    with torch.device(env.device):
        nets = env.family.reference_nets(env.cfg)
    w = wmod.make(nets, env.seeds["weights"], env.device)
    for name, net in nets.items():
        net.load_state_dict(w[name])
    return nets


def _compare(env, nets, served: dict, volumes, fit_dtype=None) -> dict:
    """Each served slice against the reference, the worst slice's relative
    RMS gap: `pm_gap` of (phi, R2*) against the reference nets' on the
    same echoes; `rho_gap` of water/fat against the reference fit of the
    same echoes at the served (phi, R2*) (the fit stage alone: the fit
    amplifies any gap in phi). For the readings also the median slice's,
    and the water/fat of the reference's whole chain (`rho_chain_gap`).
    With `fit_dtype` (the fit stage's control) the reference fit computed
    from and rounded to that dtype stands in the served water/fat's
    place."""
    from ..reference import precision
    out = {"pm_gap": [], "rho_gap": [], "rho_chain_gap": []}
    nb, dev, fam = env.cfg["infer_batch"], env.device, env.family

    def low(x):
        return x.to(fit_dtype).float()

    with precision.float32():
        for i, maps in served.items():
            acqs, te = volumes(i)
            ref, fit, ctl = [], [], []
            for j in range(0, len(acqs), nb):
                a = torch.from_numpy(np.ascontiguousarray(acqs[j:j + nb]))
                t = torch.from_numpy(np.ascontiguousarray(te[j:j + nb]))
                pm = torch.from_numpy(maps[j:j + nb, 2:3])
                a, t, pm = a.to(dev), t.to(dev), pm.to(dev)
                ref.append(fam.reference_chunk(env.cfg, nets, a, t).cpu())
                fit.append(fam.reference_fit(env.cfg, a, pm, t).cpu())
                if fit_dtype is not None:
                    ctl.append(low(fam.reference_fit(env.cfg, low(a),
                                                     low(pm), t)).cpu())
            ref, fit = torch.cat(ref).numpy(), torch.cat(fit).numpy()
            rho = torch.cat(ctl).numpy() if ctl else maps[:, :2]
            out["pm_gap"] += rel_rms_by_slice(maps[:, 2], ref[:, 2])
            out["rho_gap"] += rel_rms_by_slice(rho, fit)
            out["rho_chain_gap"] += rel_rms_by_slice(maps[:, :2], ref[:, :2])
    res = {k: max(v) for k, v in out.items()}
    res.update({k.replace("_gap", "_median_gap"): float(np.median(v))
                for k, v in out.items()})
    return res


def check(state) -> list:
    env = state.env
    for i in state.sample:
        if state.sample[i] is None:  # not reached in the window: serve now
            state.sample[i] = _serve(state, i)
    state.run = None
    if env.device.type == "cuda":
        torch.cuda.empty_cache()
    nets = reference_nets(env)
    gaps = _compare(env, nets, state.sample, lambda i: _volume(state, i))
    env.log(f"served {len(state.sample)} volumes of "
            f"{sum(len(m) for m in state.sample.values())} slices compared")
    return [(k, gaps[k], lim) for k, lim in env.cfg["limits"]["serve"].items()]


def control_readings(state, control: bool) -> dict:
    """The numbers of the program on the sampled volumes, and with
    `control` the control's (for setting the limits; the runs never call
    it)."""
    env = state.env
    nets = reference_nets(env)
    served = {i: _serve(state, i) for i in state.sample}
    vol = lambda i: _volume(state, i)  # noqa: E731
    out = {"program": _compare(env, nets, served, vol)}
    if not control:
        return out
    with torch.device("meta"):
        spec = env.family.reference_nets(env.cfg)
    w = wmod.make(spec, env.seeds["weights"], env.device)
    ctl = env.family.serve_control(env.cfg, w, env.device)
    control = _compare(env, nets, {i: _serve(state, i, ctl)
                                   for i in state.sample}, vol)
    # the fit stage's control: the reference fit in bfloat16 in the
    # program's place, at the program's own (phi, R2*)
    fit_ctl = _compare(env, nets, served, vol, fit_dtype=torch.bfloat16)
    control.update({k: fit_ctl[k] for k in ("rho_gap", "rho_median_gap")})
    out["control"] = control
    return out
