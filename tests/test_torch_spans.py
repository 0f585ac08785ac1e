"""The port's profiler ranges in the serving loop and the trainer loop body,
its count of served and padded slices, and the benchmark's readers of those
ranges (`port_bench/metrics/`), on the CPU."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from ideal_gan_tpu_torch.cli import roi_analysis
from ideal_gan_tpu_torch.cli.roi_analysis import Replicas, _per_slice
from ideal_gan_tpu_torch.data import augment
from ideal_gan_tpu_torch.parallel import data_mesh, mesh as pmesh
from ideal_gan_tpu_torch.train import common, teaug
from port_bench import trace as btrace
from port_bench.harness import Bench, Context

ROOT = Path(__file__).resolve().parents[1]
SERVE_RANGES = (roi_analysis.VOLUME_RANGE, roi_analysis.PAD_RANGE,
                roi_analysis.TO_CARD_RANGE, roi_analysis.RUN_RANGE,
                roi_analysis.TO_HOST_RANGE, roi_analysis.ASSEMBLE_RANGE)
BATCH_RANGES = (common.GATHER_RANGE, augment.AUGMENT_RANGE,
                teaug.TE_DRAW_RANGE, pmesh.TO_CARD_RANGE)


def _toy_run(a, t):
    """A serving closure's shape: two outputs a chunk, each slice's from
    its own echoes and TE train."""
    return a * 2.0 + t.sum(dim=(1, 2))[:, None, None, None, None], \
        a[:, :1] - 1.0


def _volume(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, 4, 4, 2)).astype(np.float32),
            rng.standard_normal((n, 3, 1)).astype(np.float32))


def _host_spans(prof, names):
    """[(name, start_us, end_us)] of the host ranges `names`."""
    return [(ev.name, ev.time_range.start, ev.time_range.end)
            for ev in prof.events()
            if ev.name in names and ev.device_type != DeviceType.CUDA]


def _plain_per_slice(run, acqs, te, bs):
    """Chunks of `bs`, the last padded with its final slice, through `run`
    and back, each chunk trimmed, concatenated over the volume."""
    outs = []
    for i in range(0, len(acqs), bs):
        a, t = acqs[i:i + bs], te[i:i + bs]
        k = len(a)
        if k < bs:
            a = np.concatenate([a, np.repeat(a[-1:], bs - k, axis=0)])
            t = np.concatenate([t, np.repeat(t[-1:], bs - k, axis=0)])
        o = run(torch.from_numpy(a), torch.from_numpy(t))
        outs.append(tuple(x.numpy()[:k] for x in o))
    return tuple(np.concatenate(xs) for xs in zip(*outs))


def test_per_slice_spans_and_count():
    acqs, te = _volume(12)
    before = dataclasses.replace(roi_analysis.SERVED)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _per_slice(_toy_run, acqs, te, 8, "cpu")
    spans = _host_spans(prof, SERVE_RANGES)
    counts = {n: sum(s[0] == n for s in spans) for n in SERVE_RANGES}
    assert counts == {"serve volume": 1, "serve pad": 1, "serve to card": 2,
                      "serve run": 2, "serve to host": 2,
                      "serve assemble": 2}
    (_, v0, v1), = [s for s in spans if s[0] == "serve volume"]
    assert all(v0 <= s <= e <= v1 for _, s, e in spans)
    got = roi_analysis.SERVED - before
    assert (got.chunks, got.slices, got.padded) == (2, 12, 4)
    assert got.padded_share == pytest.approx(4 / 16)


@pytest.mark.parametrize("n, bs, parts", [(12, 8, 1), (16, 8, 1),
                                          (5, 2, 2), (1, 4, 2)])
def test_per_slice_outputs_equal_plain_loop(n, bs, parts):
    acqs, te = _volume(n, seed=n)
    run = _toy_run if parts == 1 else Replicas([_toy_run] * parts,
                                               ["cpu"] * parts)
    got = _per_slice(run, acqs, te, bs, "cpu")
    want = _plain_per_slice(_toy_run, acqs, te, bs)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _leaf_calls():
    gen = torch.Generator().manual_seed(0)
    maps = torch.rand(2, 3, 8, 8, 2, generator=gen)
    acqs = torch.rand(2, 6, 8, 8, 2, generator=gen)
    cfg = dict(teaug.DEFAULTS)
    mesh = data_mesh(device="cpu")
    return {
        augment.AUGMENT_RANGE: [
            lambda: augment.random_geometric(gen, maps),
            lambda: augment.random_fm_scale(gen, maps, 1.0),
            lambda: augment.bipolar_phase_row(gen, maps),
            lambda: augment.random_phase_offset(gen, acqs, maps)],
        teaug.TE_DRAW_RANGE: [lambda: teaug.sample_te(gen, cfg, 2)],
        pmesh.TO_CARD_RANGE: [lambda: pmesh.shard_batch((maps, acqs), mesh)],
    }


@pytest.mark.parametrize("name", [augment.AUGMENT_RANGE,
                                  teaug.TE_DRAW_RANGE, pmesh.TO_CARD_RANGE])
def test_leaf_functions_record_their_span(name):
    calls = _leaf_calls()[name]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for call in calls:
            call()
    assert len(_host_spans(prof, (name,))) == len(calls)


def test_batch_gather_span_closes_before_yield():
    arrays = (np.arange(10.0), np.arange(10.0) * 2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in common.batch_iterator(arrays, 3, np.random.default_rng(0)):
            with torch.profiler.record_function("consumer"):
                pass
    gathers = _host_spans(prof, (common.GATHER_RANGE,))
    consumers = _host_spans(prof, ("consumer",))
    assert len(gathers) == len(consumers) == 3
    for _, cs, ce in consumers:
        assert all(ge <= cs or gs >= ce for _, gs, ge in gathers)


def _reader(name):
    return Bench(ROOT).reader(name)


# a hand-built trace of two units over a 100 µs window: the card busy at
# [0, 20] and [50, 70]; the host in the ranges below
SPANS_AT = {"serve": [("serve volume", 0, 100), ("serve pad", 10, 30),
                      ("serve to card", 25, 40), ("serve run", 40, 45),
                      ("serve to host", 60, 80), ("serve assemble", 80, 95),
                      ("aten::cat", 82, 90)],
            "train": [("batch gather", -10, 10), ("batch augment", 30, 45),
                      ("batch te draw", 45, 48), ("batch to card", 60, 75),
                      ("adam step", 0, 20)]}
KNOWN_MS = {
    # pad ∪ assemble: [10, 30] + [80, 95] = 35 µs, over 2 units
    "assemble_ms.serve": ("serve", 35 / 2 / 1e3),
    # [10, 40] ∪ [60, 95] less the busy [10, 20] and [60, 70]: 20 + 25
    "loop_idle_ms.serve": ("serve", 45 / 2 / 1e3),
    # [0, 10] (clipped) ∪ [30, 48] ∪ [60, 75] = 43 µs
    "batch_ms.train": ("train", 43 / 2 / 1e3),
    # less the busy [0, 10] and [60, 70]: 0 + 18 + 5
    "batch_idle_ms.train": ("train", 23 / 2 / 1e3),
}
KINDS = {"serve": "serve_volumes", "train": "train_steps"}


def _ctx(kind, host_ops):
    tr = btrace.Trace(kernels=[("k1", 0.0, 20.0), ("memcpy", 50.0, 70.0)],
                      window=(0.0, 100.0), host_ops=host_ops, units=2)
    return Context(KINDS[kind], {}, {}, 0.0, trace=tr)


@pytest.mark.parametrize("metric", sorted(KNOWN_MS))
def test_span_metrics_read_known_ms(metric):
    kind, want = KNOWN_MS[metric]
    read = _reader(metric)
    assert read(_ctx(kind, SPANS_AT[kind])) == pytest.approx(want)
    # absent: no spans of the program, or the other kind's cell
    assert read(_ctx(kind, [("aten::cat", 0, 50)])) is None
    other = "train" if kind == "serve" else "serve"
    assert read(_ctx(other, SPANS_AT[other])) is None
    assert read(Context(KINDS[kind], {}, {}, 0.0)) is None


def test_loop_idle_covers_assembly_on_idle_card():
    acqs, te = _volume(12)
    with btrace.profiled("cpu") as tr:
        _per_slice(_toy_run, acqs, te, 8, "cpu")
        tr.units = 2
    assert not tr.kernels
    ctx = Context("serve_volumes", {}, {}, 0.0, trace=tr)
    assemble = _reader("assemble_ms.serve")(ctx)
    idle = _reader("loop_idle_ms.serve")(ctx)
    assert assemble is not None and idle is not None
    assert idle >= assemble > 0


@pytest.mark.parametrize("metric, program", [
    ("assemble_ms.serve", (roi_analysis.PAD_RANGE,
                           roi_analysis.ASSEMBLE_RANGE)),
    ("loop_idle_ms.serve", (roi_analysis.PAD_RANGE,
                            roi_analysis.TO_CARD_RANGE,
                            roi_analysis.TO_HOST_RANGE,
                            roi_analysis.ASSEMBLE_RANGE)),
    ("batch_ms.train", BATCH_RANGES),
    ("batch_idle_ms.train", BATCH_RANGES)])
def test_metric_span_names_are_the_programs(metric, program):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "span_metric", ROOT / "port_bench" / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.SPANS == program
