"""The port's run record against the JAX package's on the same inputs:
`utils.config` (Config, parse_flags), `utils.serialization`,
`utils.preempt.PreemptionGuard`, `utils.summary.DictSummaryWriter` (event
files written without tensorboardX, read back by TensorBoard's own record
reader, which checks every frame's masked CRC-32C, beside tensorboardX's
files from the JAX writer), `train.common.TrainLoop`, `utils.timer` and
`eval.samples.save_sample_grid`. Every comparison is exact: the same
Python and numpy arithmetic on both sides (summary scalars are float32
on both).
"""

import os
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu.eval.samples import save_sample_grid as j_grid  # noqa: E402
from ideal_gan_tpu.train.common import TrainLoop as JTrainLoop  # noqa: E402
from ideal_gan_tpu.utils import config as jconfig  # noqa: E402
from ideal_gan_tpu.utils import serialization as jser  # noqa: E402
from ideal_gan_tpu.utils.preempt import PreemptionGuard as JGuard  # noqa: E402
from ideal_gan_tpu.utils.summary import DictSummaryWriter as JWriter  # noqa: E402
from ideal_gan_tpu_torch.eval.samples import save_sample_grid  # noqa: E402
from ideal_gan_tpu_torch.train.common import TrainLoop  # noqa: E402
from ideal_gan_tpu_torch.utils import config, serialization  # noqa: E402
from ideal_gan_tpu_torch.utils import summary as tsummary  # noqa: E402
from ideal_gan_tpu_torch.utils.preempt import PreemptionGuard  # noqa: E402
from ideal_gan_tpu_torch.utils.timer import Timer, profile  # noqa: E402

DEFAULTS = {"n": 3, "f": 0.5, "s": "x", "b": False, "none": None,
            "lst": [1, 2], "tup": (3, 4), "d": {"a": 1}}


@pytest.mark.parametrize("argv", [
    [],
    ["--n", "7", "--f", "2.5", "--s", "y", "--b", "true", "--none", "z"],
    ["--b", "0", "--lst", "[5, 6, 7]", "--tup", "[1]", "--d",
     '{"a": 2, "b": [1]}'],
    ["--b", "yes", "--d", "{}"],
])
def test_parse_flags_matches_jax(argv):
    got = config.parse_flags(DEFAULTS, argv)
    want = jconfig.parse_flags(DEFAULTS, argv)
    assert isinstance(got, config.Config)
    assert dict(got) == dict(want)
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}


def test_parse_flags_rejects_what_jax_rejects():
    for mod in (config, jconfig):
        with pytest.raises(SystemExit):
            mod.parse_flags(DEFAULTS, ["--b", "maybe"])


def test_config_round_trip_overlay_backfill(tmp_path):
    cfg = config.Config(a=1, b="two", c=[1, 2], d={"x": 0.5})
    assert cfg.a == 1 and cfg.d == {"x": 0.5}
    cfg.e = True
    assert cfg["e"] is True
    with pytest.raises(AttributeError):
        cfg.missing
    cfg.save(tmp_path / "sub" / "settings.yml")
    back = config.Config.load(tmp_path / "sub" / "settings.yml")
    assert back == cfg and isinstance(back, config.Config)
    # each package reads the other's file
    assert jconfig.Config.load(tmp_path / "sub" / "settings.yml") == cfg
    jconfig.Config(cfg).save(tmp_path / "j.yml")
    assert config.Config.load(tmp_path / "j.yml") == cfg
    assert (tmp_path / "sub" / "settings.yml").read_text() == \
        (tmp_path / "j.yml").read_text()
    over = {"a": 9, "z": 0}
    assert cfg.overlay(over) == jconfig.Config(cfg).overlay(over)
    assert cfg.backfill(over) == jconfig.Config(cfg).backfill(over)
    assert cfg.overlay(over).a == 9 and cfg.backfill(over).a == 1
    (tmp_path / "empty.yml").write_text("")
    assert config.Config.load(tmp_path / "empty.yml") == {}


@pytest.mark.parametrize("kind", ["json", "yaml", "pickle"])
def test_serialization_round_trip_and_cross_read(tmp_path, kind):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None, "d": True}}
    save = getattr(serialization, f"save_{kind}")
    load = getattr(serialization, f"load_{kind}")
    jload = getattr(jser, f"load_{kind}")
    jsave = getattr(jser, f"save_{kind}")
    # the extension is fixed on save and on load
    path = save(tmp_path / "d" / "obj.txt", obj)
    ext = {"json": ".json", "yaml": ".yml", "pickle": ".pkl"}[kind]
    assert path == str(tmp_path / "d" / f"obj{ext}")
    assert load(tmp_path / "d" / "obj") == obj == jload(path)
    assert Path(path).read_bytes() == \
        Path(jsave(tmp_path / "j" / "obj", obj)).read_bytes()


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_run_parallels_matches_jax(mode):
    got = serialization.run_parallels(abs, [-3, 1, -2], max_workers=2,
                                      mode=mode)
    assert got == jser.run_parallels(abs, [-3, 1, -2], max_workers=2,
                                     mode="thread") == [3, 1, 2]


def _wait_for(flag, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not flag() and time.monotonic() < deadline:
        time.sleep(0.01)
    return flag()


@pytest.mark.parametrize("guard_cls", [PreemptionGuard, JGuard])
def test_guard_latches_once_then_falls_through(guard_cls):
    seen = []
    before = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        guard = guard_cls(signals=(signal.SIGUSR1,))
        assert not guard.should_stop
        os.kill(os.getpid(), signal.SIGUSR1)
        assert _wait_for(lambda: guard.should_stop)
        assert seen == []  # latched, the previous handler not called
        # single-shot: the second signal reaches the previous handler
        os.kill(os.getpid(), signal.SIGUSR1)
        assert _wait_for(lambda: seen == [signal.SIGUSR1])
        guard.restore()
        assert signal.getsignal(signal.SIGUSR1) is not guard._handler
    finally:
        signal.signal(signal.SIGUSR1, before)


@pytest.mark.parametrize("guard_cls", [PreemptionGuard, JGuard])
def test_guard_off_the_main_thread_is_a_noop(guard_cls):
    out = {}
    before = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=lambda: out.setdefault(
        "g", guard_cls()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert out["g"].should_stop is False and out["g"]._previous == {}
    out["g"].restore()
    assert signal.getsignal(signal.SIGTERM) is before


def _tb_events(logdir):
    """(step, tag, kind, value) of every summary value in `logdir`'s event
    files, by TensorBoard's own record reader (CRCs checked) and event
    proto."""
    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.tensorflow_stub import errors
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
        PyRecordReader_New)
    out = []
    for path in sorted(Path(logdir).glob("events.out.tfevents.*")):
        reader = PyRecordReader_New(str(path))
        versions = []
        while True:
            try:
                reader.GetNext()
            except errors.OutOfRangeError:
                break
            ev = Event.FromString(reader.record())
            if ev.file_version:
                versions.append(ev.file_version)
            for v in ev.summary.value:
                kind = v.WhichOneof("value")
                out.append((ev.step, v.tag, kind, str(getattr(v, kind))))
        assert versions == ["brain.Event:2"]
    return out


def test_summary_writer_matches_jax_read_by_tensorboard(tmp_path):
    rng = np.random.default_rng(0)
    data = {"loss": np.float32(0.25), "g": rng.normal(size=(3, 5)),
            "zeros": np.zeros(4, np.float32), "n": 7,
            "bad tag!": np.float32(-1.5)}
    kinds = dict(types=("mean", "std", "max", "min", "sparsity"),
                 histogram=True)
    for cls, d in ((tsummary.DictSummaryWriter, "port"), (JWriter, "jax")):
        w = cls(str(tmp_path / d))
        w.write(data, 20, name="G_losses", **kinds)
        w.write({"loss": 0.125}, 40, name="G_losses")
        w.write(data, 60)
        w.close()
    got, want = _tb_events(tmp_path / "port"), _tb_events(tmp_path / "jax")
    assert got == want and len(got) == 2 * (4 + 5 + 1) + 1
    assert ("G_losses/bad_tag_" in {t for _, t, _, _ in got})
    assert {k for _, _, k, _ in got} == {"simple_value", "histo"}
    # the port's own reader: the same values, histograms included
    events = tsummary.read_events(next((tmp_path / "port").glob("events*")))
    assert [(s, t) for s, t, _ in events] == [(s, t) for s, t, _, _ in got]
    hist = dict(((s, t), v) for s, t, v in events)[(20, "G_losses/g/hist")]
    assert hist == tsummary.make_histogram(data["g"])
    assert tsummary.read_scalars(tmp_path / "port")["G_losses/loss"] == \
        [(20, 0.25), (40, 0.125)]


def test_read_scalars_reads_the_jax_writers_files(tmp_path):
    """The port's reader on tensorboardX's event files (the JAX writer's)
    gives what it gives on the port's own."""
    data = {"loss": np.float32(0.25), "g": np.arange(6.0).reshape(2, 3)}
    for cls, d in ((tsummary.DictSummaryWriter, "port"), (JWriter, "jax")):
        w = cls(str(tmp_path / d))
        w.write(data, 20, name="G_losses", types=("mean", "max"),
                histogram=True)
        w.write({"loss": 0.125}, 40, name="G_losses")
        w.close()
    got = tsummary.read_scalars(tmp_path / "port")
    assert got == tsummary.read_scalars(tmp_path / "jax")
    assert got == {"G_losses/loss": [(20, 0.25), (40, 0.125)],
                   "G_losses/g/mean": [(20, 2.5)],
                   "G_losses/g/max": [(20, 5.0)]}


def test_reader_rejects_a_corrupted_frame(tmp_path):
    w = tsummary.DictSummaryWriter(tmp_path)
    w.write({"x": 1.0}, 20)
    w.close()
    path = w.path
    raw = bytearray(path.read_bytes())
    raw[-6] ^= 0xFF
    path.write_bytes(bytes(raw))
    from tensorboard.compat.tensorflow_stub.errors import DataLossError
    with pytest.raises(DataLossError, match="crc32"):
        tsummary.read_events(path)


class _Scalar:
    """A trivial trainer state: one float and a step count."""

    def __init__(self):
        self.w, self.step = 0.0, 0

    def state_dict(self):
        return {"w": torch.tensor(self.w), "step": self.step}

    def load_state_dict(self, s):
        self.w, self.step = float(s["w"]), int(s["step"])


def test_trainloop_matches_jax(tmp_path):
    """12 epochs of 2 batches of 8 with a checkpoint every 5 epochs: a
    summary at global step 20, checkpoints at 5, 10, 12; a rerun to 13
    epochs resumes from 12, runs one epoch (its global count starts at 0
    again, so no summary) and checkpoints 13."""
    first, second = 12, 13
    x = np.arange(16, dtype=np.float32).reshape(16, 1)

    def batches():
        return ((x[i:i + 8],) for i in range(0, 16, 8))

    @jax.jit
    def jstep(state, batch, key):
        w = state["w"] + jnp.mean(batch[0])
        return {"w": w, "step": state["step"] + 1}, {"loss": w}

    def tstep(state, batch):
        state.w = float(np.float32(state.w) + np.mean(batch[0].numpy()))
        state.step += 1
        return state, {"loss": torch.tensor(state.w)}

    runs = {}
    for name in ("jax", "port"):
        out = tmp_path / name
        calls, states = [], []
        for epochs in (first, second):
            # a new second: tensorboardX names its event file by the
            # second and overwrites a file of the same name
            now = int(time.time())
            while int(time.time()) == now:
                time.sleep(0.02)
            if name == "jax":
                loop = JTrainLoop(jstep, str(out), epoch_ckpt=5)
                st = loop.run({"w": np.zeros((), np.float32),
                               "step": np.zeros((), np.int32)},
                              epochs, lambda: (calls.append(1), batches())[1],
                              jax.random.PRNGKey(0))
                loop.writer.close()
                steps = sorted(loop.ckpt._mgr.all_steps())
                loop.ckpt.close()
                states.append((float(st["w"]), int(st["step"])))
            else:
                loop = TrainLoop(tstep, str(out), epoch_ckpt=5, device="cpu")
                st = loop.run(_Scalar(), epochs,
                              lambda: (calls.append(1), batches())[1])
                steps = loop.record.ckpt.steps()
                states.append((st.w, st.step))
        runs[name] = dict(epochs_run=len(calls), checkpoints=steps,
                          states=states,
                          events=_tb_events(out / "summaries" / "train"))
    assert runs["port"] == runs["jax"]
    assert runs["port"]["epochs_run"] == first + 1
    assert runs["port"]["checkpoints"] == [5, 10, 12, 13]
    assert [(s, t) for s, t, _, _ in runs["port"]["events"]] == \
        [(20, "G_losses/loss")]


def test_timer_and_profile(tmp_path):
    with Timer() as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    with profile(""):
        pass
    assert not any(tmp_path.iterdir())
    with profile(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_sample_grid_pixels_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from matplotlib.image import imread
    rng = np.random.default_rng(3)
    acqs = rng.normal(size=(1, 6, 24, 24, 2)).astype(np.float32)
    pred = rng.normal(size=(1, 3, 24, 24, 2)).astype(np.float32)
    gt = rng.normal(size=(1, 3, 24, 24, 2)).astype(np.float32)
    for gt_maps in (gt, None):
        save_sample_grid(str(tmp_path / "p" / "iter-0001.png"), acqs, pred,
                         gt_maps)
        j_grid(str(tmp_path / "j" / "iter-0001.png"), acqs, pred, gt_maps)
        got = imread(tmp_path / "p" / "iter-0001.png")
        want = imread(tmp_path / "j" / "iter-0001.png")
        assert got.shape == want.shape and got.shape[0] > 100
        np.testing.assert_array_equal(got, want)
