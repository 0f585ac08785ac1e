"""The bf16 path of the port vs the JAX package: the ConvLSTM kernels' bf16
storage mode and the bf16 training steps.

- The plain bf16 ConvLSTM forward and backward (what the wrappers take for
  CPU tensors, written to the TPU kernels' rounding points) against the
  JAX package's `convlstm_pallas` / `convlstm_bwd_pallas` in interpret
  mode on the same bf16 inputs. Gate: one bf16 ulp of the output's scale,
  2u·max|JAX| with u = 2^-8 (the two round at the same points; JAX's dx
  overlap-adds its bf16 windows in f32 and rounds again). Witness: the
  float32 plain version on the same values is farther from JAX's bf16
  result than the port's bf16 one.
- One bf16 FM step and one bf16 R2 step of AI-DEAL and one bf16 VET-Net
  generator step against JAX's bf16 steps on the CPU, from the same
  weights (Flax parameters drawn at random, carried across by
  `ideal_gan_tpu_torch.convert`), 3-level nets of F=4 at 64² (JAX's FM
  and R2 gradients from one compile of the shared cycle loss). JAX's CPU
  ConvLSTM is its all-bf16 XLA recurrence, not the kernel's f32-gate form,
  and XLA keeps fused elementwise chains in f32 where eager PyTorch rounds
  every op, so the two bf16 steps are two different bf16 roundings of one
  float32 step. At random weights most of such a gradient is rounding
  noise: JAX's own bf16 FM gradient lies 0.73 of scale from its float32
  one here (2.45 with 2 levels at 32²), so no whole-gradient bound both
  passes the port and fails a wrong step. The gate (`_gate`) holds the
  step where bf16 resolves it, with JAX's float32 step as the witness:
  - loss: |port − JAX bf16| ≤ LOSS_FACTOR = 3 × |JAX bf16 − JAX f32|;
  - resolved leaves, those JAX's bf16 step puts within LEAF_SEL = 0.1 of
    the leaf's own float32 scale (at least MIN_RESOLVED = 3; the last
    decoder level and the head, 3, 8 and 8 leaves in the three steps):
    the port's bf16 gradient within LEAF_TOL = 0.25 of that scale of
    JAX's;
  - bf16 applied: the port's step at least APPLIED = 0.1 × JAX's
    bf16-vs-f32 distance from float32 (on the f32 step's scale).
  Three controls go through the same gate and must fail it: the port's
  float32 step (bf16 applied), its bf16 gradient zeroed and sign-flipped
  (resolved leaves: ~1 and ~2 of their scale).

Inputs are made with numpy from a seed; torch runs on one thread.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.ops import pallas_convlstm as jpc  # noqa: E402
from ideal_gan_tpu.train import teaug as jteaug  # noqa: E402
from ideal_gan_tpu.train import unsup as junsup  # noqa: E402
from ideal_gan_tpu_torch import convert, models, ops  # noqa: E402
from ideal_gan_tpu_torch.train import teaug as tteaug  # noqa: E402
from ideal_gan_tpu_torch.train import unsup as tunsup  # noqa: E402

from test_torch_teaug import _random_params, _te  # noqa: E402

U = 2.0 ** -8  # bf16's unit roundoff
F_SMALL, LAYERS, SIZE, NE = 4, 3, 64, 6  # the steps' nets and batch
LOSS_FACTOR, LEAF_SEL, LEAF_TOL, APPLIED, MIN_RESOLVED = 3.0, 0.1, 0.25, 0.1, 3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("cin", [2, 1])
def test_bf16_plain_convlstm_matches_pallas(cin):
    rng = np.random.default_rng(40 + cin)
    nb, ne, h, w, f = 1, 3, 8, 8, 4
    x = (rng.normal(size=(nb, ne, h, w, cin)) * 0.5).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin + f, 4 * f)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(4 * f,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(nb, h, w, f)).astype(np.float32)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (x, k, b, g)]
    ref = [jpc.convlstm_pallas(*jx[:3], interpret=True),
           *jpc.convlstm_bwd_pallas(*jx, interpret=True)]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, k, b, g)]
    got = [ops.convlstm_forward(*tx[:3]), *ops.convlstm_backward(*tx)]
    t32 = [torch.from_numpy(a) for a in (x, k, b, g)]
    wit = [ops.convlstm_forward(*t32[:3]), *ops.convlstm_backward(*t32)]
    for name, a, r, w32 in zip(("h", "dx", "dk", "db"), got, ref, wit):
        assert a.dtype == torch.bfloat16, name
        r = np.asarray(r, np.float32)
        d = np.abs(a.float().numpy() - r).max()
        assert d <= 2 * U * np.abs(r).max(), (name, d)
        assert d < np.abs(w32.numpy() - r).max(), name


def test_kink_masked_gradient_takes_bf16():
    """The mask on bf16 inputs runs the forward's bf16 roundings in float64
    and returns g in bf16: no value within 0 of the kink masks nothing,
    every value within a huge tol masks everything."""
    rng = np.random.default_rng(5)
    x, k, b, g = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                  for a in (rng.normal(size=(1, 3, 8, 8, 2)),
                            rng.normal(size=(3, 3, 6, 16)) * 0.3,
                            rng.normal(size=(16,)) * 0.1,
                            rng.normal(size=(1, 8, 8, 4))))
    kept = ops.kink_masked_gradient(x, k, b, g, tol=0.0)
    assert kept.dtype == torch.bfloat16 and torch.equal(kept, g)
    gone = ops.kink_masked_gradient(x, k, b, g, tol=1e9)
    assert not bool(gone.float().abs().max() > 0)


def _resolved(ref, f32):
    """{leaf: its float32 scale} of the leaves whose bf16 gradient `ref`
    lies within LEAF_SEL of that scale of the float32 one."""
    out = {}
    for k, w in f32[1].items():
        s = float(np.abs(w).max())
        if s > 0 and np.abs(ref[1][k] - w).max() <= LEAF_SEL * s:
            out[k] = s
    return out


def _gate(port, ref, f32):
    """The rules of the module docstring that the bf16 step `port` breaks
    against JAX's bf16 step `ref`, with JAX's float32 step `f32` as the
    witness; each run is (loss, {leaf: gradient})."""
    scale = max(float(np.abs(v).max()) for v in f32[1].values())

    def dist(a, b):
        return max(float(np.abs(a[1][k] - b[1][k]).max())
                   for k in f32[1]) / scale

    failures = []
    if abs(port[0] - ref[0]) > LOSS_FACTOR * abs(ref[0] - f32[0]):
        failures.append("loss")
    if any(np.abs(port[1][k] - ref[1][k]).max() > LEAF_TOL * s
           for k, s in _resolved(ref, f32).items()):
        failures.append("resolved leaves")
    if dist(port, f32) < APPLIED * dist(ref, f32):
        failures.append("bf16 applied")
    return failures


def _j_unsup(cfg, acqs, te, p_fm, p_r2):
    """JAX's FM and R2 steps of `cfg`'s dtype, {"fm": (loss, {torch leaf:
    gradient}), "r2": ...}: with no TV or L1 weight both steps' loss is the
    cycle loss ‖A − Â‖², so one gradient of it with respect to both nets'
    parameters gives the FM step's (R2 net fixed) and the R2 step's (FM
    net fixed), from one compile."""
    g_fm, g_r2 = (m.clone(num_layers=LAYERS)
                  for m in junsup.build_models(cfg))
    a, t = jnp.asarray(acqs), jnp.asarray(te)

    def loss(pf, pr):
        _, _, a_hat, _ = junsup._uq_pipeline(
            cfg, g_fm, g_r2, pf, jnp.float32(0.0), pr, None, a, t,
            jax.random.PRNGKey(0), with_var=False)
        return jnp.mean(jnp.square(a - a_hat))

    assert cfg["FM_TV_weight"] == cfg["FM_L1_weight"] == 0.0
    assert cfg["R2_TV_weight"] == cfg["R2_L1_weight"] == 0.0
    val, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        p_fm, p_r2)
    return {step: (float(val), {k: np.asarray(v, np.float32) for k, v in
                                convert.unet(g, LAYERS).items()})
            for step, g in zip(("fm", "r2"), grads)}


def _t_unsup(cfg, step, acqs, te, p_fm, p_r2, monkeypatch):
    monkeypatch.setattr(tunsup, "UNet", functools.partial(
        models.UNet, num_layers=LAYERS))
    g_fm, g_r2 = tunsup.build_models(cfg)
    g_fm.load_state_dict(convert.unet(p_fm, LAYERS))
    g_r2.load_state_dict(convert.unet(p_r2, LAYERS))
    make = tunsup.make_loss_fn if step == "fm" else tunsup.make_r2_loss_fn
    loss, _ = make(cfg, g_fm, g_r2)(torch.tensor(0.0), _t(acqs), _t(te))
    loss.backward()
    net = g_fm if step == "fm" else g_r2
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in net.named_parameters()}


_RUNS = {}


def _runs(step):
    """(JAX f32, JAX bf16, port bf16, port f32) of the "fm", "r2" or
    "vetnet" step, each (loss, {torch leaf: gradient}), computed once."""
    if step not in _RUNS:
        _RUNS[step] = _vetnet_runs() if step == "vetnet" else \
            _unsup_runs(step)
    return _RUNS[step]


def _unsup_runs(step):
    acqs, _, te = (np.array(a) for a in j_synthetic(2, h=SIZE, w=SIZE,
                                                     ne=NE))
    cfg = dict(junsup.DEFAULTS, n_G_filters=F_SMALL, out_vars="PM")
    g_fm, g_r2 = (m.clone(num_layers=LAYERS)
                  for m in junsup.build_models(cfg))
    a = jnp.asarray(acqs)
    a_abs = jnp.sqrt(jnp.sum(jnp.square(a), axis=-1, keepdims=True))
    case = (acqs, te, _random_params(g_fm, 21, a[:1]),
            _random_params(g_r2, 22, a_abs[:1]))
    cfg_bf16 = dict(cfg, bf16=True)
    j_f32, j_bf16 = _j_unsup(cfg, *case), _j_unsup(cfg_bf16, *case)
    with pytest.MonkeyPatch.context() as mp:
        for s in ("fm", "r2"):
            _RUNS[s] = (j_f32[s], j_bf16[s],
                        _t_unsup(cfg_bf16, s, *case, mp),
                        _t_unsup(cfg, s, *case, mp))
    return _RUNS[step]


def _vetnet_runs():
    _, maps, _ = (np.array(a) for a in j_synthetic(2, h=SIZE, w=SIZE,
                                                    ne=NE))
    te = _te("jittered", 2, seed=7)
    cfg = dict(jteaug.DEFAULTS, n_G_filters=F_SMALL)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (2, NE, SIZE, SIZE, 2)))
    runs = {}
    p = None
    for bf16 in (False, True):
        c = dict(cfg, bf16=bf16)
        jm = jteaug.build_model(c).clone(num_layers=LAYERS)
        if p is None:
            p = _random_params(jm, 7, jnp.asarray(maps[:1, :1]),
                               jnp.asarray(te[:1, :, 0]))
        (val, _), grads = jax.jit(jax.value_and_grad(
            jteaug.make_loss_fn(c, jm), has_aux=True))(
                p, None, jnp.asarray(maps), jnp.asarray(te), key)
        runs[bf16] = (float(val), {k: np.asarray(v, np.float32) for k, v in
                                   convert.vetnet(grads, LAYERS).items()
                                   if not k.endswith("bias_ih_l0")})

    def port(dtype):
        tm = models.VETNet(2, te_input=True, filters=F_SMALL,
                           num_layers=LAYERS, dtype=dtype)
        tm.load_state_dict(convert.vetnet(p, LAYERS))
        loss, _ = tteaug.make_loss_fn(
            dict(cfg, bf16=dtype == torch.bfloat16), tm)(
                _t(maps), _t(te), _t(noise))
        loss.backward()
        return (float(loss.detach()), {n: q.grad.numpy() for n, q in
                                       tm.named_parameters()
                                       if q.requires_grad})

    return runs[False], runs[True], port(torch.bfloat16), port(torch.float32)


def _check(step):
    j_f32, j_bf16, port, _ = _runs(step)
    assert len(_resolved(j_bf16, j_f32)) >= MIN_RESOLVED
    assert _gate(port, j_bf16, j_f32) == []


@pytest.mark.parametrize("step", ["fm", "r2"])
def test_unsup_bf16_step_matches_jax(step):
    _check(step)


def test_teaug_vetnet_bf16_step_matches_jax():
    _check("vetnet")


@pytest.mark.parametrize("control", ["f32_step", "zero_gradient",
                                     "flipped_gradient"])
@pytest.mark.parametrize("step", ["fm", "r2", "vetnet"])
def test_bf16_step_gate_rejects_controls(step, control):
    """The gate is not vacuous: the port's float32 step, and its bf16 step
    with the gradient zeroed or sign-flipped, each break it."""
    j_f32, j_bf16, port, port_f32 = _runs(step)
    run = {"f32_step": port_f32,
           "zero_gradient": (port[0], {k: np.zeros_like(v)
                                       for k, v in port[1].items()}),
           "flipped_gradient": (port[0], {k: -v for k, v in
                                          port[1].items()})}[control]
    want = "bf16 applied" if control == "f32_step" else "resolved leaves"
    assert want in _gate(run, j_bf16, j_f32)
