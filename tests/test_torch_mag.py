"""The magnitude slice of the port vs the JAX package: the magnitude design
matrix and the 2×2 eigensolve, the magnitude-domain fit and its gradient,
the fused fit, the Rician posterior, the UNet with TE input and σ head, the
magnitude trainer's loss and gradients, Mag serving, and the port's CLIs.

Inputs are made with numpy from a seed and handed to both packages; model
weights are Flax parameters with random values (`test_torch_teaug.
_random_params`, shapes from the Flax module's own init) converted by
`ideal_gan_tpu_torch.convert.unet`, which also maps gradient trees. The
JAX package's Pallas kernel runs in interpret mode on the CPU, as its own
tests run it. Tolerances:
- the design matrix and the eigensolve rtol 1e-5 / atol 1e-6 (float32, a
  3×3 closed-form inverse);
- the fit rtol 1e-4 / atol 1e-5 on the synthetic cohort (every voxel, zero
  background included), and on random |S| the JAX kernel's rtol 1e-3 /
  atol 5e-4 (tests/test_pallas_kernels.py:342-352: voxels on the fit's
  1e-6 and λmax > 0 thresholds flip under another summation order, and an
  ill-conditioned eigenvector turns a last-bit difference into 1e-4); its
  gradient rtol 1e-3 / atol 1e-5, the JAX package's gradient tolerance;
- the Rician rtol 1e-5 (its log_prob atol 1e-4: values of ~1e3 at small σ);
- the UNet's ν and σ and the served maps rtol / atol 1e-4 (about twenty
  layers of float32 sums in another order, tests/test_torch_models.py);
- the trainer's loss and every metric to 2e-5 relative, every gradient
  leaf to 2e-2 of the global gradient scale (MODEL_PARITY.json). WF_NZ
  sums c − a over the voxels where c > a, a few cancelling differences:
  its relative error is the least well conditioned of the metrics (up to
  2.1e-5 over three weight seeds; 3.4e-6 with the seed used).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu import ops as jops  # noqa: E402
from ideal_gan_tpu import physics as jph  # noqa: E402
from ideal_gan_tpu.cli.common import synthetic_dataset as j_synthetic  # noqa: E402
from ideal_gan_tpu.models import UNet as JUNet  # noqa: E402
from ideal_gan_tpu.physics import matrix as jmx  # noqa: E402
from ideal_gan_tpu.prob import Rician as JRician  # noqa: E402
from ideal_gan_tpu.train import mag as jmag  # noqa: E402
from ideal_gan_tpu_torch import convert, models, ops, physics  # noqa: E402
from ideal_gan_tpu_torch.cli import infer, roi_analysis, train_mag  # noqa: E402
from ideal_gan_tpu_torch.physics import matrix as tmx  # noqa: E402
from ideal_gan_tpu_torch.prob import Rician  # noqa: E402
from ideal_gan_tpu_torch.train import mag as tmag  # noqa: E402
from ideal_gan_tpu_torch.utils import Checkpoint  # noqa: E402

from test_torch_infer import _flat  # noqa: E402
from test_torch_teaug import _random_params, _te, _worst_grad  # noqa: E402

F_SMALL, LAYERS, SIZE, NE = 4, 2, 32, 6
FIELDS = ("rho", "recon", "demod", "ls_coeffs", "uncertainty")
# the unsupervised config with every regularizer: weights that keep each
# term near the cycle loss's size at these shapes (random nets give LS
# coefficients far from a physical fit)
UNSUP_REGS = dict(training_mode="unsupervised", main_loss="MAE",
                  R2_TV_weight=1e-5, A_demod_TV_weight=1e-6,
                  LS_NZ_weight=1e-6, LS_cond_weight=1e-9)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cohort_mag(nb=2, h=16, w=128, seed=1):
    """|S| of the synthetic cohort (zero outside its mask) and an R2* row
    N(0, 0.05²) off the truth, clipped to [0, 1]."""
    acqs, maps, te = (np.array(x) for x in j_synthetic(nb, h=h, w=w, ne=NE))
    a_mag = np.sqrt(np.sum(np.square(acqs), -1, keepdims=True))
    r2 = maps[:, 2:3, ..., 1:] + 0.05 * np.random.default_rng(seed).normal(
        size=(nb, 1, h, w, 1))
    return a_mag.astype(np.float32), np.clip(r2, 0, 1).astype(np.float32), te


# --------------------------------------------------------------------------
# the design matrix, the eigensolve, the fit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("te_kind", ["uniform", "jittered"])
def test_mag_design_matrix_and_eigenvals_match_jax(te_kind):
    te = _te(te_kind, 2)
    ref = jmx.mag_design_matrix(jmx.model_matrix(jnp.asarray(te)))
    got = tmx.mag_design_matrix(tmx.model_matrix(_t(te)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6)
    x = np.random.default_rng(2).normal(size=(64, 3)).astype(np.float32)
    x[:8] = 0.0  # λmax = 0: the masked branch
    for g, r in zip(tmx.eigenvals_2x2(_t(x)), jmx.eigenvals_2x2(
            jnp.asarray(x))):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("te_kind", ["uniform", "jittered"])
@pytest.mark.parametrize("with_nu", [False, True])
def test_cse_mag_fit_matches_jax(te_kind, with_nu):
    a_mag, r2, te = _cohort_mag()
    if te_kind == "jittered":
        te = _te("jittered", 2)
    nu = np.clip(r2 + 0.1, 0, 1).astype(np.float32) if with_nu else None
    ref = jph.cse_mag_fit(jnp.asarray(a_mag), jnp.asarray(r2),
                          jnp.asarray(te),
                          r2s_nu=None if nu is None else jnp.asarray(nu))
    got = physics.cse_mag_fit(_t(a_mag), _t(r2), _t(te),
                              r2s_nu=None if nu is None else _t(nu))
    assert (a_mag == 0).mean() > 0.1  # the zero background is in
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_cse_mag_fit_on_random_magnitudes():
    """The JAX kernel test's inputs: |N(0, 1)| echoes, R2* ~ U(0, 0.4).
    Where the LS b coefficient is near 0 the fat part of the eigenvector,
    λmax − a, cancels: its error is float32's relative to the voxel's
    whole ρ, not to |F|. Outside those voxels and the thresholds' few, the
    tight tolerance holds."""
    rng = np.random.default_rng(5)
    a_mag = np.abs(rng.normal(size=(2, NE, 16, 128, 1))).astype(np.float32)
    r2 = rng.uniform(0, 0.4, (2, 1, 16, 128, 1)).astype(np.float32)
    te = np.asarray(jph.te_train(NE, bs=2))
    ref = jph.cse_mag_fit(jnp.asarray(a_mag), jnp.asarray(r2),
                          jnp.asarray(te))
    got = physics.cse_mag_fit(_t(a_mag), _t(r2), _t(te))
    beyond = {}
    for name in FIELDS:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=5e-4, err_msg=name)
        scale = np.abs(r)
        if name == "rho":
            scale = np.linalg.norm(r, axis=1, keepdims=True)
        beyond[name] = int((np.abs(g - r) > 1e-5 + 1e-4 * scale).sum())
    print("elements beyond rtol 1e-4 / atol 1e-5 (ρ: of the voxel's |ρ|):",
          beyond)
    assert sum(beyond.values()) <= 1e-3 * a_mag.size


@pytest.mark.parametrize("te_kind", ["uniform", "jittered"])
def test_cse_mag_fused_matches_pallas_interpret(te_kind):
    """The JAX package's fused kernel (interpret mode) against the port's
    entry point on CPU tensors (its plain version), at W = 128, on the
    cohort's magnitudes."""
    a_mag, r2, te = _cohort_mag(h=8)
    if te_kind == "jittered":
        te = _te("jittered", 2)
    ref = jops.cse_mag_fused(jnp.asarray(a_mag), jnp.asarray(r2),
                             jnp.asarray(te))
    got = ops.cse_mag_fused(_t(a_mag), _t(r2), _t(te))
    assert isinstance(got, physics.CSEMagResult)
    for name, r in zip(("rho", "recon", "ls_coeffs", "uncertainty"), ref):
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=1e-3,
                                   atol=5e-4, err_msg=name)
    np.testing.assert_array_equal(
        got.demod.numpy(), physics.cse_mag_fit(_t(a_mag), _t(r2),
                                               _t(te)).demod.numpy())


@pytest.mark.parametrize("with_nu", [False, True])
def test_cse_mag_fused_gradient_matches_jax(with_nu):
    """d/d(out_maps, ν) of a scalar over recon, ls_coeffs and demod, with the
    zero background (where the double wheres keep sqrt'(0) out)."""
    a_mag, r2, te = _cohort_mag(nb=1, h=8)
    nu = np.clip(r2 + 0.1, 0, 1).astype(np.float32)

    def scalar(res):
        return ((res.recon ** 2).mean() + res.ls_coeffs.mean()
                + 1e-3 * res.demod.mean())

    def j_loss(r, n):
        return scalar(jph.cse_mag_fit(jnp.asarray(a_mag), r, jnp.asarray(te),
                                      r2s_nu=n if with_nu else None))

    j_r, j_n = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(r2),
                                                          jnp.asarray(nu))
    r = _t(r2).requires_grad_()
    n = _t(nu).requires_grad_()
    scalar(ops.cse_mag_fused(_t(a_mag), r, _t(te),
                             r2s_nu=n if with_nu else None)).backward()
    assert torch.isfinite(r.grad).all()
    np.testing.assert_allclose(r.grad.numpy(), j_r, rtol=1e-3, atol=1e-5)
    if with_nu:
        np.testing.assert_allclose(n.grad.numpy(), j_n, rtol=1e-3,
                                   atol=1e-5)
    else:
        assert n.grad is None


# --------------------------------------------------------------------------
# the Rician posterior
# --------------------------------------------------------------------------

def test_rician_matches_jax():
    rng = np.random.default_rng(3)
    nu = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    sigma = rng.uniform(0.02, 0.5, 64).astype(np.float32)
    x = rng.uniform(-0.1, 1.5, 64).astype(np.float32)  # x ≤ 0: zeroed

    def j_stats(n, s):
        r = JRician(n, s)
        return r.log_prob(jnp.asarray(x)), r.mean(), r.variance()

    def j_sum(n, s):
        return sum(jnp.sum(v) for v in j_stats(n, s))

    ref = jax.jit(j_stats)(jnp.asarray(nu), jnp.asarray(sigma))
    j_n, j_s = jax.jit(jax.grad(j_sum, argnums=(0, 1)))(jnp.asarray(nu),
                                                        jnp.asarray(sigma))
    n, s = _t(nu).requires_grad_(), _t(sigma).requires_grad_()
    dist = Rician(n, s)
    got = (dist.log_prob(_t(x)), dist.mean(), dist.variance())
    for g, r, atol in zip(got, ref, (1e-4, 1e-6, 1e-6)):
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=1e-5,
                                   atol=atol)
    assert torch.equal(dist.mode_param(), n)
    sum(v.sum() for v in got).backward()
    np.testing.assert_allclose(n.grad.numpy(), j_n, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s.grad.numpy(), j_s, rtol=1e-5, atol=1e-3)


# --------------------------------------------------------------------------
# the UNet with TE input and σ head, and Mag serving
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mag_serving():
    """The synthetic cohort, the Flax magnitude UNet of `mag.DEFAULTS` with a
    Rician head (te_input, bayesian, sigmoid, self-attention) at F=4 with
    random parameters, and the JAX composition of the Mag branch of
    `cli/roi_analysis.py` (model.apply, the Rician mean, cse_mag_fit)."""
    acqs, _, te = (np.array(x) for x in j_synthetic(3, h=SIZE,
                                                     w=SIZE, ne=NE))
    a_mag = np.sqrt(np.sum(np.square(acqs), -1, keepdims=True))
    jm = JUNet(n_out=1, bayesian=True, me_layer=True, te_input=True,
               filters=F_SMALL, output_activation="sigmoid",
               self_attention=True)
    p = _random_params(jm, 3, jnp.asarray(a_mag[:1]), jnp.asarray(te[:1, :,
                                                                      0]))

    @jax.jit
    def compose(params, a, t):
        out = jm.apply({"params": params}, a, t[..., 0])
        r2 = out.mean()
        res = jph.cse_mag_fit(a, r2, t)
        wf = jnp.concatenate([res.rho, jnp.zeros_like(res.rho)], -1)
        pm = jnp.concatenate([jnp.zeros_like(r2), r2], axis=-1)
        var = jnp.concatenate([res.uncertainty] * 4, axis=1)
        return out.nu, out.sigma, jnp.concatenate([wf, pm], axis=1), var

    ref = [np.asarray(v) for v in compose(p, jnp.asarray(a_mag),
                                          jnp.asarray(te))]
    return acqs, a_mag, te, p, ref


def test_unet_te_input_sigma_head_matches_flax(mag_serving):
    _, a_mag, te, p, (nu, sigma, _, _) = mag_serving
    tm = models.UNet(1, n_out=1, bayesian=True, te_input=True,
                     filters=F_SMALL, output_activation="sigmoid",
                     self_attention=True)
    tm.load_state_dict(convert.unet(p))
    out = tm(_t(a_mag), _t(te[..., 0]))
    assert isinstance(out, Rician) \
        and out.nu.shape == (3, 1, SIZE, SIZE, 1)
    np.testing.assert_allclose(out.nu.detach().numpy(), nu, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out.sigma.detach().numpy(), sigma, rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="TE"):
        tm(_t(a_mag))
    point, std = models.UNet(1, std_out=True, te_input=True,
                             filters=F_SMALL)(_t(a_mag), _t(te[..., 0]))
    assert point.shape == std.shape == (3, 1, SIZE, SIZE, 1)
    with pytest.raises(NotImplementedError, match="skip_con"):
        models.UNet(1, bayesian=True, skip_con=False)


def test_mag_serving_matches_jax(mag_serving, tmp_path):
    acqs, _, te, p, (_, _, maps_ref, var_ref) = mag_serving
    weights = tmp_path / "mag.npz"
    np.savez(weights, **_flat(p, "params/"))
    cfg = dict(infer.DEFAULTS, model_sel="Mag", weights=str(weights))
    _, mcfg = roi_analysis.load_mag_model(cfg, "cpu")
    assert (mcfg["n_G_filters"], mcfg["main_loss"], mcfg["training_mode"],
            mcfg["D1_SelfAttention"]) == (F_SMALL, "Rice", "supervised", True)
    run = roi_analysis.make_infer_run(cfg, acqs, device="cpu")
    # batch 2 over 3 slices: the last chunk is padded, then trimmed
    maps, var = roi_analysis._per_slice(run, acqs, te, 2, device="cpu")
    n = SIZE
    assert maps.shape == (3, 3, n, n, 2) and var.shape == (3, 4, n, n, 1)
    assert not maps[:, :2, ..., 1].any() and not maps[:, 2, ..., 0].any()
    np.testing.assert_allclose(maps[:, 2], maps_ref[:, 2], rtol=1e-4,
                                atol=1e-4)
    np.testing.assert_allclose(var, var_ref, rtol=1e-4, atol=1e-4)
    # ρ: the random net's R2* puts the LS coefficients far from a physical
    # fit, with b ≈ 0 at some voxels, where the eigenvector's fat part
    # λmax − a cancels (the fit alone, on the same R2*, differs there by
    # up to 4e-4 of the voxel's |ρ|): held per voxel, as the JAX kernel's
    # rtol 1e-3 / atol 5e-4 against the voxel's |ρ|
    rho, rho_ref = maps[:, :2, ..., 0], maps_ref[:, :2, ..., 0]
    scale = np.linalg.norm(rho_ref, axis=1, keepdims=True)
    assert (np.abs(rho - rho_ref) <= 5e-4 + 1e-3 * scale).all()


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

def _models(cfg):
    """The Flax and port UNets `mag.build_model` builds for `cfg`, at
    LAYERS levels (two levels keep the JAX compile short)."""
    kw = dict(n_out=1, bayesian=cfg["main_loss"] == "Rice",
              te_input=cfg["training_mode"] == "supervised", filters=F_SMALL,
              output_activation="sigmoid",
              self_attention=cfg["D1_SelfAttention"], num_layers=LAYERS)
    return JUNet(me_layer=True, **kw), models.UNet(1, **kw)


@pytest.mark.parametrize("variant", ["defaults", "unsupervised_regs",
                                     "supervised_rice"])
def test_mag_step_matches_jax(variant):
    over = {"defaults": {}, "unsupervised_regs": UNSUP_REGS,
            "supervised_rice": dict(main_loss="Rice")}[variant]
    cfg = dict(jmag.DEFAULTS, n_G_filters=F_SMALL, **over)
    _, maps, te = (np.array(x) for x in j_synthetic(2, h=SIZE, w=SIZE,
                                                     ne=NE))
    # no exactly zero background: its |A| = 0 makes the ConvLSTM's g gate
    # sit on leaky_relu's kink
    maps = maps + 1e-3 * np.random.default_rng(4).normal(
        size=maps.shape).astype(np.float32)
    jm, tm = _models(cfg)
    args = [jnp.zeros((1, NE, SIZE, SIZE, 1))]
    if cfg["training_mode"] == "supervised":
        args.append(jnp.asarray(te[:1, :, 0]))
    p = _random_params(jm, 9, *args)
    (j_val, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        jmag.make_loss_fn(cfg, jm), has_aux=True))(
            p, jnp.asarray(maps), jnp.asarray(te), jax.random.PRNGKey(0))

    tm.load_state_dict(convert.unet(p, LAYERS))
    loss, metrics = tmag.make_loss_fn(cfg, tm)(_t(maps), _t(te))
    loss.backward()
    assert set(metrics) == set(j_metrics)
    rel = {k: abs(float(metrics[k].detach()) - float(j_metrics[k]))
           / max(abs(float(j_metrics[k])), 1e-12) for k in metrics}
    grads = {n: q.grad.numpy() for n, q in tm.named_parameters()
             if q.requires_grad}
    worst = _worst_grad(grads, convert.unet(j_grads, LAYERS))
    print(f"{variant}: metrics rel diff {rel}, worst gradient leaf {worst}")
    assert max(rel.values()) <= 2e-5
    assert abs(float(loss.detach()) - float(j_val)) \
        <= 2e-5 * abs(float(j_val))
    assert worst <= 2e-2


def test_train_step_and_unported_settings():
    _, maps, te = (np.array(x) for x in j_synthetic(2, h=SIZE, w=SIZE,
                                                     ne=NE))
    cfg = dict(tmag.DEFAULTS, n_G_filters=F_SMALL, lr=2e-3, **UNSUP_REGS)
    model = tmag.build_model(cfg)
    step, tx = tmag.make_train_step(cfg, model)
    state = tmag.init_state(cfg, model, tx, torch.Generator().manual_seed(0),
                            "cpu")
    losses = []
    for _ in range(3):
        state, m = step(state, (_t(maps), _t(te)))
        losses.append(float(m["G_loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.step == state.opt.count == 3
    assert all(q.grad is not None and bool(q.grad.abs().max() > 0)
               for n, q in model.lstm.named_parameters())
    # bf16 and remat are ported: the same module tree (state-dict names),
    # a bf16 compute dtype, and remat on the net
    keys = set(model.state_dict())
    for over, attr, want in ((dict(bf16=True), "dtype", torch.bfloat16),
                             (dict(remat=True), "remat", True)):
        net = tmag.build_model(dict(cfg, **over))
        assert getattr(net, attr) == want and set(net.state_dict()) == keys


# --------------------------------------------------------------------------
# the CLIs and the device rule
# --------------------------------------------------------------------------

def _train_cli(tmp_path, epochs):
    return train_mag.main(
        ["--device", "cpu", "--synthetic", "4", "--data_size", "32",
         "--batch_size", "2", "--n_G_filters", str(F_SMALL), "--epochs",
         str(epochs), "--output_base", str(tmp_path)])


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    out = _train_cli(tmp_path, 2)
    ckdir = tmp_path / "Mag-300" / "checkpoints"
    assert Checkpoint(ckdir).latest_step() == 2
    assert [e["epoch"] for e in out["epochs"]] == [1, 2]
    assert out["state"].step == 4  # 4 slices at batch 2, 2 epochs
    saved = Checkpoint(ckdir).restore(2)
    again = _train_cli(tmp_path, 3)
    assert [e["epoch"] for e in again["epochs"]] == [3]
    assert again["state"].opt.count == saved["opt"]["count"] + 2
    text = capsys.readouterr().out
    assert "resumed from epoch 2" in text
    assert "epoch 2/2 G_loss=" in text and "epoch 3/3 G_loss=" in text


def test_infer_cli_serves_mag(tmp_path, capsys):
    maps = infer.main(["--device", "cpu", "--model_sel", "Mag",
                       "--synthetic", "2", "--data_size", "32",
                       "--infer_batch", "2", "--output_base", str(tmp_path)])
    assert maps.shape == (2, 3, 32, 32, 2) and np.isfinite(maps).all()
    with np.load(tmp_path / "infer" / "maps_pred.npz") as npz:
        np.testing.assert_array_equal(npz["maps"], maps)
    assert "slices/s steady-state" in capsys.readouterr().out


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = tmag.build_model(dict(tmag.DEFAULTS, n_G_filters=F_SMALL))
    _, tx = tmag.make_train_step(tmag.DEFAULTS, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmag.init_state(tmag.DEFAULTS, model, tx, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mag.main(["--synthetic", "2", "--data_size", "32",
                        "--batch_size", "2", "--n_G_filters", "4",
                        "--output_base", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        roi_analysis.make_infer_run(dict(infer.DEFAULTS, model_sel="Mag"),
                                    None)
