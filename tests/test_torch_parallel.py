"""The port's data mesh, sharded serving fit and data-parallel steps
(`ideal_gan_tpu_torch.parallel`, the trainers' `mesh=`) against the JAX
package and against the port's one-process step.

- The mesh helpers against JAX's on the conftest's 8-device CPU mesh.
- `make_sharded_fit` over 2 and 8 CPU "devices", slice and H split,
  against JAX's `make_sharded_fit` at its rtol 1e-4 / atol 1e-5, and the
  indivisible case.
- One module fixture starts two `gloo` ranks once (this file run as a
  script, `file://` rendezvous, a 60 s group timeout, a join timeout and a
  kill). Each rank runs every family's step on its rows of a tiny global
  batch and writes an npz; each family is then a case: the two-rank step
  against the port's one-process step at JAX's gates (loss rtol 1e-5, mag
  1e-4; parameters after Adam atol 2·lr, rtol 1e-3:
  `tests/test_parallel.py` says why), the reduced gradients within 1e-9
  of scale where the nets run in float64, and the two ranks' parameters
  bit for bit.
- The unsup FM step of the two ranks against JAX's step on its 8-device
  mesh, at the port's step gates (loss 2e-5, gradients 2e-2 of scale).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from ideal_gan_tpu_torch import physics  # noqa: E402
from ideal_gan_tpu_torch.cli.common import synthetic_dataset  # noqa: E402
from ideal_gan_tpu_torch.data import ItemPool  # noqa: E402
from ideal_gan_tpu_torch.parallel import data_mesh, shard_batch  # noqa: E402
from ideal_gan_tpu_torch.parallel.mesh import (all_gather_rows,  # noqa: E402
                                               rank_rows, reduce_metrics)
from ideal_gan_tpu_torch.train import (gan, ldm, mag, single, sup,  # noqa: E402
                                       teaug, unsup)

SIZE, F, NB = 32, 4, 4
# the families whose nets run in float64 in these cases (their outputs are
# cast to float32 before the physics, as the trainers cast a bf16 net's)
F64 = ("unsup_fm", "unsup_r2", "uq", "uq_calib", "teaug", "teaug_micro",
       "sup", "mag", "single", "ldm")
FAMILIES = F64[:-1] + ("gan_g", "gan_d", "gan_vq", "ldm")
LR = {"unsup_fm": 2e-4, "unsup_r2": 2e-4, "uq": 2e-4, "uq_calib": 2e-4,
      "teaug": 2e-4, "teaug_micro": 2e-4, "sup": 5e-4, "mag": 2e-4,
      "single": 8e-4, "gan_g": 2e-4, "gan_d": 2e-4, "gan_vq": 2e-4,
      "ldm": 1e-4}
GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 240


def _cohort():
    acqs, maps, te = synthetic_dataset(NB, SIZE, SIZE)
    rng = np.random.default_rng(5)
    # no exactly-zero background: ReLU ties route gradients by rounding
    acqs = acqs + 1e-3 * rng.standard_normal(acqs.shape).astype(np.float32)
    return acqs, maps, te


def _gan_batch():
    rng = np.random.default_rng(0)
    shape = (NB, SIZE, SIZE)
    ff, pd, r2s = (rng.uniform(lo, hi, shape).astype(np.float32)
                   for lo, hi in ((0, .6), (.3, .9), (0, .4)))
    pha, phi = (rng.uniform(-.2, .2, shape).astype(np.float32)
                for _ in range(2))
    B = np.stack([np.stack([ff, np.zeros_like(ff)], -1),
                  np.stack([pd, r2s], -1), np.stack([pha, phi], -1)], 1)
    te = physics.te_train(6, bs=NB)
    A = physics.synthesize_mag(torch.from_numpy(B), te).numpy()
    return A, B, te.numpy()


def _to64(nets, opts):
    """Nets and their optimizers' moments in float64."""
    for n in nets:
        n.double()
    for o in opts:
        if hasattr(o, "mu"):
            o.mu = [torch.zeros_like(p) for p in o.params]
            o.nu = [torch.zeros_like(p) for p in o.params]


def _flat(ts):
    return np.concatenate([t.detach().double().reshape(-1).numpy()
                           for t in ts])


def _grads(params):
    return _flat([torch.zeros_like(p) if p.grad is None else p.grad
                  for p in params])


def _cast(batch, dtype):
    return tuple(x if x is None or not x.is_floating_point()
                 else x.to(dtype) for x in batch)


def family_step(name: str, mesh=None) -> dict:
    """One step of `name` on the global batch (the rank's rows on a mesh):
    its loss (averaged over the ranks), the trained parameters after it and
    their gradients (averaged over the ranks by the optimizer)."""
    f64 = name in F64
    dt = torch.float64 if f64 else torch.float32
    gen = torch.Generator().manual_seed(0)
    place = (lambda b: shard_batch(b, mesh)) if mesh is not None else \
        (lambda b: tuple(torch.as_tensor(x) for x in b))
    acqs, maps, te = _cohort()
    if name.startswith(("unsup", "uq")):
        over = {"unsup_fm": dict(out_vars="FM", FM_TV_weight=1e-3,
                                 FM_L1_weight=1e-2, learn_fm_offset=True),
                "unsup_r2": dict(out_vars="PM", R2_TV_weight=1e-3,
                                 R2_L1_weight=1e-2),
                "uq": dict(out_vars="PM", UQ=True, UQ_R2s=True,
                           FM_TV_weight=1e-3),
                "uq_calib": dict(out_vars="PM", UQ=True, UQ_R2s=True)}
        cfg = dict(unsup.DEFAULTS, n_G_filters=F, batch_size=NB, epochs=1,
                   **over[name])
        g_fm, g_r2 = unsup.build_models(cfg)
        step, tx = unsup.make_train_step(cfg, g_fm, g_r2, mesh)
        state = unsup.init_state(cfg, g_fm, g_r2, tx, gen, "cpu", mesh)
        _to64([g_fm, g_r2], [state.opt_fm, state.opt_r2])
        state.fm_offset = state.fm_offset.to(dt)
        with torch.no_grad():
            state.calib.data = state.calib.data.to(dt)
        batch = _cast(place((acqs, te)), dt)
        if name == "unsup_r2":
            step = unsup.make_r2_train_step(cfg, g_fm, g_r2, tx, mesh)
            params = list(g_r2.parameters())
        elif name == "uq_calib":
            step = unsup.make_calib_train_step(cfg, g_fm, g_r2)
            params = [state.calib]
        else:
            params = list(g_fm.parameters())
        state, metrics = step(state, batch)
        loss = next(metrics[k] for k in ("G_loss", "R2_cycle_loss",
                                         "calib_loss") if k in metrics)
        extra = [state.fm_offset] if name == "unsup_fm" else []
    elif name.startswith("teaug"):
        cfg = dict(teaug.DEFAULTS, n_G_filters=F, batch_size=NB, epochs=1,
                   R2_TV_weight=1e-3, FM_TV_weight=1e-3,
                   microbatch=1 if name == "teaug_micro" else 0)
        model = teaug.build_model(cfg)
        step, tx = teaug.make_train_step(cfg, model, mesh=mesh)
        state = teaug.init_state(cfg, model, tx, gen, "cpu")
        _to64([model], [state.opt])
        te_b = teaug.sample_te(torch.Generator().manual_seed(2), cfg, NB)
        batch = _cast(place((maps, te_b)), dt)
        state, metrics = step(state, batch,
                              torch.Generator().manual_seed(3))
        params, loss, extra = list(model.parameters()), metrics["G_loss"], []
    elif name == "sup":
        cfg = dict(sup.DEFAULTS, n_G_filters=F, batch_size=NB, epochs=1,
                   G_model="U-Net", out_vars="PM", sigma_noise=1e-2,
                   R2_TV_weight=1e-3, FM_TV_weight=1e-3, R2_L1_weight=1e-2,
                   FM_L1_weight=1e-2)
        model = sup.build_model(cfg)
        step, tx = sup.make_train_step(cfg, model, mesh)
        state = sup.init_state(cfg, model, tx, gen, "cpu")
        _to64([model], [state.opt])
        batch = _cast(place((acqs, maps, te)), dt)
        state, metrics = step(state, batch, torch.Generator().manual_seed(3))
        params, loss, extra = list(model.parameters()), metrics["G_loss"], []
    elif name == "mag":
        cfg = dict(mag.DEFAULTS, n_G_filters=F, batch_size=NB, epochs=1,
                   main_loss="Rice", R2_TV_weight=1e-3,
                   A_demod_TV_weight=1e-3, LS_NZ_weight=1e-3,
                   LS_cond_weight=1e-3)
        model = mag.build_model(cfg)
        step, tx = mag.make_train_step(cfg, model, mesh)
        state = mag.init_state(cfg, model, tx, gen, "cpu")
        _to64([model], [state.opt])
        state, metrics = step(state, _cast(place((maps, te)), dt))
        params, loss, extra = list(model.parameters()), metrics["G_loss"], []
    elif name == "single":
        cfg = dict(single.DEFAULTS, n_G_filters=F, BP_GR_weight=1e-3,
                   FM_TV_weight=1e-3, FM_L1_weight=1e-3)
        g_mag, g_pha = single.build_models(cfg)
        step, tx = single.make_train_step(cfg, g_mag, g_pha, mesh)
        state = single.init_state(cfg, g_mag, g_pha, tx, gen, "cpu")
        _to64([g_mag, g_pha], [state.opt])
        state, metrics = step(state, _cast(place((acqs, maps, te)), dt))
        params = list(g_mag.parameters()) + list(g_pha.parameters())
        loss, extra = metrics["G_loss"], []
    elif name.startswith("gan"):
        cfg = dict(gan.DEFAULTS, n_G_filters=12, n_downsamplings=2,
                   n_res_blocks=1, encoded_size=12, n_D_filters=8,
                   batch_size=NB, epochs=2, A_loss="pix-wise",
                   adv_train=True, cov_reg_weight=1e-2,
                   VQ_encoder=name == "gan_vq", VQ_num_embed=8)
        models = gan.build_models(cfg)
        g_step, d_step, txs = gan.make_train_steps(
            cfg, models, generator=torch.Generator().manual_seed(3),
            mesh=mesh)
        state = gan.init_state(cfg, models, txs, gen, "cpu")
        A, B, te_b = place(_gan_batch())
        state, metrics, fake = g_step(state, (A, B, te_b))
        params, loss = gan.g_parameters(models), metrics["G_loss"]
        if name == "gan_vq":    # the global batch's code usage
            loss = metrics["VQ_perplexity"]
        if name == "gan_d":
            pool = ItemPool(4, seed=0)
            pool(np.zeros((NB,) + tuple(fake.shape[1:]), np.float32))
            pooled = rank_rows(torch.from_numpy(pool(
                all_gather_rows(fake, mesh).numpy())), mesh)
            state, d_metrics = d_step(state, A, pooled)
            params = list(models.disc.parameters())
            loss = d_metrics["D_loss"]
        extra = []
    elif name == "ldm":
        cfg = dict(ldm.DEFAULTS, n_timesteps=8, n_ldm_filters=8,
                   dim_mults=(1, 2), in_res=8, batch_size=NB, epochs=1)
        model = ldm.build_model(cfg, channels=6)
        step, tx = ldm.make_train_step(
            cfg, model, ldm.build_schedule(cfg),
            torch.Generator().manual_seed(3), mesh)
        state = ldm.init_state(cfg, model, tx, gen, "cpu")
        _to64([model], [state.opt])
        z = np.random.default_rng(3).normal(size=(NB, 8, 8, 6))
        batch = place((z.astype(np.float32), np.zeros(NB, np.int64)))
        state, metrics = step(state, _cast(batch, dt))
        params, loss, extra = list(model.parameters()), metrics["G_loss"], []
    else:
        raise ValueError(name)
    loss = reduce_metrics({"loss": loss}, mesh)["loss"]
    return {"loss": float(loss), "params": _flat(params + extra),
            "grads": _grads(params)}


def _worker(rank: int, init: str, out_dir: str, weights: str) -> None:
    """One of the two `gloo` ranks: every family's step, then the JAX
    comparison's FM step, written to <out_dir>/rank<r>.npz."""
    torch.set_num_threads(1)
    from ideal_gan_tpu_torch.parallel import initialize_distributed
    assert initialize_distributed(init, 2, rank, device="cpu",
                                  timeout_s=GROUP_TIMEOUT_S)
    mesh = data_mesh(device="cpu")
    out = {}
    for name in FAMILIES:
        for k, v in family_step(name, mesh).items():
            out[f"{name}/{k}"] = v
    for k, v in jax_case_step(torch.load(weights), mesh).items():
        out[f"jax_fm/{k}"] = v
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()


JAX_CFG = dict(out_vars="FM", FM_TV_weight=1e-3, FM_L1_weight=1e-2,
               n_G_filters=F, batch_size=8, epochs=1)


def jax_case_step(weights: dict, mesh) -> dict:
    """The port's unsup FM step from `weights` ({"g_fm", "g_r2"} state
    dicts) on the rank's rows of the global batch of 8: the loss and Adam's
    first moment over (1 − β1), the clipped gradients."""
    cfg = dict(unsup.DEFAULTS, **JAX_CFG)
    acqs, _, te = synthetic_dataset(8, SIZE, SIZE)
    g_fm, g_r2 = unsup.build_models(cfg)
    g_fm.load_state_dict(weights["g_fm"])
    g_r2.load_state_dict(weights["g_r2"])
    step, tx = unsup.make_train_step(cfg, g_fm, g_r2, mesh)
    state = unsup.UnsupState(
        g_fm, tx(g_fm.parameters()), g_r2, tx(g_r2.parameters()),
        torch.ones(6, requires_grad=True), None, torch.zeros(()))
    batch = (shard_batch((acqs, te), mesh) if mesh is not None
             else (torch.from_numpy(acqs), torch.from_numpy(te)))
    state, metrics = step(state, batch)
    loss = reduce_metrics({"loss": metrics["G_loss"]}, mesh)["loss"]
    names = [n for n, _ in g_fm.named_parameters()]
    return {"loss": float(loss), "names": np.array(names),
            **{f"g.{n}": (m / (1 - cfg["beta_1"])).numpy()
               for n, m in zip(names, state.opt_fm.mu)}}


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4])
    sys.exit(0)


# ---------------------------------------------------------------- tests
import pytest  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401


def run_ranks(argv_of, out_dir: Path, n: int = 2,
              timeout: float = JOIN_TIMEOUT_S, env=None) -> list:
    """Start `n` processes (process i runs the command `argv_of(i)`), wait
    for all of them up to `timeout` s and kill every one left after it;
    their outputs. Fails where one exits non-zero or times out."""
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    logs = [open(out_dir / f"proc{i}.log", "w+") for i in range(n)]
    procs = [subprocess.Popen(argv_of(i), stdout=logs[i],
                              stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for i in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n{out}"
    return outs


@pytest.fixture(scope="module")
def jax_weights():
    """Flax parameters of the unsup nets (perturbed), as JAX's trees and as
    the port's state dicts."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ideal_gan_tpu.train import unsup as junsup
    from ideal_gan_tpu_torch import convert
    from test_torch_models import flax_params

    cfg = dict(junsup.DEFAULTS, **JAX_CFG)
    jg_fm, jg_r2 = junsup.build_models(cfg)
    acqs, _, te = synthetic_dataset(8, SIZE, SIZE)
    a = jnp.asarray(acqs[:1])
    a_abs = jnp.sqrt(jnp.sum(jnp.square(a), axis=-1, keepdims=True))
    p_fm = flax_params(jg_fm, a, 21, noise=0.02)
    p_r2 = flax_params(jg_r2, a_abs, 22, noise=0.02)
    del jax
    return p_fm, p_r2, {"g_fm": convert.unet(p_fm),
                        "g_r2": convert.unet(p_r2)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_weights):
    """The two gloo ranks' npz results (started once for the module)."""
    out = tmp_path_factory.mktemp("ranks")
    torch.save({k: {n: torch.as_tensor(np.asarray(v)) for n, v in sd.items()}
                for k, sd in jax_weights[2].items()}, out / "weights.pt")
    init = f"file://{out / 'rendezvous'}"
    run_ranks(lambda i: [sys.executable, __file__, str(i), init, str(out),
                         str(out / "weights.pt")], out)
    return [dict(np.load(out / f"rank{i}.npz")) for i in range(2)]


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_matches_one_process(ranks, family):
    ref = family_step(family)
    r0, r1 = ({k.split("/", 1)[1]: v for k, v in r.items()
               if k.startswith(family + "/")} for r in ranks)
    np.testing.assert_array_equal(r0["params"], r1["params"])
    np.testing.assert_array_equal(r0["loss"], r1["loss"])
    rtol = 1e-4 if family == "mag" else 1e-5
    np.testing.assert_allclose(float(r0["loss"]), ref["loss"], rtol=rtol)
    np.testing.assert_allclose(r0["params"], ref["params"],
                               atol=2 * LR[family], rtol=1e-3)
    if family in F64:
        scale = np.abs(ref["grads"]).max()
        assert scale > 0
        worst = np.abs(r0["grads"] - ref["grads"]).max() / scale
        assert worst <= 1e-9, worst


def test_two_rank_unsup_step_matches_jax_mesh(ranks, jax_weights):
    """The slice as a whole: the unsup FM step on two port ranks (4 rows
    each) against JAX's on its 8-device mesh (one row each)."""
    import jax
    import jax.numpy as jnp

    from ideal_gan_tpu.parallel import data_mesh as jdata_mesh
    from ideal_gan_tpu.parallel import shard_batch as jshard
    from ideal_gan_tpu.train import unsup as junsup
    from ideal_gan_tpu_torch import convert

    p_fm, p_r2, _ = jax_weights
    cfg = dict(junsup.DEFAULTS, **JAX_CFG)
    jg_fm, jg_r2 = junsup.build_models(cfg)
    step, tx = junsup.make_train_step(cfg, jg_fm, jg_r2)
    acqs, _, te = synthetic_dataset(8, SIZE, SIZE)
    state = junsup.init_state(cfg, jg_fm, jg_r2, tx, jax.random.PRNGKey(0),
                              acqs[:1])
    state = state._replace(params_fm=p_fm, opt_fm=tx.init(p_fm),
                           params_r2=p_r2, opt_r2=tx.init(p_r2))
    batch = jshard((jnp.asarray(acqs), jnp.asarray(te)), jdata_mesh())
    state, metrics = step(state, batch, jax.random.PRNGKey(0))
    mu = next(s.mu for s in jax.tree_util.tree_leaves(
        state.opt_fm, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    j_grads = {k: np.asarray(v) / (1 - cfg["beta_1"])
               for k, v in convert.unet(mu).items()}
    r0 = {k.split("/", 1)[1]: v for k, v in ranks[0].items()
          if k.startswith("jax_fm/")}
    rel = abs(float(r0["loss"]) - float(metrics["G_loss"])) \
        / max(abs(float(metrics["G_loss"])), 1.0)
    assert rel <= 2e-5, rel
    names = [str(n) for n in r0["names"]]
    assert set(names) == set(j_grads)
    scale = max(np.abs(v).max() for v in j_grads.values())
    worst = max(np.abs(r0[f"g.{n}"] - j_grads[n]).max() for n in names)
    assert worst / scale <= 2e-2, worst / scale
    # the port's one-process step on the whole batch gives the same
    one = jax_case_step(jax_weights[2], None)
    np.testing.assert_allclose(float(r0["loss"]), one["loss"], rtol=1e-5)


def test_mesh_helpers_match_jax():
    """`tests/test_parallel.py::test_mesh_helpers` at one process: the
    port's mesh is the ranks (one here), JAX's the 8 CPU devices."""
    import jax

    from ideal_gan_tpu import parallel as jpar
    from ideal_gan_tpu_torch import parallel as tpar

    jmesh = jpar.data_mesh()
    mesh = tpar.data_mesh(device="cpu")
    assert jmesh.devices.size == 8 and mesh.size == 1
    assert mesh.shape == {"data": 1} and mesh.active and mesh.index == 0
    assert tpar.data_mesh(model=1, device="cpu").axis_names == ("data",)
    assert jpar.data_mesh(model=2).shape == {"data": 4, "model": 2}
    # the batch-size rule: the most devices that divide the batch
    assert tpar.data_mesh_for_batch(6, device="cpu").size == 1
    assert jpar.data_mesh_for_batch(6).devices.size == 6
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    xs = tpar.shard_batch((x, None), mesh)
    assert xs[1] is None and torch.equal(xs[0], torch.from_numpy(x))
    r = tpar.replicate(mesh)(np.zeros(3))
    assert r.shape == (3,) and r.device.type == "cpu"
    assert np.array_equal(np.asarray(jax.device_put(
        x, jpar.batch_sharding(jmesh))), tpar.batch_sharding(mesh)(x))


def _planar(nb, h=16, w=128, seed=3):
    acqs, maps, te = synthetic_dataset(nb, h, w, seed=seed)
    return (acqs[..., 0], acqs[..., 1], maps[:, 2, ..., 0],
            maps[:, 2, ..., 1], te)


@pytest.mark.parametrize("n_dev, voxel_axis, nb",
                         [(2, False, 8), (8, False, 8), (2, True, 2),
                          (8, True, 2)])
def test_sharded_fit_matches_jax(n_dev, voxel_axis, nb):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ideal_gan_tpu.parallel import make_sharded_fit as jfit
    from ideal_gan_tpu_torch.parallel import make_sharded_fit

    args = _planar(nb)
    jmesh = Mesh(np.asarray(jax.devices()[:n_dev]), ("data",))
    ref = jfit(jmesh, voxel_axis=voxel_axis)(*(jnp.asarray(a)
                                              for a in args))
    fit = make_sharded_fit(["cpu"] * n_dev, voxel_axis=voxel_axis)
    out = fit(*(torch.from_numpy(a) for a in args))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)
    # one device: the same call as `fit_rho_planar`
    from ideal_gan_tpu_torch.ops import fit_rho_planar
    whole = fit_rho_planar(*(torch.from_numpy(a) for a in args))
    for o, w in zip(out, whole):
        assert torch.equal(o, w)


def test_sharded_fit_indivisible_axis_raises():
    from ideal_gan_tpu_torch.parallel import make_sharded_fit
    args = [torch.from_numpy(a) for a in _planar(6)]
    with pytest.raises(ValueError, match="divide"):
        make_sharded_fit(["cpu"] * 4)(*args)
    with pytest.raises(ValueError, match="divide"):
        make_sharded_fit(["cpu"] * 3, voxel_axis=True)(*args)


@pytest.mark.parametrize("batch", [4, 3])
def test_serving_split_over_two_devices(batch):
    """`_per_slice` over a two-device `Replicas`: the chunk split in two
    where 2 divides it, kept whole where it does not (3), rows in order."""
    from ideal_gan_tpu_torch.cli import infer, roi_analysis

    cfg = dict(infer.DEFAULTS, model_sel="AI-DEAL", seed=0)
    acqs, _, te = synthetic_dataset(5, SIZE, SIZE)
    split = roi_analysis.make_infer_run(cfg, acqs, "cpu", ["cpu", "cpu"])
    assert isinstance(split, roi_analysis.Replicas) and len(split) == 2
    one = roi_analysis.make_infer_run(cfg, acqs, "cpu", ["cpu"])
    assert not isinstance(one, roi_analysis.Replicas)
    got = roi_analysis._per_slice(split, acqs, te, batch, "cpu")
    want = roi_analysis._per_slice(one, acqs, te, batch, "cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (5,) + g.shape[1:]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)

