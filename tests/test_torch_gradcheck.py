"""The gradient-flow check (`cli.test_gradients`) and the NaN sanitizer
(`--debug_nans`, `utils.nans`) of the port vs the JAX package.

The JAX harness runs as its CLI, with its weights (the UQ nets' Flax
parameters, traced with `jax.eval_shape` and filled from a seed: an eager
Flax init of the two nets takes ~26 s), its batch and its gradient tree
taken from inside it by `monkeypatch`; the port's `grad_check` gets the
same weights (`convert.unet`) and batch on the CPU. Tolerances, the UQ
steps' (MODEL_PARITY.json): the loss to 2e-5 relative, every gradient leaf
to 2e-2 of the gradient's scale. The sanitizer raises where JAX's
`jax_debug_nans` does, on a NaN only, forward and backward.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ideal_gan_tpu.cli import test_gradients as jtg  # noqa: E402
from ideal_gan_tpu.train import unsup as junsup  # noqa: E402
from ideal_gan_tpu_torch import convert  # noqa: E402
from ideal_gan_tpu_torch.cli import common  # noqa: E402
from ideal_gan_tpu_torch.cli import test_gradients as tg  # noqa: E402
from ideal_gan_tpu_torch.train import unsup as tunsup  # noqa: E402
from ideal_gan_tpu_torch.utils import nans  # noqa: E402

from test_torch_rest import _fill  # noqa: E402
from torch_one_thread import one_thread  # noqa: E402,F401

FLAGS = ["--synthetic", "2", "--data_size", "32", "--downsample", "1",
         "--n_G_filters", "4"]


@pytest.fixture(autouse=True)
def sanitizer_off():
    yield
    nans.set_debug_nans(False)


def _jax_harness(tmp_path, monkeypatch) -> dict:
    """JAX's `test_gradients.main` on FLAGS, with its filled weights, its
    batch and its gradient tree."""
    seen = {}
    jax_init, jax_load = junsup.init_state, jtg.load_cohorts

    def init_state(cfg, g_fm, g_r2, tx, key, acqs):
        state = jax.eval_shape(lambda: jax_init(
            cfg, g_fm, g_r2, tx, key, acqs))
        seen["params"] = (_fill(state.params_fm, 1), _fill(state.params_r2, 2))
        return state._replace(params_fm=seen["params"][0],
                              params_r2=seen["params"][1])

    def load_cohorts(cfg):
        seen["data"] = jax_load(cfg)
        return seen["data"]

    def tree_leaves(tree):
        seen["grads"] = tree
        return jax.tree_util.tree_leaves(tree)

    class _Jax:
        """jax for the harness's module, its `tree_util.tree_leaves`
        recording the gradient tree it is handed."""
        tree_util = SimpleNamespace(tree_leaves=tree_leaves)

        def __getattr__(self, name):
            return getattr(jax, name)

    monkeypatch.setattr(junsup, "init_state", init_state)
    monkeypatch.setattr(jtg, "load_cohorts", load_cohorts)
    monkeypatch.setattr(jtg, "jax", _Jax())
    seen["result"] = jtg.main(FLAGS + ["--output_base", str(tmp_path),
                                       "--compile_cache", ""])
    return seen


def test_grad_check_matches_jax(tmp_path, monkeypatch):
    ref = _jax_harness(tmp_path, monkeypatch)
    cfg = dict(tg.DEFAULTS, n_G_filters=4, batch_size=2)
    g_fm, g_r2 = tunsup.build_models(tg.unsup_config(cfg))
    p_fm, p_r2 = ref["params"]
    g_fm.load_state_dict(convert.unet(p_fm))
    g_r2.load_state_dict(convert.unet(p_r2))
    acqs, _, te = ref["data"]
    res = tg.grad_check(cfg, g_fm, g_r2, torch.from_numpy(acqs[:2].copy()),
                        torch.from_numpy(te[:2].copy()))
    loss, j_loss = float(res["loss"]), ref["result"]["loss"]
    assert abs(loss - j_loss) <= 2e-5 * abs(j_loss)
    want = {k: v.numpy() for k, v in convert.unet(ref["grads"]).items()}
    assert set(res["grads"]) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    np.testing.assert_allclose(scale, ref["result"]["max_grad"], rtol=1e-6)
    for k, v in want.items():
        np.testing.assert_allclose(res["grads"][k].numpy(), v, rtol=0,
                                   atol=2e-2 * scale, err_msg=k)


def test_cli_runs_on_cpu_and_needs_cuda_by_default(tmp_path, capsys):
    res = tg.main(FLAGS + ["--device", "cpu", "--output_base",
                           str(tmp_path)])
    out = capsys.readouterr().out
    assert f"loss = {res['loss']:.6f}" in out
    assert "grad leaves: 71, finite: 71" in out
    assert "uncertainty loss: OK" in out and res["max_grad"] > 0
    assert (tmp_path / "grad-check" / "settings_gradcheck.yml").exists()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.main(FLAGS + ["--output_base", str(tmp_path)])


def test_debug_nans_flag_sets_the_sanitizer(tmp_path):
    base = ["--output_base", str(tmp_path), "--device", "cpu"]
    common.setup_experiment({"dataset": "d"}, base)
    assert not nans.debug_nans_enabled()
    nan = torch.full((2, 2), float("nan"))
    cfg = common.setup_experiment({"dataset": "d"},
                                  base + ["--debug_nans", "1"])
    assert cfg["debug_nans"] and nans.debug_nans_enabled()
    # views and uninitialized memory are not checked (`nn.init` writes a
    # fresh parameter through a view): the first computed NaN is
    nan.view(4).t().detach()
    torch.empty(3, 3).fill_(1.0)
    with pytest.raises(FloatingPointError, match="aten.mul"):
        nan.view(4) * 2.0
    common.setup_experiment({"dataset": "d"}, base)
    assert not nans.debug_nans_enabled()


# (name, function of one input, input, raises): NaN forward, NaN in the
# backward only, an infinity (no NaN), as jax_debug_nans sees them
CASES = [
    ("log", lambda m, x: m.log(x), [-1.0, 2.0], True),
    ("div", lambda m, x: x / x, [0.0, 1.0], True),
    ("sqrt_backward", lambda m, x: m.sqrt(x) * 0.0, [0.0, 1.0], True),
    ("inf", lambda m, x: 1.0 / x, [0.0, 1.0], False),
]


@pytest.mark.parametrize("name,fn,x,raises", CASES,
                         ids=[c[0] for c in CASES])
def test_debug_nans_raises_where_jax_does(name, fn, x, raises):
    def j_run():
        return jax.grad(lambda v: jnp.sum(fn(jnp, v)))(jnp.asarray(x))

    jax.config.update("jax_debug_nans", True)
    try:
        if raises:
            with pytest.raises(FloatingPointError):
                j_run()
        else:
            j_run()
    finally:
        jax.config.update("jax_debug_nans", False)
    xt = torch.tensor(x, requires_grad=True)
    nans.set_debug_nans(True)
    try:
        if raises:
            with pytest.raises(FloatingPointError, match="aten.") as err:
                torch.sum(fn(torch, xt)).backward()
            assert ("backward" in str(err.value)) == name.endswith(
                "backward")
        else:
            torch.sum(fn(torch, xt)).backward()
    finally:
        nans.set_debug_nans(False)


def test_debug_nans_step_same_loss_and_names_the_op():
    cfg = dict(tg.DEFAULTS, n_G_filters=4, batch_size=2)
    g_fm, g_r2 = tunsup.build_models(tg.unsup_config(cfg))
    gen = torch.Generator().manual_seed(0)
    g_fm.init_params(gen)
    g_r2.init_params(gen)
    acqs, _, te = common.synthetic_dataset(2, h=32, w=32)
    args = (torch.from_numpy(acqs), torch.from_numpy(te))
    plain = tg.grad_check(cfg, g_fm, g_r2, *args)
    with nans.DebugNaNs():
        checked = tg.grad_check(cfg, g_fm, g_r2, *args)
    with torch.no_grad():
        g_r2.head.weight[0, 0, 0, 0] = float("nan")
    with nans.DebugNaNs(), pytest.raises(FloatingPointError,
                                         match="aten.convolution"):
        tg.grad_check(cfg, g_fm, g_r2, *args)
    assert float(checked["loss"]) == float(plain["loss"])
    for k, v in plain["grads"].items():
        assert torch.equal(checked["grads"][k], v), k


def test_debug_nans_checks_the_kernel_outputs():
    """The hand-written kernels write behind the dispatch mode's back: each
    wrapper hands what its kernel wrote to `check_launch`, which raises
    under the sanitizer (by flag or by block) and names the kernel."""
    from ideal_gan_tpu_torch.ops._build import Kernel, check_launch
    kernel = Kernel("convlstm_fwd", {})
    nan = torch.tensor([1.0, float("nan")])
    check_launch(kernel, 0, nan)
    with nans.DebugNaNs():
        assert nans.debug_nans_enabled()
        check_launch(kernel, 0, torch.ones(2), None)
        with pytest.raises(FloatingPointError,
                           match="output of the convlstm_fwd kernel$"):
            check_launch(kernel, 0, None, nan)
    nan_bf16 = nan.to(torch.bfloat16)
    nans.set_debug_nans(True)
    with pytest.raises(FloatingPointError, match="convlstm_fwd kernel"):
        check_launch(kernel, 0, nan_bf16)
    with pytest.raises(RuntimeError, match="error code 2"):
        check_launch(kernel, 2, nan)
