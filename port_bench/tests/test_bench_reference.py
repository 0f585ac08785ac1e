"""The plain reference against the program's CPU path (its kernels' plain
PyTorch versions) at a small size, on one set of weights."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench import synth, weights
from port_bench.reference import nets, physics

from .conftest import ROOT


def _maps_te(n=2, size=16):
    gen = torch.Generator().manual_seed(3)
    m = synth.maps(gen, n, size, "cpu")
    te = synth.te_train(6, 1.3e-3, 2.1e-3, "cpu").expand(n, -1, -1)
    return m, te.contiguous()


def test_physics_against_the_program():
    from ideal_gan_tpu_torch import physics as prog
    m, te = _maps_te()
    a = physics.synthesize(m, te)
    np.testing.assert_allclose(a, prog.synthesize(m, te), atol=2e-6)
    pm = m[:, 2:3]
    for pc in (False, True):
        np.testing.assert_allclose(
            physics.fit_rho(a, pm, te, phase_constraint=pc),
            prog.fit_rho(a, pm, te, phase_constraint=pc), atol=2e-5)
    np.testing.assert_allclose(physics.cycle(a, pm, te),
                               prog.cycle(a, pm, te), atol=2e-5)


@pytest.mark.parametrize("family", ["aideal", "vetnet"])
def test_nets_against_the_program(family):
    from ideal_gan_tpu_torch.train import teaug, unsup
    f = 4
    if family == "aideal":
        ref = {"g_fm": nets.UNet(2, f, activation="tanh", attention=True)}
        prog = {"g_fm": unsup.build_models(dict(unsup.DEFAULTS,
                                                n_G_filters=f))[0]}
    else:
        ref = {"model": nets.VETNet(2, f)}
        prog = {"model": teaug.build_model(dict(teaug.DEFAULTS,
                                                n_G_filters=f))}
    w = weights.make(ref, 11, "cpu")
    for k in ref:
        ref[k].load_state_dict(w[k])
        prog[k].load_state_dict(w[k])
    m, te = _maps_te()
    a = physics.synthesize(m, te)
    with torch.no_grad():
        if family == "aideal":
            got, want = prog["g_fm"](a), ref["g_fm"](a)
        else:
            got, want = (prog["model"](a, te[..., 0]),
                         ref["model"](a, te[..., 0]))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import port_bench.reference.nets, port_bench.reference.physics, "
            "port_bench.reference.train, port_bench.reference.precision; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ideal_gan_tpu', "
            "'ideal_gan_tpu_torch')]; print(bad); assert not bad" % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True)
