"""The rest of the port's physics vs the JAX package: `synthesize`'s bipolar
map row, `fit_rho`'s bipolar row and demodulated echoes, the fatty-acid
model (`physics/fa.py`) and the reference-API layer (`compat.py`).

Forward outputs are held to 1e-5 + 1e-4·|JAX| elementwise (the JAX
package's own kernel tolerance; both sides compute in complex64);
`torch.autograd` gradients to `jax.grad`'s of the same scalar within 1e-4
of the JAX gradient's largest magnitude. The inputs are numpy from seeds.
The fatty-acid fits are the exception: their 5-species M⁺ comes from a
MᴴM of condition ~1e3, whose float32 normal equations put JAX's ρ 7.2e-4
of its scale from the float64 solution (the port solves them in float64:
1.3e-5), so both are held to a numpy float64 fit (`fa_fit64`): the port
within 1e-4 of its scale and no farther from it than JAX.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import ideal_gan_tpu.compat as jwf  # noqa: E402
from ideal_gan_tpu import physics as jph  # noqa: E402
import ideal_gan_tpu_torch.compat as twf  # noqa: E402
from ideal_gan_tpu_torch import physics as tph  # noqa: E402

RTOL, ATOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
NB, HW, NE = 2, 8, 6


def _close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _grads_close(t_fn, j_fn, *arrays):
    """∂/∂ each array of Σ w·out over every output, torch against JAX."""
    rng = np.random.default_rng(11)
    outs = jax.eval_shape(j_fn, *[jnp.asarray(a) for a in arrays])
    outs = outs if isinstance(outs, tuple) else (outs,)
    ws = [rng.normal(size=o.shape).astype(np.float32) for o in outs]

    def j_loss(*xs):
        o = j_fn(*xs)
        o = o if isinstance(o, tuple) else (o,)
        return sum(jnp.sum(a * w) for a, w in zip(o, ws))

    # one jitted program: JAX's eager dispatch compiles every primitive
    j_g = jax.jit(jax.grad(j_loss, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    xs = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    o = t_fn(*xs)
    o = o if isinstance(o, tuple) else (o,)
    sum((a * torch.from_numpy(w)).sum() for a, w in zip(o, ws)).backward()
    for x, g in zip(xs, j_g):
        g = np.asarray(g)
        gap = float(np.abs(x.grad.numpy() - g).max())
        assert gap <= GRAD_TOL * float(np.abs(g).max()), gap


def _pair(z):
    return np.stack([z.real, z.imag], -1)


def make_maps(nb=NB, hw=HW, seed=1, bipolar=True):
    """Water/fat/(φ, R2*) rows, and a bipolar-phase row with `bipolar`."""
    rng = np.random.default_rng(seed)
    shape = (nb, hw, hw)

    def cplx(lo, hi):
        return rng.uniform(lo, hi, shape) * np.exp(
            1j * rng.uniform(-1, 1, shape))

    rows = [_pair(cplx(0.1, 0.7)), _pair(cplx(0.0, 0.5)),
            np.stack([rng.uniform(-0.3, 0.3, shape),
                      rng.uniform(-0.1, 0.5, shape)], -1)]
    if bipolar:
        rows.append(np.stack([rng.uniform(-0.2, 0.2, shape),
                              np.zeros(shape)], -1))
    return np.stack(rows, axis=1).astype(np.float32)


def jittered_te(ne=NE, nb=NB, seed=3):
    rng = np.random.default_rng(seed)
    steps = 1.6e-3 + 1e-3 * rng.uniform() + 1e-4 * rng.normal(size=ne - 1)
    te = 1.0e-3 + np.concatenate([[0.0], np.cumsum(steps)])
    return np.ascontiguousarray(np.broadcast_to(
        te.astype(np.float32)[None, :, None], (nb, ne, 1)))


def test_synthesize_bipolar_row():
    maps, te = make_maps(), jittered_te()
    got = tph.synthesize(torch.from_numpy(maps), torch.from_numpy(te))
    ref = jph.synthesize(jnp.asarray(maps), jnp.asarray(te))
    _close(got, ref)
    # the bipolar row changes the echoes (it is not ignored)
    plain = tph.synthesize(torch.from_numpy(maps[:, :3]),
                           torch.from_numpy(te))
    assert float((got - plain).abs().max()) > 1e-2
    t_te = torch.from_numpy(te)
    _grads_close(lambda m: tph.synthesize(m, t_te),
                 lambda m: jph.synthesize(m, jnp.asarray(te)), maps)


@pytest.mark.parametrize("phase_constraint", [False, True])
def test_fit_rho_bipolar_and_acq_demod(phase_constraint):
    maps, te = make_maps(), jittered_te()
    acqs = np.asarray(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))
    # the fit's (φ, R2*) row first and the bipolar row last: > 3 rows
    pm = np.concatenate([maps[:, 2:3], np.zeros_like(maps[:, :2]),
                         maps[:, 3:4]], axis=1)
    kw = dict(phase_constraint=phase_constraint, acq_demod=True)
    rho, demod = tph.fit_rho(torch.from_numpy(acqs), torch.from_numpy(pm),
                             torch.from_numpy(te), **kw)
    j_rho, j_demod = jph.fit_rho(jnp.asarray(acqs), jnp.asarray(pm),
                                 jnp.asarray(te), **kw)
    _close(rho, j_rho)
    _close(demod, j_demod)
    if not phase_constraint:  # the round trip inverts the synthesis
        pos = maps[:, None, 2, ..., 1:] >= 0  # where it did not clamp R2*
        np.testing.assert_allclose(np.where(pos, rho.numpy(), 0),
                                   np.where(pos, maps[:, :2], 0), atol=1e-4)
    t_te = torch.from_numpy(te)
    _grads_close(lambda a, p: tph.fit_rho(a, p, t_te, **kw),
                 lambda a, p: jph.fit_rho(a, p, jnp.asarray(te), **kw),
                 acqs, pm)


def test_fit_rho_bipolar_condition_is_jax_s():
    """`fit_rho` reads a bipolar row only with more than 3 rows (JAX's
    condition, not `synthesize`'s ns + 1): a 3-row param_maps with the
    bipolar phase last fits as if it had no such row, on both sides."""
    maps, te = make_maps(), jittered_te()
    acqs = np.asarray(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))
    pm3 = np.concatenate([maps[:, 2:3], maps[:, 2:3], maps[:, 3:4]], axis=1)
    got = tph.fit_rho(torch.from_numpy(acqs), torch.from_numpy(pm3),
                      torch.from_numpy(te))
    _close(got, jph.fit_rho(jnp.asarray(acqs), jnp.asarray(pm3),
                            jnp.asarray(te)))
    _close(got, tph.fit_rho(torch.from_numpy(acqs),
                            torch.from_numpy(maps[:, 2:3]),
                            torch.from_numpy(te)))


def make_fa(nb=NB, hw=HW, seed=0):
    """Legacy FA maps (nb, H, W, 2·ns + 2) = species re/im, (R2*, FM)."""
    rng = np.random.default_rng(seed)
    ns = jph.FATTY_ACID_9PEAK.n_species
    shape = (nb, hw, hw, ns)
    rho = rng.uniform(0.05, 0.5, shape) * np.exp(
        1j * rng.uniform(-0.5, 0.5, shape))
    leg = np.stack([rho.real, rho.imag], -1).reshape(nb, hw, hw, 2 * ns)
    params = np.stack([rng.uniform(0.0, 0.3, (nb, hw, hw)),
                       rng.uniform(-0.2, 0.2, (nb, hw, hw))], -1)
    return np.concatenate([leg, params], -1).astype(np.float32)


def fa_fit64(acqs, phi, r2s, te):
    """The FA fit in float64: ρ = M⁺W⁻S / rho_sc and Â = W⁺MM⁺W⁻S for
    MEBCRN acqs (nb, ne, H, W, 2), normalized φ and R2* (nb, H, W) and te
    (nb, ne, 1). Returns MEBCRN (ρ (nb, ns, H, W, 2), Â (nb, ne, H, W,
    2))."""
    sp = jph.FATTY_ACID_9PEAK
    freqs = sp.freqs_hz(1.5).astype(np.complex128)
    if sp.r2_peak_vec() is not None:
        freqs = freqs + 1j * sp.r2_peak_vec() / (2 * np.pi)
    t = te.astype(np.float64)[..., 0]  # (nb, ne)
    m = np.exp(2j * np.pi * t[..., None] * freqs) @ \
        sp.amps_matrix().astype(np.complex128)
    xi = (phi * jph.FM_SC + 1j * r2s * jph.R2_SC / (2 * np.pi))
    w = np.exp(-2j * np.pi * t[:, :, None, None] * xi[:, None])
    s = acqs[..., 0].astype(np.float64) + 1j * acqs[..., 1]
    coef = np.einsum("bse,behw->bshw", np.linalg.pinv(m), w * s)
    recon = np.einsum("bes,bshw->behw", m, coef) / w
    return (np.stack([coef.real, coef.imag], -1) / jph.RHO_SC,
            np.stack([recon.real, recon.imag], -1))


def _near_f64(got, ref, ref64):
    got, ref = np.asarray(got), np.asarray(ref)
    gap, ref_gap = np.abs(got - ref64).max(), np.abs(ref - ref64).max()
    assert gap <= 1e-4 * np.abs(ref64).max() and gap <= ref_gap, \
        (gap, ref_gap)


def _legacy(x):  # MEBCRN (nb, k, H, W, 2) → legacy (nb, H, W, 2k)
    return x.transpose(0, 2, 3, 1, 4).reshape(*x.shape[:1], *x.shape[2:4], -1)


def test_fa_model():
    fa = make_fa()
    te = np.asarray(jph.te_train(12, bs=NB))
    t_te, j_te = torch.from_numpy(te), jnp.asarray(te)
    ns2 = 2 * jph.FATTY_ACID_9PEAK.n_species
    acqs = tph.fa_forward(torch.from_numpy(fa), t_te)
    j_acqs = jph.fa_forward(jnp.asarray(fa), j_te)
    _close(acqs, j_acqs)
    params = fa[..., ns2:]
    meb = np.asarray(acqs).reshape(NB, HW, HW, 12, 2).transpose(0, 3, 1, 2, 4)
    # fa_cycle demodulates the field map only (R2* zeroed)
    rho64, recon64 = fa_fit64(meb, params[..., 1], 0 * params[..., 0], te)
    for got, ref, ref64 in zip(
            tph.fa_cycle(acqs, torch.from_numpy(params), t_te),
            jph.fa_cycle(j_acqs, jnp.asarray(params), j_te),
            (_legacy(rho64), _legacy(recon64))):
        _near_f64(got, ref, ref64)
    fm_r2 = np.ascontiguousarray(params[..., ::-1])  # (FM, R2*)
    _near_f64(tph.fa_get_rho(torch.from_numpy(meb.copy()),
                             torch.from_numpy(fm_r2), t_te),
              jph.fa_get_rho(jnp.asarray(meb), jnp.asarray(fm_r2), j_te),
              fa_fit64(meb, params[..., 1], params[..., 0], te)[0])
    _grads_close(lambda m: tph.fa_forward(m, t_te),
                 lambda m: jph.fa_forward(m, j_te), fa)
    _grads_close(lambda a, p: tph.fa_cycle(a, p, t_te),
                 lambda a, p: jph.fa_cycle(a, p, j_te),
                 np.asarray(j_acqs), params)
    _grads_close(lambda a, p: tph.fa_get_rho(a, p, t_te),
                 lambda a, p: jph.fa_get_rho(a, p, j_te), meb, fm_r2)


def test_compat_te_trains():
    assert (twf.ns, twf.fm_sc, twf.rho_sc, twf.r2_sc, twf.species) == \
        (jwf.ns, jwf.fm_sc, jwf.rho_sc, jwf.r2_sc, jwf.species)
    for kw in (dict(orig=True), dict(TE_ini_d=0.0, d_TE_d=0.0),
               dict(TE_ini_min=1.2e-3, TE_ini_d=0.0, d_TE_min=2e-3,
                    d_TE_d=0.0)):
        got = twf.gen_TEvar(6, bs=3, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jwf.gen_TEvar(6, bs=3, **kw)))
    # the random branch: a torch.Generator cannot draw jax.random's values;
    # the shape, the bounds and the tiling are the reference's
    for seed in range(5):
        got = twf.gen_TEvar(6, bs=3, generator=torch.Generator().manual_seed(
            seed)).numpy()
        ref = np.asarray(jwf.gen_TEvar(6, bs=3, key=jax.random.PRNGKey(seed)))
        assert got.shape == ref.shape == (3, 6, 1)
        for te in (got, ref):
            assert 1.0e-3 <= te[0, 0, 0] <= 2.4e-3
            steps = np.diff(te[0, :, 0])
            assert (steps > 1.6e-3 - 1e-3).all() and (steps < 2.6e-3
                                                      + 1e-3).all()
            assert (te == te[:1]).all()
    assert torch.equal(twf.gen_TEvar(6), twf.gen_TEvar(6))  # seeded 0


def test_compat_matrices():
    te = np.asarray(jwf.gen_TEvar(6, bs=2, orig=True))
    t_te = torch.from_numpy(te)
    _close(twf.gen_M(t_te, get_Mpinv=False), jwf.gen_M(te, get_Mpinv=False))
    for kw in (dict(), dict(get_P0=True), dict(get_H=True), dict(field=3.0)):
        got, ref = twf.gen_M(t_te, **kw), jwf.gen_M(te, **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r)
    m = twf.gen_M(t_te, get_Mpinv=False)
    j_m = jwf.gen_M(te, get_Mpinv=False)
    for flag in (False, True):
        got, ref = twf.gen_A(m, gen_AtA_pinv=flag), jwf.gen_A(j_m, flag)
        assert len(got) == len(ref) == 2 + flag
        for g, r in zip(got, ref):
            _close(g, r)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 3)).astype(np.float32)
    x[..., 0] += 2.0  # λmax > 0 on most rows
    for g, r in zip(twf.eigenvals(torch.from_numpy(x)),
                    jwf.eigenvals(jnp.asarray(x))):
        _close(g, r)


def test_compat_forward_models():
    maps, te = make_maps(), jittered_te()
    t_te, j_te = torch.from_numpy(te), jnp.asarray(te)
    _close(twf.IDEAL_model(torch.from_numpy(maps), [1.5, t_te]),
           jwf.IDEAL_model(jnp.asarray(maps), [1.5, j_te]))
    acqs = np.asarray(jwf.IDEAL_model(jnp.asarray(maps[:, :3]), [1.5, j_te]))
    # acq_to_acq with the field's protocol train when te is None
    for t in (t_te, None):
        for field in (1.5, 3.0):
            got = twf.acq_to_acq(torch.from_numpy(acqs),
                                 torch.from_numpy(maps[:, 2:3]), t, field)
            ref = jwf.acq_to_acq(jnp.asarray(acqs), jnp.asarray(maps[:, 2:3]),
                                 None if t is None else j_te, field)
            for g, r in zip(got, ref):
                _close(g, r)
    _grads_close(lambda a, p: twf.acq_to_acq(a, p, t_te),
                 lambda a, p: jwf.acq_to_acq(a, p, j_te),
                 acqs, maps[:, 2:3])
    rng = np.random.default_rng(5)
    mag = np.stack([rng.uniform(0, 1, (NB, HW, HW)),
                    rng.uniform(0.2, 1, (NB, HW, HW)),
                    rng.uniform(-0.2, 0.2, (NB, HW, HW))], 1)
    mag_maps = np.stack([mag, np.stack([mag[:, 1], mag[:, 0] * 0.3,
                                        mag[:, 2] * 0.5], 1)],
                        -1).astype(np.float32)
    _close(twf.IDEAL_mag(torch.from_numpy(mag_maps), [1.5, t_te]),
           jwf.IDEAL_mag(jnp.asarray(mag_maps), [1.5, j_te]))
    mp = rng.uniform(-0.2, 0.6, (NB, 2, HW, HW, 4)).astype(np.float32)
    _close(twf.IDEAL_mag_phase(torch.from_numpy(mp), [1.5, t_te]),
           jwf.IDEAL_mag_phase(jnp.asarray(mp), [1.5, j_te]))


def test_compat_cse_mag():
    rng = np.random.default_rng(0)
    acqs = np.abs(rng.normal(size=(NB, NE, HW, HW, 1))).astype(np.float32)
    r2 = rng.uniform(0, 0.4, (NB, 1, HW, HW, 1)).astype(np.float32)
    nu = rng.uniform(0, 0.4, (NB, 1, HW, HW, 1)).astype(np.float32)
    te = np.asarray(jwf.gen_TEvar(NE, bs=NB, orig=True))
    for kw in (dict(), dict(demod_signal=True), dict(uncertainty=True),
               dict(demod_signal=True, uncertainty=True),
               dict(demod_signal=True, R2_prob=True)):
        got = twf.CSE_mag(torch.from_numpy(acqs), torch.from_numpy(r2),
                          [1.5, torch.from_numpy(te)],
                          r2s_nu=torch.from_numpy(nu), **kw)
        ref = jwf.CSE_mag(jnp.asarray(acqs), jnp.asarray(r2),
                          [1.5, jnp.asarray(te)], r2s_nu=jnp.asarray(nu),
                          **kw)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            # the rank-1 fit's ill-posed voxels: the JAX package's own
            # magnitude-fit tolerance (rtol 1e-3 / atol 5e-4)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                       atol=5e-4)


@pytest.mark.parametrize("layout", ["MEBCRN", "legacy"])
def test_compat_get_rho(layout):
    maps, te = make_maps(bipolar=False), jittered_te()
    acqs = np.asarray(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))
    if layout == "legacy":
        acqs = np.ascontiguousarray(acqs.transpose(0, 2, 3, 1, 4).reshape(
            NB, HW, HW, 2 * NE))
        pm = np.stack([maps[:, 2, ..., 1], maps[:, 2, ..., 0]], -1)
    else:
        pm = maps[:, 2:3]
    meb = layout == "MEBCRN"
    for t in (te, None):
        for kw in (dict(), dict(phase_constraint=True), dict(acq_demod=True)):
            got = twf.get_rho(torch.from_numpy(acqs), torch.from_numpy(pm),
                              te=None if t is None else torch.from_numpy(t),
                              MEBCRN=meb, **kw)
            ref = jwf.get_rho(jnp.asarray(acqs), jnp.asarray(pm),
                              te=None if t is None else jnp.asarray(t),
                              MEBCRN=meb, **kw)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                _close(g, r)
    kw = dict(MEBCRN=meb, acq_demod=True)
    _grads_close(lambda a, p: twf.get_rho(a, p, te=torch.from_numpy(te), **kw),
                 lambda a, p: jwf.get_rho(a, p, te=jnp.asarray(te), **kw),
                 acqs, pm)


@pytest.mark.parametrize("head_shape", ["unet", "channel", "plain"])
def test_compat_uncertainty(head_shape):
    maps, te = make_maps(bipolar=False), jittered_te()
    acqs = np.asarray(jph.synthesize(jnp.asarray(maps), jnp.asarray(te)))
    rng = np.random.default_rng(6)
    stats = {k: (maps[:, 2, ..., i], rng.uniform(1e-3, 1e-2, (NB, HW, HW))
                 .astype(np.float32)) for i, k in enumerate(("phi", "r2s"))}

    def shaped(x):
        return {"unet": x[:, None, ..., None], "channel": x[..., None],
                "plain": x}[head_shape]

    def posts(asarray):
        return [SimpleNamespace(mean=lambda m=m: asarray(shaped(m)),
                                variance=lambda v=v: asarray(shaped(v)))
                for m, v in stats.values()]

    t_phi, t_r2 = posts(torch.from_numpy)
    j_phi, j_r2 = posts(jnp.asarray)
    for t in (te, None):
        for rem in (False, True):
            got = twf.PDFF_uncertainty(
                torch.from_numpy(acqs), t_phi, t_r2,
                te=None if t is None else torch.from_numpy(t), rem_R2=rem)
            ref = jwf.PDFF_uncertainty(
                jnp.asarray(acqs), j_phi, j_r2,
                te=None if t is None else jnp.asarray(t), rem_R2=rem)
            for g, r in zip(got, ref):
                _close(g, r)
    rho = maps[:, :2]
    for only_mag in (False, True):
        got = twf.acq_uncertainty(torch.from_numpy(rho), t_phi, t_r2,
                                  only_mag=only_mag)
        ref = jwf.acq_uncertainty(jnp.asarray(rho), j_phi, j_r2,
                                  only_mag=only_mag)
        _close(got, ref)
    # a Posterior passes through as it is
    post = tph.Posterior(torch.zeros(1), torch.ones(1))
    assert twf._as_posterior(post) is post
