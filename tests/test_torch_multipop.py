"""The port's two-population model (base_tpu_torch.model.multipop) against
base_tpu's on identical float32 inputs: the log posterior and its gradient
through the ordered transform (binaries on and off, the kernels' plain
versions, upsampling, the WD branch), the transforms and the free mask;
the out-of-bounds cliff.  The fold of both populations into one pass of
the density, the label swap and a short adaptive-MH run are in
tests/test_torch_multipop_fold.py (a file holds at most 8 Tier-1 tests:
pytest-xdist's loadfile hands out files with more tests ahead of the JAX
long pole, tests/test_cli_mesh.py)."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu import constants as jC
from base_tpu.model import multipop as jmp
from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu_torch import convert
from base_tpu_torch.model import multipop as tmp
from base_tpu_torch.model import posterior as tpost

torch.set_num_threads(1)

SLOW_CHECKS_STARS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "data", "slow_checks_stars.npz")

# tests/test_multipop.py's truth: age, Y (unused), FeH, mod, Av, carb,
# ifmr..., Y_A, Y_B, lambda.
TRUTH = np.array(
    [9.2, 0.27, -0.7, 11.0, 0.2, 0.5, 0, 0, 0, 0.25, 0.31, 0.6], np.float32)
PRIOR_SIGMA = np.array(
    [-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1, -1, -1, -1], np.float32)
# Parity points sit off the small grid's nodes (age 9.2 and Y 0.31 are
# nodes): at an exact node hit JAX's clip gives half the gradient.
CENTER = np.array(
    [9.25, 0.27, -0.7, 11.0, 0.2, 0.5, 0.0, 0.0, 0.0, 0.252, 0.302, 0.6],
    np.float32)
# With a WD branch: carbonicity and a tunable linear IFMR off their nodes.
CENTER_WD = CENTER.copy()
CENTER_WD[5:8] = (0.45, 0.721, 0.109)


def _fields(obj, static=("bands", "name")):
    return {f.name: (getattr(obj, f.name) if f.name in static
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _points(center, n, seed, wd=False):
    """n 12-vectors: `center`, then points scattered around it in the
    sampled dims, Y_A < Y_B kept."""
    rng = np.random.default_rng(seed)
    p = np.tile(center, (n, 1))
    free = [0, 2, 3, 4, 9, 10, 11] + ([5, 6, 7] if wd else [])
    sd = {0: 0.05, 2: 0.05, 3: 0.05, 4: 0.03, 5: 0.1, 6: 0.02, 7: 0.01,
          9: 0.004, 10: 0.004, 11: 0.1}
    for i in free:
        p[1:, i] += rng.normal(0.0, sd[i], n - 1)
    return p.astype(np.float32)


@pytest.fixture(scope="module")
def two_pop_stars():
    """tests/test_multipop.py's two_pop_data photometry: 80 stars, 60% at
    Y_A = 0.25 and the rest at Y_B = 0.31, as base_tpu simulates them
    (PRNGKeys 51-53), read from tests/data/slow_checks_stars.npz (held bit
    for bit to base_tpu's simulate_cluster and scatter_cluster by
    tests/test_torch_slow_checks_data.py), through base_tpu's
    make_ms_stars."""
    with np.load(SLOW_CHECKS_STARS) as f:
        return jmake_stars(f["mp_mags"], f["mp_sigmas"],
                           cm_prior=float(f["cm_prior"]))


@pytest.fixture(scope="module")
def wd_stars(small_grid):
    """Six or more WDs of population A (the port's simulator at a fixed
    seed, tunable linear IFMR), with a 0.15 mag model floor: the WD
    marginal's float32 floor on steep segments is ~1e-2 at sigma 0.01
    (tests/test_torch_wd.py)."""
    from base_tpu.grids.wd_atmosphere import synthetic_bergeron as jberg
    from base_tpu.grids.wd_cooling import synthetic_wd_cooling as jcool
    from base_tpu_torch.grids.wd_atmosphere import synthetic_bergeron
    from base_tpu_torch.grids.wd_cooling import synthetic_wd_cooling
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    tgrid = convert.grid_from_numpy(**_fields(small_grid), device="cpu")
    p = CENTER_WD[:9].copy()
    p[jC.Param.YYY] = CENTER_WD[jmp.MP_YYA]
    gen = torch.Generator().manual_seed(3)
    cat = simulate_cluster(tgrid, _t(p), 80, gen, percent_binary=0.0,
                           min_mass=0.6,
                           wd_cooling=synthetic_wd_cooling(device="cpu"),
                           wd_atm=synthetic_bergeron(device="cpu"),
                           ifmr_kind="linear", percent_db=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=26.0)
    is_wd = (cat.stage == jC.StarStatus.WD).numpy()
    assert int(is_wd.sum()) >= 6
    wds = jmake_stars(sc.mags.numpy()[is_wd], sc.sigmas.numpy()[is_wd],
                      cm_prior=0.99, sigma_model=0.15)
    return wds, jcool(), jberg()


def _models(small_grid, stars, binaries=False, use_pallas=False,
            upsample=1, wd=None):
    """(base_tpu model, port model) on the same arrays."""
    kw, tkw = {}, {}
    if wd is not None:
        wds, cool, atm = wd
        kw = dict(wd_cooling=cool, wd_atm=atm, wd_stars=wds, n_mz=48)
    jm = jmp.make_multipop_model(small_grid, stars, TRUTH, PRIOR_SIGMA,
                                 n_q=6, binaries=binaries,
                                 use_pallas=use_pallas, upsample=upsample,
                                 **kw)
    if wd is not None:
        tkw = dict(wd_cooling=_fields(cool), wd_atm=_fields(atm),
                   wd_stars=_fields(wds), mz_grid=np.asarray(jm.mz_grid))
    tm = convert.multipop_model_from_numpy(
        _fields(small_grid), _fields(stars), TRUTH, PRIOR_SIGMA,
        np.asarray(jm.q_grid), np.asarray(jm.abs_coefs), binaries=binaries,
        use_pallas=use_pallas, upsample=upsample, device="cpu", **tkw)
    return jm, tm


def _double(obj):
    """obj with every floating tensor in it, through nested dataclass
    fields, in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _double(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


@functools.cache
def _jax_z_value_and_grad(single: bool, batched: bool):
    """base_tpu's log_post through a sampling transform and its gradient
    in z, the model and the transform traced arguments (vmapped over
    points where `batched`): jitted once for every model of one shape and
    one set of static fields."""
    mod = jpost if single else jmp

    def vg(z, m, tr):
        return jax.value_and_grad(mod.make_logpost_z_fn(m, tr))(z)

    return jax.jit(jax.vmap(vg, in_axes=(0, None, None)) if batched else vg)


def _check_parity(jm, tm, pts, one_at_a_time=False, single=False,
                  node_hits=()):
    """log_post through ordered_transform (value and gradient in z) of
    the port against jax.value_and_grad of base_tpu (with `single`, a
    single-population model through default_transform): value to 1e-4 of
    each point's |log_post|, gradient to 1e-3 of its largest component
    over the points, but at `node_hits`, (point, dim) pairs where a point
    sits on a grid node (JAX's clip gives half the gradient there).  log_post is a sum of large per-star terms, so its
    float32 error follows the size of the terms, not of the net.  Where
    base_tpu's own float32 value sits more than 1e-4 of |log_post| from a
    float64 evaluation of the port's plain path (at a point where the net
    cancels to -173 among points near 1200: 3.6e-2 off, the port 1.5e-2),
    the reference cannot meet the per-point bound, and there, only, the
    value is held to 1e-4 of the largest |log_post| over the points."""
    jmod, tmod = (jpost, tpost) if single else (jmp, tmp)

    def transform(mod, m):
        return (mod.default_transform(m) if single
                else mod.ordered_transform(m))

    jtr, ttr = transform(jmod, jm), transform(tmod, tm)
    z = np.stack([np.asarray(jtr.inverse(jnp.asarray(p))) for p in pts])
    # The WD chain traces faster without vmap.
    jvg = _jax_z_value_and_grad(single, not one_at_a_time)
    if one_at_a_time:
        want = [jvg(jnp.asarray(zi), jm, jtr) for zi in z]
        want_v = np.array([float(v) for v, _ in want])
        want_g = np.stack([np.asarray(g) for _, g in want])
    else:
        want_v, want_g = jvg(jnp.asarray(z), jm, jtr)
        want_v, want_g = np.asarray(want_v), np.asarray(want_g)
    zt = _t(z).requires_grad_(True)
    got_v = tmod.make_logpost_z_fn(tm, ttr)(zt)
    (got_g,) = torch.autograd.grad(got_v.sum(), zt)
    got_v, got_g = got_v.detach().numpy(), got_g.numpy()

    assert np.all(np.isfinite(got_v)) and np.all(np.isfinite(got_g))
    assert np.all(want_v > -1e29)            # every point in bounds
    tm64 = _double(tm)
    with torch.no_grad():
        ref64 = tmod.make_logpost_z_fn(tm64, transform(tmod, tm64))(
            zt.detach().double()).numpy()
    tol = 1e-4 * np.maximum(np.abs(ref64), 1.0)
    cancels = np.abs(want_v - ref64) > tol
    tol = np.where(cancels, 1e-4 * max(np.abs(ref64).max(), 1.0), tol)
    np.testing.assert_array_less(np.abs(got_v - want_v), tol)
    scale = np.abs(want_g).max()
    held = np.ones(z.shape, bool)
    for i, j in node_hits:
        held[i, j] = False
    np.testing.assert_allclose(got_g[held] / scale, want_g[held] / scale,
                               atol=1e-3)
    return got_g


@pytest.mark.parametrize("binaries,use_pallas,upsample", [
    (False, False, 1), (True, False, 1), (True, False, 2), (True, True, 2)])
def test_log_post_matches_jax(small_grid, two_pop_stars, binaries,
                              use_pallas, upsample):
    """MS-only density at 4 chains; use_pallas runs base_tpu's Pallas
    kernels in interpret mode and the port's kernels' plain versions."""
    jm, tm = _models(small_grid, two_pop_stars, binaries, use_pallas,
                     upsample)
    g = _check_parity(jm, tm, _points(CENTER, 4, upsample + 2 * binaries))
    assert np.all(np.abs(g[:, [jmp.MP_YYA, jmp.MP_YYB, jmp.MP_LAMBDA]]) > 0)


def test_log_post_with_wd_matches_jax(small_grid, two_pop_stars, wd_stars):
    """The WD branch (both populations' precursor chains, lambda-mixed),
    with its carbonicity and IFMR gradients, at 3 chains."""
    jm, tm = _models(small_grid, two_pop_stars, wd=wd_stars)
    g = _check_parity(jm, tm, _points(CENTER_WD, 3, 8, wd=True),
                      one_at_a_time=True)
    assert np.all(np.abs(g[:, jC.Param.IFMR_INTERCEPT]) > 1e-3)
    assert tmp.free_mask(tm) == jmp.free_mask(jm)


class _Counter:
    """Wraps a function and counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def test_out_of_bounds_lambda_and_hull(small_grid, two_pop_stars):
    """lambda outside (0, 1), or one population off the Y hull, gives
    NEG_INF, and the other chains of the batch are unchanged."""
    _, tm = _models(small_grid, two_pop_stars)
    p = np.tile(CENTER, (4, 1))
    p[1, jmp.MP_LAMBDA] = 1.0
    p[2, jmp.MP_LAMBDA] = -0.1
    p[3, jmp.MP_YYB] = 0.5
    lp = tmp.log_post(tm, _t(p))
    assert bool(torch.isfinite(lp[0])) and lp[0] > -1e29
    assert bool((lp[1:] == tmp.NEG_INF).all())
    torch.testing.assert_close(lp[:1], tmp.log_post(tm, _t(p[:1])),
                               rtol=1e-6, atol=0)


def test_transforms_match_jax(small_grid, two_pop_stars):
    """ordered_transform's forward, inverse and log-determinant equal
    base_tpu's (1e-6) at random unconstrained points; the log-determinant
    equals slogdet of torch.func.jacfwd; every point maps to Y_A < Y_B
    inside the Y hull and round-trips; default_transform's bounds and the
    free mask equal base_tpu's."""
    jm, tm = _models(small_grid, two_pop_stars)
    jtr, ttr = jmp.ordered_transform(jm), tmp.ordered_transform(tm)
    z = np.random.default_rng(0).normal(0, 3, (16, 12)).astype(np.float32)
    x = ttr.forward(_t(z))
    np.testing.assert_allclose(x.numpy(), np.asarray(jax.vmap(jtr.forward)(
        jnp.asarray(z))), rtol=1e-6, atol=1e-6)
    ld = ttr.log_det_jacobian(_t(z))
    np.testing.assert_allclose(ld.numpy(), np.asarray(jax.vmap(
        jtr.log_det_jacobian)(jnp.asarray(z))), rtol=1e-6, atol=1e-5)
    zi = ttr.inverse(x)
    np.testing.assert_allclose(zi.numpy(), np.asarray(jax.vmap(jtr.inverse)(
        jnp.asarray(x.numpy()))), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ttr.forward(zi), x, rtol=0, atol=1e-5)
    ya, yb = x[:, jmp.MP_YYA], x[:, jmp.MP_YYB]
    assert bool((yb > ya).all())
    assert bool((ya >= float(tm.grid.y[0])).all())
    assert bool((yb <= float(tm.grid.y[-1]) + 1e-5).all())
    for i in range(4):
        J = torch.func.jacfwd(ttr.forward)(_t(z[i]).double())
        np.testing.assert_allclose(float(ld[i]),
                                   float(torch.linalg.slogdet(J)[1]),
                                   rtol=1e-4, atol=1e-4)
    jd, td = jmp.default_transform(jm), tmp.default_transform(tm)
    for name in ("lo", "hi", "bounded"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    assert ttr.y_hi == pytest.approx(jtr.y_hi, rel=1e-7)
    assert tmp.free_mask(tm) == jmp.free_mask(jm)
    assert tmp.MP_PARAM_NAMES == jmp.MP_PARAM_NAMES
    assert (tmp.NPARAMS_MP, tmp.MP_YYA, tmp.MP_YYB, tmp.MP_LAMBDA) == (
        jmp.NPARAMS_MP, jmp.MP_YYA, jmp.MP_YYB, jmp.MP_LAMBDA)


def test_make_multipop_model(small_grid, two_pop_stars):
    """make_multipop_model builds base_tpu's q and precursor grids and
    refuses WD stars without their grids."""
    tgrid = convert.grid_from_numpy(**_fields(small_grid), device="cpu")
    tstars = convert.stars_from_numpy(**_fields(two_pop_stars),
                                      device="cpu")
    m = tmp.make_multipop_model(tgrid, tstars, TRUTH, PRIOR_SIGMA, n_q=6,
                                device="cpu")
    jm = jmp.make_multipop_model(small_grid, two_pop_stars, TRUTH,
                                 PRIOR_SIGMA, n_q=6)
    np.testing.assert_array_equal(m.q_grid.numpy(), np.asarray(jm.q_grid))
    np.testing.assert_array_equal(m.abs_coefs.numpy(),
                                  np.asarray(jm.abs_coefs))
    with pytest.raises(ValueError, match="wd_stars"):
        tmp.make_multipop_model(tgrid, tstars, TRUTH, PRIOR_SIGMA,
                                wd_stars=tstars, device="cpu")
