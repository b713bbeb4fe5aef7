"""The port's two-population model (base_tpu_torch.model.multipop) against
base_tpu's on identical float32 inputs: the log posterior and its gradient
through the ordered transform (binaries on and off, the kernels' plain
versions, upsampling, the WD branch), the transforms and the free mask;
the fold of both populations into one pass of the density (one call of
each kernel wrapper per evaluation, rows equal to single-population
passes); and a short adaptive-MH run on the two-population posterior."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu import constants as jC
from base_tpu.model import multipop as jmp
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu.sim.scatter import scatter_cluster as jscatter
from base_tpu.sim.simulate import simulate_cluster as jsimulate
from base_tpu_torch import convert
from base_tpu_torch.inference import mh
from base_tpu_torch.model import likelihood as tlk
from base_tpu_torch.model import multipop as tmp

torch.set_num_threads(1)

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
def two_pop_stars(small_grid):
    """tests/test_multipop.py's two_pop_data photometry: 80 stars, 60% at
    Y_A = 0.25 and the rest at Y_B = 0.31, as base_tpu simulates them."""
    n = 80
    n_a = int(round(TRUTH[jmp.MP_LAMBDA] * n))
    cats = []
    for y, n_s, seed in ((TRUTH[jmp.MP_YYA], n_a, 51),
                         (TRUTH[jmp.MP_YYB], n - n_a, 52)):
        p = TRUTH[:9].copy()
        p[jC.Param.YYY] = y
        cats.append(jsimulate(small_grid, jnp.asarray(p), n_s,
                              jax.random.PRNGKey(seed), percent_binary=0.0))
    mags = np.concatenate([np.asarray(c.mags) for c in cats])
    sc = jscatter(jnp.asarray(mags), jax.random.PRNGKey(53), limit_mag=26.0)
    return jmake_stars(np.asarray(sc.mags), np.asarray(sc.sigmas),
                       cm_prior=0.999)


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


def _check_parity(jm, tm, pts, one_at_a_time=False):
    """log_post through ordered_transform (value and gradient in z) of
    the port against jax.value_and_grad of base_tpu: value to 1e-4 of
    each point's |log_post|, gradient to 1e-3 of its largest component
    over the points.  log_post is a sum of large per-star terms, so its
    float32 error follows the size of the terms, not of the net.  Where
    base_tpu's own float32 value sits more than 1e-4 of |log_post| from a
    float64 evaluation of the port's plain path (at a point where the net
    cancels to -173 among points near 1200: 3.6e-2 off, the port 1.5e-2),
    the reference cannot meet the per-point bound, and there, only, the
    value is held to 1e-4 of the largest |log_post| over the points."""
    jtr, ttr = jmp.ordered_transform(jm), tmp.ordered_transform(tm)
    z = np.stack([np.asarray(jtr.inverse(jnp.asarray(p))) for p in pts])
    jvg = jax.value_and_grad(jmp.make_logpost_z_fn(jm, jtr))
    if one_at_a_time:   # the WD chain traces faster without vmap
        want = [jax.jit(jvg)(jnp.asarray(zi)) for zi in z]
        want_v = np.array([float(v) for v, _ in want])
        want_g = np.stack([np.asarray(g) for _, g in want])
    else:
        want_v, want_g = jax.jit(jax.vmap(jvg))(jnp.asarray(z))
        want_v, want_g = np.asarray(want_v), np.asarray(want_g)
    zt = _t(z).requires_grad_(True)
    got_v = tmp.make_logpost_z_fn(tm, ttr)(zt)
    (got_g,) = torch.autograd.grad(got_v.sum(), zt)
    got_v, got_g = got_v.detach().numpy(), got_g.numpy()

    assert np.all(np.isfinite(got_v)) and np.all(np.isfinite(got_g))
    assert np.all(want_v > -1e29)            # every point in bounds
    tm64 = _double(tm)
    with torch.no_grad():
        ref64 = tmp.make_logpost_z_fn(tm64, tmp.ordered_transform(tm64))(
            zt.detach().double()).numpy()
    tol = 1e-4 * np.maximum(np.abs(ref64), 1.0)
    cancels = np.abs(want_v - ref64) > tol
    tol = np.where(cancels, 1e-4 * max(np.abs(ref64).max(), 1.0), tol)
    np.testing.assert_array_less(np.abs(got_v - want_v), tol)
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g / scale, want_g / scale, atol=1e-3)
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


@pytest.mark.parametrize("with_wd", [False, True])
def test_fold_calls_each_kernel_once(small_grid, two_pop_stars, wd_stars,
                                     monkeypatch, with_wd):
    """One evaluation of 3 chains builds one table of 6 rows and calls the
    fused table build and the fused marginal once each (the marginal
    twice with WDs: MS and WD tables), forward and backward; the folded
    rows equal single-population passes at Y_A and at Y_B within 1e-6."""
    _, tm = _models(small_grid, two_pop_stars, True, True, 2,
                    wd=wd_stars if with_wd else None)
    table = _Counter(tlk.fused_combined_node_mags)
    marg = _Counter(tlk.fused_log_marginals)
    monkeypatch.setattr(tlk, "fused_combined_node_mags", table)
    monkeypatch.setattr(tlk, "fused_log_marginals", marg)
    x = _t(_points(CENTER_WD if with_wd else CENTER, 3, 9, wd=with_wd))
    x.requires_grad_(True)
    lp = tmp.log_post(tm, x)
    lp.sum().backward()
    assert (table.calls, marg.calls) == (1, 2 if with_wd else 1)
    assert bool(torch.isfinite(x.grad).all())

    with torch.no_grad():
        p2 = tmp.population_params(x)
        folded, in_b = tmp.population_marginals(tm, p2)
        for rows in (slice(0, 3), slice(3, 6)):
            alone, in_alone = tmp.population_marginals(tm, p2[rows])
            torch.testing.assert_close(folded[rows], alone, rtol=1e-6,
                                       atol=0)
            assert torch.equal(in_b[rows], in_alone)
    np.testing.assert_array_equal(p2[:3, jC.Param.YYY].detach(),
                                  x[:, jmp.MP_YYA].detach())
    np.testing.assert_array_equal(p2[3:, jC.Param.YYY].detach(),
                                  x[:, jmp.MP_YYB].detach())


def test_label_swap_symmetry(small_grid, two_pop_stars):
    """Swapping (Y_A, Y_B) with lambda -> 1 - lambda gives the same
    log_post (rtol 1e-6); a one-population explanation and a wrong
    lambda are worse, as in tests/test_multipop.py."""
    _, tm = _models(small_grid, two_pop_stars, binaries=True)
    swap = TRUTH.copy()
    swap[[jmp.MP_YYA, jmp.MP_YYB]] = TRUTH[[jmp.MP_YYB, jmp.MP_YYA]]
    swap[jmp.MP_LAMBDA] = 1.0 - TRUTH[jmp.MP_LAMBDA]
    single = TRUTH.copy()
    single[[jmp.MP_YYA, jmp.MP_YYB]] = 0.28
    bad_lam = TRUTH.copy()
    bad_lam[jmp.MP_LAMBDA] = 0.95
    lp = tmp.log_post(tm, _t(np.stack([TRUTH, swap, single, bad_lam])))
    assert bool(torch.isfinite(lp).all())
    np.testing.assert_allclose(float(lp[1]), float(lp[0]), rtol=1e-6)
    assert float(lp[2]) < float(lp[0]) - 2.0
    assert float(lp[3]) < float(lp[0]) - 3.0


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


def test_multipop_mh_moves_toward_truth(small_grid, two_pop_stars):
    """Adaptive MH on 4 chains of the two-population posterior (MS only,
    no binaries), started at Y_A = 0.26 and Y_B = 0.29 with lambda 0.5:
    finite log posteriors, pinned dims unmoved, the stage-3 means of Y_A,
    Y_B and lambda as near the truth (0.25, 0.31, 0.6) as
    tests/test_multipop.py asks of base_tpu's MH, and Y_B nearer it than
    the start.  (Y_A trades off against FeH in these 80 stars: its
    posterior mean sits near 0.26.)"""
    _, tm = _models(small_grid, two_pop_stars)
    step = np.zeros(12, np.float32)
    step[[0, 2, 3, 4]] = (0.03, 0.05, 0.05, 0.03)
    step[[jmp.MP_YYA, jmp.MP_YYB, jmp.MP_LAMBDA]] = (0.01, 0.01, 0.08)
    start = TRUTH.copy()
    start[[jmp.MP_YYA, jmp.MP_YYB, jmp.MP_LAMBDA]] = (0.26, 0.29, 0.5)
    cfg = mh.MHConfig(n_stage1=150, n_stage2=150, n_main=200)
    samples, info = mh.run_adaptive_mh(
        tmp.make_logpost_fn(tm), _t(np.tile(start, (4, 1))),
        torch.Generator().manual_seed(54), _t(step), cfg)
    s = samples.numpy()
    assert np.isfinite(info["logposts"].numpy()).all()
    assert (info["logposts"].numpy() > -1e29).all()
    pinned = step == 0
    assert (s[:, :, pinned] == start[pinned]).all()
    ya, yb = s[:, :, jmp.MP_YYA].mean(), s[:, :, jmp.MP_YYB].mean()
    assert abs(ya - 0.25) < 0.03 and abs(yb - 0.31) < 0.03 - 1e-3
    assert abs(yb - 0.31) < abs(0.29 - 0.31)     # Y_B moved toward it
    lam = s[:, :, jmp.MP_LAMBDA]
    assert abs(lam.mean() - 0.6) < max(4 * lam.std(), 0.15)
    rate = float(info["accept_rate"].mean())
    assert 0.05 < rate < 0.7
