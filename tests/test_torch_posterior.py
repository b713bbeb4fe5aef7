"""The port's isochrone, segment table, star container and log posterior
(with its gradient) against base_tpu on identical float32 inputs, on the
conftest small grid (E = 48)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.grids.isochrone import derive_isochrone as jderive
from base_tpu.grids.isochrone import upsample_isochrone as jupsample
from base_tpu.model import likelihood as jlk
from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu_torch import convert
from base_tpu_torch.grids.isochrone import derive_isochrone as tderive
from base_tpu_torch.grids.isochrone import upsample_isochrone as tupsample
from base_tpu_torch.model import likelihood as tlk
from base_tpu_torch.model import posterior as tpost
from base_tpu_torch.model.stardata import make_ms_stars as tmake_stars
from base_tpu_torch.sim.simulate import simulate_cluster as tsimulate

torch.set_num_threads(1)

TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.0, 0.0, 0.0], np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32)


def _fields(obj, static=("bands", "name")):
    return {f.name: (getattr(obj, f.name) if f.name in static
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def grids(small_grid):
    return small_grid, convert.grid_from_numpy(**_fields(small_grid),
                                               device="cpu")


def _points(grid, n, seed):
    """n random in-hull (FeH, Y, logAge) points, plus one exact node hit."""
    rng = np.random.default_rng(seed)
    lo = [float(grid.feh[0]), float(grid.y[0]), float(grid.age[0])]
    hi = [float(grid.feh[-1]), float(grid.y[-1]), float(grid.age[-1])]
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pts[0] = [float(grid.feh[1]), float(grid.y[1]), float(grid.age[2])]
    return pts


@pytest.mark.parametrize("upsample", [1, 4])
def test_isochrone_matches_jax(grids, upsample):
    """derive_isochrone (+ upsample_isochrone) on a chain batch == base_tpu
    point by point: masses and mags to 1e-5 (float32 contraction order),
    validity and the pad-sorted masses exactly where valid."""
    jgrid, tgrid = grids
    pts = _points(jgrid, 6, upsample)
    tiso = tupsample(tderive(tgrid, *(torch.from_numpy(pts[:, i])
                                      for i in range(3))), upsample)
    jiso = _jax_isochrones(upsample)(jgrid, *(pts[:, i] for i in range(3)))
    for name in ("mass", "mags", "agb_tip", "min_mass", "mass_sorted"):
        np.testing.assert_allclose(
            getattr(tiso, name).numpy(), np.asarray(getattr(jiso, name)),
            rtol=1e-6, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tiso.valid.numpy(), np.asarray(jiso.valid))
    np.testing.assert_array_equal(tiso.in_bounds.numpy(),
                                  np.asarray(jiso.in_bounds))


@pytest.mark.parametrize("binaries", [True, False])
def test_segment_table_matches_jax(grids, binaries):
    """The plain table build == base_tpu's: combined mags to 2e-5 (mags
    ~ 15-25 in float32), the mask exactly, and log weights of the valid
    segments to 1e-4: they hold log(dm) of adjacent upsampled masses,
    where one float32 ulp of mass (~1e-7) is ~3e-5 of the smallest dm.
    Masked segments' weights enter nothing and are not compared."""
    jgrid, tgrid = grids
    pts = _points(jgrid, 3, 7)
    q = np.linspace(0, 1, 6).astype(np.float32)
    coefs = np.linspace(1.5, 0.1, jgrid.mags.shape[-1]).astype(np.float32)
    mod = np.array([9.8, 10.0, 10.2], np.float32)
    av = np.array([0.1, 0.3, 0.5], np.float32)
    base = tderive(tgrid, *(torch.from_numpy(pts[:, i]) for i in range(3)))
    iso = tupsample(base, 2)
    got = tlk.build_segment_table(iso, torch.from_numpy(q),
                                  torch.from_numpy(mod), torch.from_numpy(av),
                                  torch.from_numpy(coefs), binaries=binaries,
                                  sec_iso=base)
    want = _jax_tables(binaries)(jgrid, *(pts[:, i] for i in range(3)), q,
                                 mod, av, coefs)
    for name in ("lo", "hi"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=2e-5, err_msg=name)
    mask = np.asarray(want.mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_allclose(got.logw.numpy()[mask],
                               np.asarray(want.logw)[mask], rtol=0,
                               atol=1e-4)


@functools.cache
def _jax_isochrones(upsample):
    """base_tpu's derive_isochrone (+ upsample_isochrone) vmapped over
    (FeH, Y, logAge) points, jitted once per upsample."""

    def one(grid, feh, y, age):
        iso = jderive(grid, feh, y, age)
        return jupsample(iso, upsample) if upsample > 1 else iso

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0)))


@functools.cache
def _jax_tables(binaries):
    """base_tpu's build_segment_table on the upsample-2 isochrone of each
    point (secondaries on the base one), vmapped over the points and
    their modulus and A_V, jitted once per `binaries`."""

    def one(grid, feh, y, age, q, mod, av, coefs):
        base = jderive(grid, feh, y, age)
        return jlk.build_segment_table(jupsample(base, 2), q, mod, av, coefs,
                                       binaries=binaries, sec_iso=base)

    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0, 0, None, 0, 0, None)))


def test_ms_stars_match_jax():
    """make_ms_stars, padding included (pad values -1 and -9), matches."""
    rng = np.random.default_rng(9)
    mags = rng.normal(18, 2, (7, 4)).astype(np.float32)
    sig = rng.uniform(0.01, 0.1, (7, 4)).astype(np.float32)
    sig[2, 1] = -9.0
    kw = dict(cm_prior=0.95, field_mag_range=np.array([10, 12, 9, 8.0]),
              pad_to=10, sigma_model=0.01)
    want = _fields(jmake_stars(mags, sig, **kw))
    got = tmake_stars(mags, sig, **kw, device="cpu")
    for name, w in want.items():
        np.testing.assert_allclose(getattr(got, name).numpy(), w,
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def cluster(grids):
    """24 simulated stars with binaries (the port's simulator and noise
    model: no JAX compile), in base_tpu's star container."""
    from base_tpu_torch.sim.scatter import scatter_cluster

    gen = torch.Generator().manual_seed(0)
    cat = tsimulate(grids[1], torch.from_numpy(TRUTH), 24, gen,
                    percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    return jmake_stars(sc.mags.numpy(), sc.sigmas.numpy(), cm_prior=0.99)


@pytest.mark.parametrize("use_pallas,upsample", [(False, 1), (True, 2)])
def test_log_post_matches_jax(small_grid, cluster, use_pallas, upsample):
    """log_post and its gradient through convert.model_from_numpy ==
    jax.value_and_grad of base_tpu, at the truth and at random points.
    Tolerances: log_post to 3e-4 relative (its ~300 nats come from
    magnitudes ~20 against sigmas ~0.01, so float32 rounding of the table,
    ~3e-6 mag, moves chi2 by up to ~1e-2 away from the truth); gradient
    to 2e-3 of its largest component over all points, as
    tests/test_pallas_marglik.py scales: each component is a sum of
    large per-star terms that cancel, so its float32 error follows their
    size, not the net (jitted base_tpu sits ~7e-4 and the port ~1.2e-4
    from a float64 evaluation of the port at these points)."""
    jm = jpost.make_single_pop_model(small_grid, cluster, TRUTH, PRIOR_SIGMA,
                                     n_q=6, use_pallas=use_pallas,
                                     upsample=upsample)
    tm = convert.model_from_numpy(
        _fields(small_grid), _fields(cluster), TRUTH, PRIOR_SIGMA,
        np.asarray(jm.q_grid), np.asarray(jm.abs_coefs),
        use_pallas=use_pallas, upsample=upsample, device="cpu")
    rng = np.random.default_rng(10)
    pts = np.tile(TRUTH, (4, 1))
    pts[1:, :5] += rng.normal(0, [0.05, 0.01, 0.05, 0.05, 0.03], (3, 5))
    pts = pts.astype(np.float32)

    _check_log_post(jm, tm, pts, tpost.log_post)


@functools.cache
def _jax_value_and_grad():
    """base_tpu's log_post and its gradient in the 9-vectors, vmapped over
    points with the model a traced argument: jitted once for every model
    of one shape."""
    return jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, m: jpost.log_post(m, p)), in_axes=(0, None)))


def _check_log_post(jm, tm, pts, log_post):
    """log_post(tm, x) and its gradient against base_tpu's at the points
    [n, 9], with test_log_post_matches_jax's tolerances."""
    want_v, want_g = _jax_value_and_grad()(jnp.asarray(pts), jm)
    want_v, want_g = np.asarray(want_v), np.asarray(want_g)
    x = torch.from_numpy(pts).requires_grad_(True)
    got_v = log_post(tm, x)
    (got_g,) = torch.autograd.grad(got_v.sum(), x)
    got_v, got_g = got_v.detach().numpy(), got_g.numpy()

    assert np.all(np.isfinite(got_v)) and np.all(np.isfinite(got_g))
    np.testing.assert_array_less(np.abs(got_v - want_v),
                                 3e-4 * np.maximum(np.abs(want_v), 1.0))
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g / scale, want_g / scale, atol=2e-3)


def test_config2_density_and_make_logpost_fn_match_jax(small_grid, cluster):
    """BASELINE config 2's density: 18 of the cluster's stars at membership
    prior 0.9 and 6 uniform field stars (numpy, from the members' CMD box
    +- 3 mag) at 0.3, the field density over that box (per-band
    field_mag_range).  The port's make_logpost_fn (value and gradient) ==
    base_tpu's log_post, which its make_logpost_fn closes over, with
    test_log_post_matches_jax's tolerances; the field stars pull the
    density below the members-only one."""
    rng = np.random.default_rng(12)
    mem = np.asarray(cluster.obs_mags)[:18]
    mem_sig = np.asarray(cluster.obs_sigma)[:18]
    lo, hi = mem.min(0) - 3.0, mem.max(0) + 3.0
    field = (lo + rng.random((6, mem.shape[1])) * (hi - lo)).astype(
        np.float32)
    mags = np.concatenate([mem, field])
    sig = np.concatenate([mem_sig, np.full_like(field, 0.05)])
    cm = np.concatenate([np.full(18, 0.9), np.full(6, 0.3)]).astype(
        np.float32)
    kw = dict(cm_prior=cm, field_mag_range=(hi - lo).astype(np.float32))
    stars = jmake_stars(mags, sig, **kw)
    jm = jpost.make_single_pop_model(small_grid, stars, TRUTH, PRIOR_SIGMA,
                                     n_q=6, use_pallas=False)
    tm = convert.model_from_numpy(
        _fields(small_grid), _fields(stars), TRUTH, PRIOR_SIGMA,
        np.asarray(jm.q_grid), np.asarray(jm.abs_coefs), use_pallas=False,
        device="cpu")
    own = tmake_stars(mags, sig, **kw, device="cpu")
    for name in ("log_cm", "log_1m_cm", "field_logdens"):
        np.testing.assert_allclose(getattr(own, name).numpy(),
                                   getattr(tm.stars, name).numpy(),
                                   rtol=1e-6, err_msg=name)
    rng = np.random.default_rng(13)
    pts = np.tile(TRUTH, (4, 1))
    pts[1:, :5] += rng.normal(0, [0.05, 0.01, 0.05, 0.05, 0.03], (3, 5))
    pts = pts.astype(np.float32)
    _check_log_post(jm, tm, pts,
                    lambda m, x: tpost.make_logpost_fn(m)(x))
    members = convert.model_from_numpy(
        _fields(small_grid), _fields(jmake_stars(mem, mem_sig, **{
            "cm_prior": 0.9, "field_mag_range": kw["field_mag_range"]})),
        TRUTH, PRIOR_SIGMA, np.asarray(jm.q_grid), np.asarray(jm.abs_coefs),
        use_pallas=False, device="cpu")
    x = torch.from_numpy(pts[:1])
    assert float(tpost.log_post(tm, x)) < float(tpost.log_post(members, x))


def test_log_post_out_of_hull(grids):
    """Out-of-hull points get NEG_INF, and the chain batch keeps in-hull
    chains finite."""
    _, tgrid = grids
    stars = tmake_stars(np.full((3, 8), 18.0, np.float32),
                        np.full((3, 8), 0.05, np.float32), device="cpu")
    m = tpost.make_single_pop_model(tgrid, stars, TRUTH, PRIOR_SIGMA, n_q=4,
                                    device="cpu")
    x = torch.from_numpy(np.stack([TRUTH, TRUTH]))
    x[1, 0] = 11.0                                       # age off the grid
    lp = tpost.log_post(m, x)
    assert torch.isfinite(lp[0]) and lp[1] == tpost.NEG_INF


def test_simulated_cluster_is_physical(grids):
    """The port's simulator (its own draws: torch and JAX streams differ)
    gives finite photometry, singles with q = 0, and about the requested
    binary fraction."""
    _, tgrid = grids
    cat = tsimulate(tgrid, torch.from_numpy(TRUTH), 400,
                    torch.Generator().manual_seed(0), percent_binary=0.3)
    assert cat.mags.shape == (400, 8) and torch.isfinite(cat.mags).all()
    assert (cat.mass_ratio[~cat.is_binary] == 0).all()
    assert 0.2 < cat.is_binary.float().mean() < 0.4
    assert (cat.mass1 >= 0.2).all()


def test_scatter_noise_model_and_cutoffs():
    """sigma_model equals base_tpu's; a band is observed iff its noisy mag
    is below limit + 1 (else mag 99, sigma -9); `relevant_filt` blanks the
    whole star; censor=False keeps every band."""
    from base_tpu.sim.scatter import sigma_model as jsigma
    from base_tpu_torch.sim.scatter import scatter_cluster, sigma_model

    mags = np.random.default_rng(12).uniform(14, 26, (200, 8))
    mags = torch.from_numpy(mags.astype(np.float32))
    np.testing.assert_allclose(sigma_model(mags, 24.0).numpy(),
                               np.asarray(jsigma(jnp.asarray(mags), 24.0)),
                               rtol=1e-6)
    sc = scatter_cluster(mags, torch.Generator().manual_seed(0),
                         limit_mag=24.0)
    observed = sc.sigmas > 0
    assert 0 < observed.float().mean() < 1
    assert torch.equal(observed, sc.mags < 25.0)
    assert (sc.mags[~observed] == 99.0).all()
    assert (sc.sigmas[~observed] == -9.0).all()
    rf = scatter_cluster(mags, torch.Generator().manual_seed(0),
                         limit_mag=30.0, faint_limit=20.0, relevant_filt=2)
    blank = rf.sigmas[:, 2] < 0
    assert blank.any() and (rf.sigmas[blank] < 0).all()
    assert (rf.sigmas[~blank] > 0).all()
    kept = scatter_cluster(mags, torch.Generator().manual_seed(0),
                           limit_mag=24.0, censor=False)
    torch.testing.assert_close(kept.sigmas, sigma_model(mags, 24.0))
