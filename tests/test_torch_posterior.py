"""The port's isochrone, segment table, star container and log posterior
(with its gradient) against base_tpu on identical float32 inputs, on the
conftest small grid (E = 48)."""
import dataclasses

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
from base_tpu.sim.scatter import scatter_cluster as jscatter
from base_tpu.sim.simulate import simulate_cluster as jsimulate
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
    for c, (feh, y, age) in enumerate(pts):
        jiso = jderive(jgrid, jnp.asarray(feh), jnp.asarray(y),
                       jnp.asarray(age))
        if upsample > 1:
            jiso = jupsample(jiso, upsample)
        for name in ("mass", "mags", "agb_tip", "min_mass", "mass_sorted"):
            np.testing.assert_allclose(
                getattr(tiso, name)[c].numpy(),
                np.asarray(getattr(jiso, name)), rtol=1e-6, atol=1e-5,
                err_msg=name)
        np.testing.assert_array_equal(tiso.valid[c].numpy(),
                                      np.asarray(jiso.valid))
        assert bool(tiso.in_bounds[c]) == bool(jiso.in_bounds)


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
    for c, (feh, y, age) in enumerate(pts):
        jb = jderive(jgrid, jnp.asarray(feh), jnp.asarray(y),
                     jnp.asarray(age))
        want = jlk.build_segment_table(
            jupsample(jb, 2), jnp.asarray(q), jnp.asarray(mod[c]),
            jnp.asarray(av[c]), jnp.asarray(coefs), binaries=binaries,
            sec_iso=jb)
        for name in ("lo", "hi"):
            np.testing.assert_allclose(getattr(got, name)[c].numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=0, atol=2e-5, err_msg=name)
        mask = np.asarray(want.mask)
        np.testing.assert_array_equal(got.mask[c].numpy(), mask)
        np.testing.assert_allclose(got.logw[c].numpy()[mask],
                                   np.asarray(want.logw)[mask],
                                   rtol=0, atol=1e-4)


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
def cluster(small_grid):
    """24 simulated stars with binaries, as base_tpu builds them."""
    cat = jsimulate(small_grid, jnp.asarray(TRUTH), 24,
                    jax.random.PRNGKey(0), percent_binary=0.3)
    sc = jscatter(cat.mags, jax.random.PRNGKey(1), limit_mag=24.0)
    return jmake_stars(np.asarray(sc.mags), np.asarray(sc.sigmas),
                       cm_prior=0.99)


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

    want_v, want_g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: jpost.log_post(jm, p))))(jnp.asarray(pts))
    want_v, want_g = np.asarray(want_v), np.asarray(want_g)
    x = torch.from_numpy(pts).requires_grad_(True)
    got_v = tpost.log_post(tm, x)
    (got_g,) = torch.autograd.grad(got_v.sum(), x)
    got_v, got_g = got_v.detach().numpy(), got_g.numpy()

    assert np.all(np.isfinite(got_v)) and np.all(np.isfinite(got_g))
    np.testing.assert_array_less(np.abs(got_v - want_v),
                                 3e-4 * np.maximum(np.abs(want_v), 1.0))
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g / scale, want_g / scale, atol=2e-3)


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
