"""The port's simulator WD branch and field stars, and its per-star
conditionals (sampleMass / sampleWDMass), against base_tpu on identical
float32 inputs; the random draws (torch and JAX streams differ) by their
distributions, at fixed seeds."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from base_tpu import constants as jC
from base_tpu.grids.wd_atmosphere import synthetic_bergeron as jbergeron
from base_tpu.grids.wd_cooling import synthetic_wd_cooling as jcooling
from base_tpu.model import conditionals as jcond
from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu.sim.simulate import field_cmd_box as jfield_box
from base_tpu.sim.simulate import simulate_cluster as jsimulate
from base_tpu_torch import constants as C
from base_tpu_torch import convert
from base_tpu_torch.grids.wd_atmosphere import synthetic_bergeron
from base_tpu_torch.grids.wd_cooling import synthetic_wd_cooling
from base_tpu_torch.model import conditionals as tcond
from base_tpu_torch.sim import simulate as tsim

torch.set_num_threads(1)

# Off the grids' nodes (see tests/test_torch_wd.py).
TRUTH = np.array([9.45, 0.27, -0.35, 8.0, 0.15, 0.45, 0.721, 0.109, 0.0],
                 np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, 0.1, 0.3, 0.15, -1],
                       np.float32)


def _fields(obj, static=("bands", "name")):
    return {f.name: (getattr(obj, f.name) if f.name in static
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


@pytest.fixture(scope="module")
def tgrid(small_grid):
    return convert.grid_from_numpy(**_fields(small_grid), device="cpu")


def test_simulator_wd_photometry_matches_jax(small_grid, tgrid):
    """base_tpu's simulator on 48 stars above 0.6 Msun: the port's WD
    photometry (wd_apparent_mags) on the same ZAMS masses and atmosphere
    types reproduces base_tpu's WD magnitudes to 1e-4, and the port calls
    the same stars WDs (heavier than the AGB tip)."""
    sim = jax.jit(lambda p, k: jsimulate(
        small_grid, p, 48, k, percent_binary=0.3, min_mass=0.6,
        wd_cooling=jcooling(), wd_atm=jbergeron(), ifmr_kind="linear",
        percent_db=0.4))
    cat = sim(jnp.asarray(TRUTH), jax.random.PRNGKey(5))
    is_wd = np.asarray(cat.stage) == jC.StarStatus.WD
    assert 5 <= is_wd.sum() < 48
    m1 = _t(np.asarray(cat.mass1))
    got = tsim.wd_apparent_mags(
        tgrid, _t(TRUTH), m1, torch.as_tensor(np.array(cat.is_db)),
        synthetic_wd_cooling(device="cpu"), synthetic_bergeron(device="cpu"),
        "linear").numpy()
    np.testing.assert_allclose(got[is_wd], np.asarray(cat.mags)[is_wd],
                               rtol=0, atol=1e-4)
    from base_tpu_torch.grids.isochrone import derive_isochrone

    tip = derive_isochrone(tgrid, *(_t(TRUTH[[i]]) for i in (2, 1, 0)))
    np.testing.assert_array_equal((m1 > tip.agb_tip).numpy(), is_wd)


def test_field_cmd_box_and_field_stars():
    """field_cmd_box equals base_tpu's exactly; field stars fill that box
    uniformly (per-band mean and variance of the unit coordinates within 4
    standard errors of 1/2 and 1/12)."""
    ref = np.random.default_rng(0).normal(18, 2, (50, 4)).astype(np.float32)
    lo, hi = tsim.field_cmd_box(_t(ref), 2.5)
    jlo, jhi = jfield_box(jnp.asarray(ref), 2.5)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    n = 20000
    f = tsim.simulate_field_stars(torch.Generator().manual_seed(1), n,
                                  _t(ref), 2.5)
    u = ((f - lo) / (hi - lo)).numpy()
    assert f.shape == (n, 4) and (u >= 0).all() and (u <= 1).all()
    assert np.all(np.abs(u.mean(0) - 0.5) < 4 * math.sqrt(1 / 12 / n))
    assert np.all(np.abs(u.var(0) - 1 / 12) < 4 * math.sqrt(1 / 180 / n))


def test_simulator_wd_fractions_by_moments(tgrid):
    """The port's simulator with WD grids (20000 stars): the IMF's mean
    log10 mass, the WD fraction (mass above the AGB tip), the binary
    fraction among MS stars, the mass-ratio mean and the DB fraction among
    WDs each within 4 standard errors of the truncated-lognormal IMF and
    the requested fractions; WDs carry no companion."""
    n, pb, pdb, lo, hi = 20000, 0.3, 0.2, 0.2, C.MAX_WD_PRECURSOR_MASS
    cat = tsim.simulate_cluster(
        tgrid, _t(TRUTH), n, torch.Generator().manual_seed(2),
        percent_binary=pb, min_mass=lo,
        wd_cooling=synthetic_wd_cooling(device="cpu"),
        wd_atm=synthetic_bergeron(device="cpu"), ifmr_kind="linear",
        percent_db=pdb)
    assert bool(torch.isfinite(cat.mags).all())
    a, b = [(math.log10(m) - C.IMF_LOG_MEAN) / C.IMF_LOG_SIGMA
            for m in (lo, hi)]
    imf = stats.truncnorm(a, b, loc=C.IMF_LOG_MEAN, scale=C.IMF_LOG_SIGMA)
    logm = np.log10(cat.mass1.numpy())
    assert abs(logm.mean() - imf.mean()) < 4 * imf.std() / math.sqrt(n)

    from base_tpu_torch.grids.isochrone import derive_isochrone

    tip = float(derive_isochrone(
        tgrid, *(_t(TRUTH[[i]]) for i in (2, 1, 0))).agb_tip[0])
    is_wd = (cat.stage == C.StarStatus.WD).numpy()
    p_wd = imf.sf(math.log10(tip))

    def within(k, m, p):
        assert abs(k / m - p) < 4 * math.sqrt(p * (1 - p) / m), (k, m, p)

    within(is_wd.sum(), n, p_wd)
    ms = ~is_wd
    within(cat.is_binary.numpy()[ms].sum(), ms.sum(), pb)
    within(cat.is_db.numpy()[is_wd].sum(), is_wd.sum(), pdb)
    assert not cat.is_db.numpy()[ms].any()
    assert not cat.is_binary.numpy()[is_wd].any()
    assert (cat.mass_ratio.numpy()[is_wd] == 0).all()
    q = cat.mass_ratio.numpy()[cat.is_binary.numpy()]
    assert abs(q.mean() - 0.5) < 4 * math.sqrt(1 / 12 / len(q))


def test_categorical_draws_follow_softmax():
    """Gumbel-max categorical draws at a fixed seed: the frequencies of
    20000 draws over 7 categories (one of them at NEG_INF, never drawn)
    pass a chi-square test against the softmax at the 0.1% level."""
    logits = torch.tensor([0.3, -1.2, 2.0, 0.0, -0.5, 1.1, -1e30])
    n = 20000
    draws = tcond.categorical(logits.expand(n, -1),
                              torch.Generator().manual_seed(3))
    counts = np.bincount(draws.numpy(), minlength=7)
    assert counts[-1] == 0
    p = torch.softmax(logits[:-1], 0).numpy()
    chi2 = ((counts[:-1] - n * p) ** 2 / (n * p)).sum()
    assert chi2 < stats.chi2.ppf(0.999, 5)


def test_truncated_normal_moments():
    """Truncated standard-normal draws on intervals in the bulk, one-sided
    and far in a tail: inside the interval, with mean and variance within
    4 standard errors of scipy's truncnorm."""
    bounds = np.array([[-1.0, 1.5], [0.5, 6.0], [-9.0, -7.5], [3.0, 3.2]])
    n = 20000
    lo = _t(np.repeat(bounds[:, :1], n, 1))
    hi = _t(np.repeat(bounds[:, 1:], n, 1))
    z = tcond.truncated_normal(lo, hi, torch.Generator().manual_seed(4))
    z = z.double().numpy()
    for i, (a, b) in enumerate(bounds):
        d = stats.truncnorm(a, b)
        assert (z[i] >= np.float32(a)).all() and (z[i] <= np.float32(b)).all()
        assert abs(z[i].mean() - d.mean()) < 4 * d.std() / math.sqrt(n)
        assert abs(z[i].var() - d.var()) < 4 * d.var() * math.sqrt(2 / n)


@pytest.fixture(scope="module")
def cond_models(small_grid, tgrid):
    """Both packages' models of a 60-star cluster above 0.6 Msun with WDs
    (the port's simulator at a fixed seed), with a 0.2 mag model floor on
    the photometry so that the marginals are well conditioned: the model
    mags of the two packages differ by float32 rounding (up to ~4e-6 mag),
    which moves a log marginal by ~sum_b r_b / sigma_b^2 times that; at
    a 0.1 mag floor both packages sit up to 2e-3 from a float64
    evaluation, and 1.3e-4 from each other."""
    from base_tpu_torch.sim.scatter import scatter_cluster

    gen = torch.Generator().manual_seed(3)
    cat = tsim.simulate_cluster(
        tgrid, _t(TRUTH), 60, gen, percent_binary=0.3, min_mass=0.6,
        wd_cooling=synthetic_wd_cooling(device="cpu"),
        wd_atm=synthetic_bergeron(device="cpu"), ifmr_kind="linear",
        percent_db=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=26.0)
    is_wd = (cat.stage == C.StarStatus.WD).numpy()
    mags, sig = sc.mags.numpy(), sc.sigmas.numpy()
    kw = dict(cm_prior=0.9, sigma_model=0.2)
    ms = jmake_stars(mags[~is_wd], sig[~is_wd], **kw)
    wds = jmake_stars(mags[is_wd], sig[is_wd], **kw)
    cool, atm = jcooling(), jbergeron()
    jm = jpost.make_single_pop_model(
        small_grid, ms, TRUTH, PRIOR_SIGMA, n_q=6, wd_cooling=cool,
        wd_atm=atm, wd_stars=wds, n_mz=48, ifmr_kind="linear", p_db=0.2)
    tm = convert.model_from_numpy(
        _fields(small_grid), _fields(ms), TRUTH, PRIOR_SIGMA,
        np.asarray(jm.q_grid), np.asarray(jm.abs_coefs),
        wd_cooling=_fields(cool), wd_atm=_fields(atm),
        wd_stars=_fields(wds), mz_grid=np.asarray(jm.mz_grid),
        ifmr_kind="linear", p_db=0.2, device="cpu")
    rng = np.random.default_rng(6)
    draws = np.tile(TRUTH, (5, 1))
    draws[1:, :8] += rng.normal(0, [0.05, 0.01, 0.05, 0.05, 0.03, 0.1,
                                    0.02, 0.01], (4, 8))
    return jm, tm, draws.astype(np.float32)


def test_ms_conditionals_match_jax(cond_models):
    """sample_ms_masses over 5 draws in blocks of 2: log_marg and p_member
    equal base_tpu's to 1e-4; the mass draws lie on each draw's isochrone
    and the mass ratios on the q grid."""
    jm, tm, draws = cond_models
    got = tcond.sample_ms_masses(tm, _t(draws),
                                 torch.Generator().manual_seed(7),
                                 draw_chunk=2)
    want = jax.jit(lambda d, k: jcond.sample_ms_masses(jm, d, k))(
        jnp.asarray(draws), jax.random.PRNGKey(7))
    for name in ("log_marg", "p_member"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-4, err_msg=name)
    assert got.mass1.shape == (5, tm.stars.n_stars)
    assert bool((got.mass1 >= 0.1).all() and (got.mass1 < 5.0).all())
    q = tm.q_grid.numpy()
    assert np.isin(got.mass_ratio.numpy(), q).all()


def test_wd_conditionals_match_jax(cond_models):
    """sample_wd_masses over 5 draws in blocks of 3: log_marg and p_member
    equal base_tpu's to 1e-4; every drawn precursor mass is a node of the
    grid, its WD mass the draw's IFMR of it, its cooling age finite."""
    jm, tm, draws = cond_models
    got = tcond.sample_wd_masses(tm, _t(draws),
                                 torch.Generator().manual_seed(8),
                                 draw_chunk=3)
    want = jax.jit(lambda d, k: jcond.sample_wd_masses(jm, d, k))(
        jnp.asarray(draws), jax.random.PRNGKey(8))
    for name in ("log_marg", "p_member"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-4, err_msg=name)
    mz = tm.mz_grid.numpy()
    assert np.isin(got.zams_mass.numpy(), mz).all()
    ifmr = (draws[:, 6, None]
            + draws[:, 7, None] * (got.zams_mass.numpy() - 3.0))
    np.testing.assert_allclose(got.wd_mass.numpy(), ifmr, rtol=1e-6)
    assert bool(torch.isfinite(got.log_cool_age).all())


def test_wd_conditional_draws_follow_posterior(cond_models):
    """At one parameter vector repeated over 4000 draws, each WD's drawn
    (type, precursor node) frequencies pass a chi-square test (0.1% level,
    nodes of probability below 1% pooled) against the softmax of its nodal
    logits, and the drawn DB share matches their DB mass."""
    _, tm, draws = cond_models
    n = 4000
    out = tcond.sample_wd_masses(tm, _t(np.tile(draws[0], (n, 1))),
                                 torch.Generator().manual_seed(9),
                                 draw_chunk=1000)
    flat = _wd_logits(tm, draws[0])                          # [S, 2K]
    K = tm.mz_grid.shape[0]
    mz = tm.mz_grid.numpy()
    for s in range(flat.shape[0]):
        p = torch.softmax(flat[s], 0).numpy()
        k = np.searchsorted(mz, out.zams_mass[:, s].numpy())
        idx = k + K * out.is_db[:, s].numpy()
        counts = np.bincount(idx, minlength=2 * K)
        big = p >= 0.01
        obs = np.append(counts[big], counts[~big].sum())
        exp = n * np.append(p[big], p[~big].sum())
        keep = exp > 0
        chi2 = ((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum()
        assert chi2 < stats.chi2.ppf(0.999, max(keep.sum() - 1, 1))
        p_db = p[K:].sum()
        share = float(out.is_db[:, s].float().mean())
        assert abs(share - p_db) < 4 * math.sqrt(p_db * (1 - p_db) / n) + 1e-3


def _wd_logits(tm, params):
    """The WD conditional's [S, 2K] logits at one parameter vector, from
    the port's pieces (model.wd)."""
    from base_tpu_torch.model import priors
    from base_tpu_torch.model import wd as twd

    p = _t(params[None])
    mags, _, valid = twd.wd_model_mags(tm.grid, tm.wd_cooling, tm.wd_atm, p,
                                       tm.mz_grid, tm.ifmr_kind)
    dist = p[0, 3] + p[0, 4] * tm.abs_coefs
    app = mags[0] + dist                                       # [2, K, B]
    st = tm.wd_stars
    diff = st.obs_mags[None, :, None, :] - app[:, None]
    ll = -0.5 * (diff * diff * st.inv_var[:, None, :]).sum(-1) \
        + st.log_norm[:, None]                                 # [2, S, K]
    mz = tm.mz_grid
    logw = priors.log_imf(mz) + torch.log(torch.gradient(mz)[0])
    tw = torch.tensor([math.log(1 - tm.p_db), math.log(tm.p_db)])
    lg = torch.where(valid[0], ll + logw + tw[:, None, None],
                     torch.full_like(ll, -1e30))
    return lg.transpose(0, 1).reshape(ll.shape[1], -1)
