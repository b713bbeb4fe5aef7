"""The port's WD branch (the WD node chain and segment table, the WD
marginals and the whole WD-bearing log posterior) against base_tpu on
identical float32 inputs, on the conftest small grid; and kernel 4's skip
rules on WD tables.  The WD grids and the precursor lifetime are in
tests/test_torch_wd_grids.py, the IFMRs in tests/test_torch_ifmr.py (a
file holds at most 8 Tier-1 tests: pytest-xdist's loadfile hands out
files with more tests ahead of the JAX long pole, tests/test_cli_mesh.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu import constants as jC
from base_tpu.grids.wd_atmosphere import synthetic_bergeron as jbergeron
from base_tpu.grids.wd_cooling import synthetic_wd_cooling as jcooling
from base_tpu.model import posterior as jpost
from base_tpu.model import wd as jwd
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu_torch import convert
from base_tpu_torch.grids.wd_atmosphere import synthetic_bergeron
from base_tpu_torch.grids.wd_cooling import synthetic_wd_cooling
from base_tpu_torch.model import posterior as tpost
from base_tpu_torch.model import wd as twd
from base_tpu_torch.ops import marglik as tml
from base_tpu_torch.ops.special import NEG_INF
from test_torch_kernels_plain import _group_misses, _skip_misses

torch.set_num_threads(1)

# Off the grids' nodes (small grid age and FeH, cooling carbonicity): at an
# exact node hit the lerp weight sits on its clip, where JAX's gradient
# takes half of each side.
TRUTH = np.array([9.45, 0.27, -0.35, 8.0, 0.15, 0.45, 0.721, 0.109, 0.0],
                 np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, 0.1, 0.3, 0.15, -1],
                       np.float32)
N_MZ = 48


def _fields(obj, static=("bands", "name")):
    return {f.name: (getattr(obj, f.name) if f.name in static
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _params(n, seed, spread=(0.1, 0.01, 0.1, 0.1, 0.05, 0.2, 0.03, 0.02)):
    """n parameter vectors: the truth, then points scattered around it in
    the eight WD-model dims."""
    rng = np.random.default_rng(seed)
    p = np.tile(TRUTH, (n, 1))
    p[1:, :8] += rng.normal(0.0, spread, (n - 1, 8))
    p[:, 5] = np.clip(p[:, 5], 0.02, 0.98)
    return p.astype(np.float32)


@pytest.fixture(scope="module")
def grids(small_grid):
    return small_grid, convert.grid_from_numpy(**_fields(small_grid),
                                               device="cpu")


@pytest.fixture(scope="module")
def wd_cluster(grids):
    """60 simulated stars above 0.6 Msun, with WDs (the port's simulator,
    at a fixed seed):
    the MS and WD containers as base_tpu builds them from that
    photometry, and base_tpu's WD grids."""
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    _, tgrid = grids
    gen = torch.Generator().manual_seed(3)
    cat = simulate_cluster(tgrid, _t(TRUTH), 60, gen, percent_binary=0.3,
                           min_mass=0.6, wd_cooling=synthetic_wd_cooling(device="cpu"),
                           wd_atm=synthetic_bergeron(device="cpu"),
                           ifmr_kind="linear", percent_db=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=26.0)
    is_wd = (cat.stage == jC.StarStatus.WD).numpy()
    mags, sig = sc.mags.numpy(), sc.sigmas.numpy()
    ms = jmake_stars(mags[~is_wd], sig[~is_wd], cm_prior=0.99)
    wds = jmake_stars(mags[is_wd], sig[is_wd], cm_prior=0.99)
    assert int(is_wd.sum()) >= 6
    # The same WDs with a 0.1 mag model floor: well-conditioned marginals.
    wds_floor = jmake_stars(mags[is_wd], sig[is_wd], cm_prior=0.99,
                            sigma_model=0.1)
    return ms, wds, jcooling(), jbergeron(), wds_floor


def _models(small_grid, wd_cluster, binaries, use_pallas=False,
            floor=False):
    ms, wds, cool, atm, wds_floor = wd_cluster
    if floor:
        wds = wds_floor
    jm = jpost.make_single_pop_model(
        small_grid, ms, TRUTH, PRIOR_SIGMA, n_q=6, binaries=binaries,
        wd_cooling=cool, wd_atm=atm, wd_stars=wds, n_mz=N_MZ,
        ifmr_kind="linear", p_db=0.1)
    tm = convert.model_from_numpy(
        _fields(small_grid), _fields(ms), TRUTH, PRIOR_SIGMA,
        np.asarray(jm.q_grid), np.asarray(jm.abs_coefs), binaries=binaries,
        use_pallas=use_pallas, wd_cooling=_fields(cool), wd_atm=_fields(atm),
        wd_stars=_fields(wds), mz_grid=np.asarray(jm.mz_grid),
        ifmr_kind="linear", p_db=0.1, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def wd_chain(small_grid, wd_cluster):
    """Both packages' WD node chain, segment table, marginals and field
    mixture total at 6 chains (the last with an IFMR that leaves every
    node invalid), base_tpu's in one compiled vmap over the chains.  The
    marginals are of the WDs with a 0.1 mag model floor (well
    conditioned, see test_wd_marginals_match_jax)."""
    jm, tm = _models(small_grid, wd_cluster, True, floor=True)
    p = _params(6, 6)
    p[-1, 6] = -3.0                  # every WD mass below 0.05 Msun
    tmags, tlogg, tvalid = twd.wd_model_mags(tm.grid, tm.wd_cooling,
                                             tm.wd_atm, _t(p), tm.mz_grid,
                                             "linear")
    ttable = twd.wd_segment_table(tmags, tvalid, tm.mz_grid, _t(p[:, 3]),
                                  _t(p[:, 4]), tm.abs_coefs, p_db=0.2)

    def chain(pc):
        mags, logg, valid = jwd.wd_model_mags(
            jm.grid, jm.wd_cooling, jm.wd_atm, pc, jm.mz_grid, "linear")
        table = jwd.wd_segment_table(mags, valid, jm.mz_grid, pc[3], pc[4],
                                     jm.abs_coefs, p_db=0.2)
        args = (valid, jm.mz_grid, pc[3], pc[4], jm.abs_coefs, 0.1, False)
        return (mags, logg, valid, table,
                jwd.wd_star_log_marginals(jm.wd_stars, mags, *args),
                jwd.wd_total_loglik(jm.wd_stars, mags, *args))

    out = jax.jit(jax.vmap(chain))(jnp.asarray(p))
    out = jax.tree_util.tree_map(np.asarray, out)
    return dict(p=p, tm=tm, tmags=tmags, tlogg=tlogg, tvalid=tvalid,
                ttable=ttable, jmags=out[0], jlogg=out[1], jvalid=out[2],
                jtable=out[3], jmarg=out[4], jtotal=out[5])


def test_wd_model_mags_and_segment_table(wd_chain):
    """wd_model_mags and wd_segment_table on [C] chains == base_tpu chain
    by chain: mags to 1e-4, log g to 1e-5, validity and masks exactly, the
    table's lo/hi to 1e-4 and its log weights (DA/DB weights and -log Z
    folded in) to 1e-5 where live.  Each live chain has valid and invalid
    nodes; the last chain has none valid."""
    d = wd_chain
    np.testing.assert_array_equal(d["tvalid"].numpy(), d["jvalid"])
    np.testing.assert_allclose(d["tmags"].numpy(), d["jmags"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(d["tlogg"].numpy(), d["jlogg"], rtol=0,
                               atol=1e-5)
    table, jtable = d["ttable"], d["jtable"]
    mask = jtable.mask
    np.testing.assert_array_equal(table.mask.numpy(), mask)
    for name in ("lo", "hi"):
        np.testing.assert_allclose(getattr(table, name).numpy(),
                                   getattr(jtable, name), rtol=0, atol=1e-4)
    np.testing.assert_allclose(table.logw.numpy()[mask], jtable.logw[mask],
                               rtol=0, atol=1e-5)
    live = d["tvalid"].sum(-1)
    assert bool((live[:-1] > 0).all()) and bool((live[:-1] < N_MZ).all())
    assert int(live[-1]) == 0
    assert table.lo.shape == (6, 2 * (N_MZ - 1), 8)


def test_kernel4_skip_rules_on_wd_tables(wd_chain):
    """Kernel 4's element and group rules on WD tables (DA/DB seam inside
    a group of 32, log 0.2 and log 0.8 in logw, an all-masked chain with
    out' = NEG_INF): no marked element or group holds a non-zero weight,
    masked segments are never marked, and the rules still mark most of
    the live work."""
    d = wd_chain
    table = d["ttable"]
    rng = np.random.default_rng(8)
    # WD photometry off chain 0's valid nodes, with 0.01-0.05 mag errors.
    valid = d["tvalid"][0].numpy()
    ks = rng.choice(np.flatnonzero(valid), 24)
    types = rng.random(24) < 0.3
    app = table.lo[0].reshape(2, N_MZ - 1, 8)[types.astype(int),
                                              np.minimum(ks, N_MZ - 2)]
    sig = rng.uniform(0.01, 0.05, (24, 8)).astype(np.float32)
    obs = app.numpy() + rng.normal(0, sig).astype(np.float32)
    iv = 1.0 / sig**2
    ln = (-np.log(sig) - 0.9189385332046727).sum(-1)
    args = (_t(obs), _t(iv), _t(ln), table.lo, table.hi, table.logw,
            table.mask.float())
    out = tml.marglik_fwd_plain(*args)
    assert bool((out[-1] == NEG_INF + args[2]).all())
    assert bool(torch.isfinite(out).all())
    misses, marked, live = _skip_misses(args, out)
    assert misses == 0 and marked >= 0.5 * live
    skip = tml.marglik_bwd_skip(*args, out)
    assert not bool((skip & ~table.mask[:, None, :]).any())
    misses, marked, groups = _group_misses(args, out)
    assert misses == 0 and 0 < marked <= groups
    assert not bool(tml.marglik_bwd_group_skip(*args, out)[-1].any())
    # The plain backward writes exact zeros on masked segments.
    g = torch.ones_like(out)
    dlo, dhi, dlogw = tml.marglik_bwd_plain(*args, out, g)
    dead = ~table.mask
    assert bool((dlogw[dead] == 0).all()) and bool((dlo[dead] == 0).all())
    assert bool(torch.isfinite(dlo).all() and torch.isfinite(dhi).all())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_wd_marginals_match_jax(wd_chain, use_pallas):
    """Per-WD log marginals, the plain path and the kernels' path (their
    plain versions on the CPU) against base_tpu's jnp path, to 1e-4, and
    the WD total through the field mixture to 1e-4 relative, on
    well-conditioned stars: a 0.1 mag model floor on the photometry, and
    marginals above -50.  (At sigma 0.01 mag, gamma - beta^2 / alpha
    cancels ~1e4 down to O(10) along the steep WD segments, and any
    float32 evaluation sits up to ~1e-2 from another.)  The chain with no
    valid node gets NEG_INF + log_norm in both."""
    d = wd_chain
    tm, p = d["tm"], d["p"]
    args = (d["tvalid"], tm.mz_grid, _t(p[:, 3]), _t(p[:, 4]), tm.abs_coefs,
            0.1, use_pallas)
    got = twd.wd_star_log_marginals(tm.wd_stars, d["tmags"], *args).numpy()
    tot = twd.wd_total_loglik(tm.wd_stars, d["tmags"], *args).numpy()
    want, want_tot = d["jmarg"], d["jtotal"]
    sel = want > -50
    assert sel[:-1].sum(1).min() >= 3 and not sel[-1].any()
    np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[-1], want[-1])
    np.testing.assert_array_less(np.abs(tot - want_tot),
                                 1e-4 * np.maximum(np.abs(want_tot), 1.0))


@pytest.mark.parametrize("binaries", [True, False])
def test_log_post_with_wd_matches_jax(small_grid, wd_cluster, binaries):
    """log_post with the WD branch and its gradient in all nine parameters
    == jax.value_and_grad of base_tpu at the truth and at points around
    it: 3e-4 relative in value, 2e-3 of the largest gradient component, as
    tests/test_torch_posterior.py; the IFMR intercept's gradient is
    non-zero."""
    jm, tm = _models(small_grid, wd_cluster, binaries)
    pts = _params(4, 10, spread=(0.05, 0.01, 0.05, 0.05, 0.03, 0.1, 0.02,
                                 0.01))
    # One point at a time: tracing the WD chain under vmap takes longer.
    vg = jax.jit(jax.value_and_grad(lambda x: jpost.log_post(jm, x)))
    want = [vg(jnp.asarray(p)) for p in pts]
    want_v = np.array([float(v) for v, _ in want])
    want_g = np.stack([np.asarray(g) for _, g in want])
    x = _t(pts).requires_grad_(True)
    got_v = tpost.log_post(tm, x)
    (got_g,) = torch.autograd.grad(got_v.sum(), x)
    got_v, got_g = got_v.detach().numpy(), got_g.numpy()

    assert np.all(np.isfinite(got_v)) and np.all(np.isfinite(got_g))
    np.testing.assert_array_less(np.abs(got_v - want_v),
                                 3e-4 * np.maximum(np.abs(want_v), 1.0))
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g / scale, want_g / scale, atol=2e-3)
    assert np.all(np.abs(got_g[:, jC.Param.IFMR_INTERCEPT]) > 1e-3)
    assert tpost.free_mask(tm) == jpost.free_mask(jm)


def test_log_post_wd_chain_with_no_valid_node(small_grid, wd_cluster):
    """A chain whose IFMR leaves every precursor node invalid gets a finite
    density (its WDs fall to the field term) and a finite gradient,
    through both the plain path and the kernels' path, while the other
    chains are unchanged by its presence."""
    p = _params(3, 11)
    p[-1, 6] = -3.0
    for use_pallas in (False, True):
        _, tm = _models(small_grid, wd_cluster, True, use_pallas)
        x = _t(p).requires_grad_(True)
        lp = tpost.log_post(tm, x)
        (g,) = torch.autograd.grad(lp.sum(), x)
        assert bool(torch.isfinite(lp).all() and torch.isfinite(g).all())
        alone = tpost.log_post(tm, _t(p[:2]))
        torch.testing.assert_close(lp[:2].detach(), alone, rtol=1e-6,
                                   atol=0)


def test_make_single_pop_model_wd_arguments(grids):
    """make_single_pop_model builds base_tpu's precursor grid (0.8 to
    MAX_WD_PRECURSOR_MASS in n_mz nodes) and refuses WD stars without
    their grids; a CUDA model still requires the kernels."""
    _, tgrid = grids
    from base_tpu_torch.model.stardata import make_ms_stars

    stars = make_ms_stars(np.full((3, 8), 18.0, np.float32),
                          np.full((3, 8), 0.05, np.float32), device="cpu")
    m = tpost.make_single_pop_model(
        tgrid, stars, TRUTH, PRIOR_SIGMA, n_q=4,
        wd_cooling=synthetic_wd_cooling(device="cpu"),
        wd_atm=synthetic_bergeron(device="cpu"), wd_stars=stars, n_mz=17,
        ifmr_kind="quadratic", device="cpu")
    np.testing.assert_array_equal(
        m.mz_grid.numpy(), np.linspace(0.8, 8.0, 17, dtype=np.float32))
    assert tpost.free_mask(m) == (1.0,) * 9
    with pytest.raises(ValueError, match="wd_cooling"):
        tpost.make_single_pop_model(tgrid, stars, TRUTH, PRIOR_SIGMA,
                                    wd_stars=stars, device="cpu")
