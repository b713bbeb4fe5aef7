"""The port's log posterior and its gradient against base_tpu on identical
float32 inputs, on the conftest small grid: config 1 (kernels' plain
versions and upsampling) and config 2's field mixture
(tests/test_torch_posterior.py holds the isochrone, the segment table
and the star container)."""
import numpy as np
import pytest
import torch

from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu_torch import convert
from base_tpu_torch.model import posterior as tpost
from base_tpu_torch.model.stardata import make_ms_stars as tmake_stars
from base_tpu_torch.sim.simulate import simulate_cluster as tsimulate
from test_torch_posterior import (PRIOR_SIGMA, TRUTH,  # noqa: F401
                                  _check_log_post, _fields, grids)

torch.set_num_threads(1)


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
