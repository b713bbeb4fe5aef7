"""The port held to base_tpu's pinned posterior (tests/data/golden_singlepop.json,
tests/test_goldens.py): the golden catalog as data, the golden grid and
model, log_post at the truth and its gradient near it against base_tpu,
and (marked slow) the moments of the port's adaptive MH and of its HMC at
bench settings against the golden's.

The port builds the golden model from tests/data/golden_singlepop_stars.json
with its own API (chip_smoke.golden_model, which phase 15 of chip_smoke.py
runs on the card); base_tpu builds it from its threefry streams, as
tests/test_goldens.py does.  The JAX side lives in this file and in
scripts/golden_stars_from_jax.py, whose `golden_catalog` the first test
runs."""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu_torch.grids import synthetic as tsynthetic
from base_tpu_torch.model import posterior as tpost

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUTH = cs.TRUTH
# The whole log_post against base_tpu (ROADMAP, parity contract): the
# value to test_goldens.py:52's 1e-4 relative, the z-space gradient to
# GRAD_TOL of its largest component over the points.  Measured on this
# model: the port's value at the truth 871.7903, 5.2e-6 from the golden
# 871.7948 (base_tpu eager) and 2.2e-5 from jitted base_tpu's 871.8091; a
# float64 evaluation of the port gives 871.7912.  At `points` the port's
# float32 value and gradient sit 4.8e-6 and 8.9e-5 (scaled) from float64,
# jitted base_tpu's 3.5e-5 and 4.9e-4, and the two 3.6e-5 and 4.0e-4
# apart.
VALUE_RTOL = cs.GOLDEN_RTOL
GRAD_TOL = 7e-4


def _writer():
    spec = importlib.util.spec_from_file_location(
        "golden_stars_from_jax",
        os.path.join(ROOT, "scripts", "golden_stars_from_jax.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def golden():
    return cs.load_golden()


@pytest.fixture(scope="module")
def doc():
    return cs.golden_stars()


@pytest.fixture(scope="module")
def jax_model(small_grid, doc):
    """tests/test_goldens.py's golden model on the committed catalog (the
    conftest small grid has the golden axes: test_golden_grid_matches)."""
    stars = jmake_stars(doc["mags"], doc["sigmas"], cm_prior=0.99)
    return jpost.make_single_pop_model(small_grid, stars, prior_mean=TRUTH,
                                       prior_sigma=cs.PRIOR_SIGMA, n_q=8)


@pytest.fixture(scope="module")
def points():
    """Unconstrained points [4, 9]: the truth, and three around it in the
    five free dims (chip_smoke.chain_points, spread 0.05)."""
    model = cs.golden_model("cpu")
    return cs.chain_points(model, 0.05, seed=3, n_chains=4)


@pytest.fixture(scope="module")
def jax_density(jax_model, points):
    """base_tpu's log_post at the truth and jax.value_and_grad of its
    z-space density (default_transform) at `points`, jitted once."""
    fz = jpost.make_logpost_z_fn(jax_model, jpost.default_transform(
        jax_model))

    @jax.jit
    def f(x, zs):
        v, g = jax.vmap(jax.value_and_grad(fz))(zs)
        return jpost.make_logpost_fn(jax_model)(x), v, g

    return tuple(np.asarray(a) for a in f(jnp.asarray(TRUTH),
                                           jnp.asarray(points.numpy())))


def test_golden_stars_file_equals_base_tpu_catalog(small_grid, doc):
    """tests/data/golden_singlepop_stars.json is base_tpu's catalog at keys
    77 / 78, bit for bit, with its bands, truth and keys."""
    w = _writer()
    for k, v in cs.GOLDEN_AXES.items():
        got = getattr(small_grid, k[:-5]) if k.endswith("_axis") \
            else small_grid.n_eep
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(v, np.float32), err_msg=k)
    mags, sigmas, bands = w.golden_catalog(small_grid)
    for name, want in (("mags", mags), ("sigmas", sigmas)):
        assert doc[name].dtype == want.dtype == np.float32
        np.testing.assert_array_equal(doc[name].view(np.uint32),
                                      want.view(np.uint32), err_msg=name)
    assert doc["bands"] == bands
    np.testing.assert_array_equal(doc["truth"], w.TRUTH)
    assert (doc["n_stars"], doc["simulate_key"], doc["scatter_key"]) == (
        64, 77, 78)
    assert (doc["percent_binary"], doc["limit_mag"]) == (0.3, 24.0)
    with open(os.path.join(ROOT, cs.GOLDEN_STARS_PATH)) as f:
        assert json.load(f) == w.as_json(mags, sigmas, bands)


def test_golden_grid_matches_base_tpu(small_grid):
    """The port's make_grid on the golden axes equals base_tpu's bit for
    bit (tolerance 0: both evaluate the same numpy formulas in the same
    order).  On the card chip_smoke.py builds this grid itself, so this is
    what carries it across."""
    got = tsynthetic.make_grid(**cs.GOLDEN_AXES, device="cpu")
    assert tuple(got.bands) == tuple(small_grid.bands)
    for name in ("feh", "y", "age", "mass", "mags", "valid", "agb_tip"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(small_grid, name)),
                                      err_msg=name)


def test_golden_model_matches_base_tpu(jax_model):
    """chip_smoke.golden_model's stars, q grid, extinction coefficients,
    priors and settings equal base_tpu's golden model's (stars to 1e-6 as
    test_torch_posterior.py's test_ms_stars_match_jax, the q grid to one
    ulp)."""
    tm = cs.golden_model("cpu")
    for name in ("obs_over_var", "inv_var", "c0", "log_norm", "log_cm",
                 "log_1m_cm", "field_logdens", "obs_mags", "obs_sigma"):
        np.testing.assert_allclose(
            getattr(tm.stars, name).numpy(),
            np.asarray(getattr(jax_model.stars, name)), rtol=1e-6,
            atol=1e-6, err_msg=name)
    # numpy's float32 linspace against jnp.linspace on XLA's CPU: 2 of the
    # 8 nodes one ulp apart.
    np.testing.assert_allclose(tm.q_grid.numpy(),
                               np.asarray(jax_model.q_grid), rtol=0,
                               atol=np.spacing(np.float32(1)))
    np.testing.assert_allclose(tm.abs_coefs.numpy(),
                               np.asarray(jax_model.abs_coefs), rtol=1e-6)
    np.testing.assert_array_equal(tm.priors.mean.numpy(),
                                  np.asarray(jax_model.priors.mean))
    np.testing.assert_array_equal(tm.priors.sigma.numpy(),
                                  np.asarray(jax_model.priors.sigma))
    assert (tm.binaries, tm.uniform_q, tm.upsample, tm.wd_stars) == (
        jax_model.binaries, jax_model.uniform_q, jax_model.upsample, None)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_golden_logpost_at_truth(golden, jax_density, use_pallas):
    """The port's log_post at the truth on the CPU plain path (with
    use_pallas, the kernels' plain versions) within test_goldens.py:52's
    rtol of the golden 871.7948 and of base_tpu's make_logpost_fn."""
    model = cs.golden_model("cpu", use_pallas=use_pallas)
    with torch.no_grad():
        got = float(tpost.log_post(model, torch.from_numpy(TRUTH)[None])[0])
    np.testing.assert_allclose(got, golden["logpost_at_truth"],
                               rtol=VALUE_RTOL)
    np.testing.assert_allclose(got, float(jax_density[0]), rtol=VALUE_RTOL)


def test_golden_gradient_near_truth(jax_density, points):
    """The z-space density (default_transform) and its gradient at the
    truth and three points near it against jax.value_and_grad of
    base_tpu's: the value to VALUE_RTOL, the gradient to GRAD_TOL of its
    largest component."""
    model = cs.golden_model("cpu")
    z = points.clone().requires_grad_(True)
    v = cs.logpost_z_fn(model)(z)
    (g,) = torch.autograd.grad(v.sum(), z)
    _, want_v, want_g = jax_density
    assert np.all(np.isfinite(g.numpy()))
    np.testing.assert_allclose(v.detach().numpy(), want_v, rtol=VALUE_RTOL)
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(g.numpy() / scale, want_g / scale,
                               atol=GRAD_TOL)


@pytest.mark.slow
def test_posterior_moments_golden_mh(golden):
    """The twin of test_goldens.py's test_posterior_moments_golden: the
    port's run_adaptive_mh, 4 chains from the truth, 400 + 400 + 2000
    steps, its step0, against the pinned moments under its rule
    (chip_smoke.golden_moments, which phase 15 applies on the card)."""
    from base_tpu_torch.inference.mh import MHConfig, run_adaptive_mh

    model = cs.golden_model("cpu")
    start = torch.from_numpy(TRUTH).expand(cs.N_CHAINS_MH15, -1)
    samples, info = run_adaptive_mh(
        tpost.make_logpost_fn(model), start.contiguous(),
        torch.Generator().manual_seed(cs.SEED_MH15),
        torch.from_numpy(cs.GOLDEN_STEP0), MHConfig(**cs.GOLDEN_MH))
    assert torch.isfinite(samples).all()
    assert 0.1 < float(info["accept_rate"].mean()) < 0.7
    cs.check_golden_moments("MH", cs.golden_moments(samples, golden))


@pytest.mark.slow
def test_posterior_moments_golden_hmc(golden):
    """The main path's sampler on the golden model: chunked HMC at bench
    settings (dense metric, step jitter, l_max 48), 4 chains of 48 + 48
    transitions on the CPU (~60 ms a value + gradient call of 4 chains on
    one thread), against the pinned moments."""
    from base_tpu_torch.inference.driver import make_hmc_chunked_runner
    from base_tpu_torch.inference.hmc import HMCConfig

    model = cs.golden_model("cpu")
    cfg = HMCConfig(n_warmup=48, n_samples=48, l_max=48, n_windows=4,
                    dense_mass=True, free_mask=cs.FREE, jitter_mode="step",
                    init_step=0.05)
    tr = cs.transform(model)
    z0 = tr.inverse(torch.from_numpy(TRUTH))
    init = z0 + 0.02 * torch.randn(4, 9,
                                   generator=torch.Generator().manual_seed(2))
    zs, info = make_hmc_chunked_runner(cs.logpost_z_fn(model), cfg,
                                       chunk_draws=64)(
        init, torch.Generator().manual_seed(4))
    xs = tr.forward(zs)
    assert torch.isfinite(xs).all()
    assert 0.3 < float(info["accept_prob"]) < 1.0
    cs.check_golden_moments("HMC", cs.golden_moments(xs, golden))
