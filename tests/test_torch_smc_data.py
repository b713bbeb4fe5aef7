"""Config 5's catalog at a CPU-sized star count (tests/data/smc_stars.npz,
written by scripts/smc_stars_from_jax.py) and the SMC parity scripts
(scripts/torch_smc_parity.py, scripts/smc_parity_jax.py): the catalog bit
for bit against base_tpu's recipe (benchmarks/smc_10k_tpu.py:48-56), the
port's config-5 model on it against base_tpu's, the summary statistics
and the 3-SE rule, and a short run of the port's recipe."""
import os
import sys

import numpy as np
import pytest
import torch

from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
import smc_10k_tpu  # noqa: E402
import smc_stars_from_jax as gen  # noqa: E402
import torch_smc_parity as tsp  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    with np.load(tsp.DATA) as f:
        return {k: f[k] for k in f.files}


def test_catalog_is_base_tpus(data):
    """The stored photometry equals base_tpu's simulate_cluster +
    scatter_cluster at smc_10k_tpu.py's keys and settings, bit for bit,
    and the truth and model settings are the script's and the port's
    recipe's."""
    n = int(data["n_stars"])
    assert n >= 1000 and n == gen.N_STARS
    mags, sigmas, bands = gen.catalog(n)
    assert mags.shape == data["mags"].shape == (n, 8)
    assert np.array_equal(mags, data["mags"])
    assert np.array_equal(sigmas, data["sigmas"])
    assert list(data["bands"]) == list(bands)
    assert np.array_equal(data["truth"], smc_10k_tpu.TRUTH)
    assert np.array_equal(tsp.cs.TRUTH, smc_10k_tpu.TRUTH)
    assert tuple(data["keys"]) == (0, 1) and int(data["n_eep"]) == 64
    assert data["cm_prior"] == np.float32(0.99)
    assert (tsp.cs.N_EEP, tsp.cs.N_Q) == (64, 8)
    assert tsp.cs.VI_CFG5 == dict(n_steps=600, n_mc=8, full_rank=True,
                                  learning_rate=2e-2, init_log_sd=-4.0)
    assert tsp.cs.SMC_CFG5 == dict(max_stages=30, n_move=3)


def test_config5_density_matches_base_tpu(data):
    """The port's config-5 model at upsample 1 on the stored catalog (the
    kernels' plain versions) against base_tpu's model of smc_10k_tpu.py
    (use_pallas False on the CPU): log_post through the sampling transform
    and its z-gradient at the truth and two nearby points, against
    base_tpu in float64 (under jax.enable_x64).  The value to 1e-4 of
    |log_post| (test_torch_multipop._check_parity's bound); the gradient,
    a sum over 1000 stars' terms that cancel, to 1e-3 of its largest
    component (that test's bound) or, where jitted base_tpu's own float32
    gradient sits farther than that from float64, no farther than it."""
    import jax
    import jax.numpy as jnp

    from base_tpu.grids import synthetic as jsyn
    from base_tpu_torch.model import posterior as tpost

    stars = jmake_stars(data["mags"], data["sigmas"],
                        cm_prior=float(data["cm_prior"]))
    jm = jpost.make_single_pop_model(
        jsyn.make_grid(n_eep=64), stars, prior_mean=smc_10k_tpu.TRUTH,
        prior_sigma=tsp.cs.PRIOR_SIGMA, n_q=8, use_pallas=False, upsample=1)
    tm, ttr, free, _ = tsp.cs.config5_model(data["mags"], data["sigmas"],
                                            torch.device("cpu"), upsample=1)
    assert free == tuple(float(v) for v in jpost.free_mask(jm))
    pts = np.tile(smc_10k_tpu.TRUTH, (3, 1))
    pts[1:, :5] += np.random.default_rng(4).normal(
        0, [0.005, 0.002, 0.01, 0.01, 0.002], (2, 5))
    z = np.asarray(ttr.inverse(torch.from_numpy(pts.astype(np.float32))))

    def jax_vg(model, zz):
        f = jpost.make_logpost_z_fn(model, jpost.default_transform(model))
        return map(np.asarray, jax.jit(jax.vmap(jax.value_and_grad(f)))(zz))

    want_v, want_g = jax_vg(jm, jnp.asarray(z))
    with jax.enable_x64(True):
        jm64 = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jm)
        want64_v, want64_g = jax_vg(jm64, jnp.asarray(z, jnp.float64))
    zt = torch.from_numpy(z).requires_grad_(True)
    got_v = tpost.make_logpost_z_fn(tm, ttr)(zt)
    (got_g,) = torch.autograd.grad(got_v.sum(), zt)
    got_v, got_g = got_v.detach().numpy(), got_g.numpy()
    assert np.isfinite(got_v).all() and np.isfinite(got_g).all()
    np.testing.assert_array_less(np.abs(got_v - want64_v),
                                 1e-4 * np.maximum(np.abs(want64_v), 1.0))
    scale = np.abs(want64_g).max()
    ref_err = np.abs(want_g - want64_g).max() / scale
    assert np.abs(got_g - want64_g).max() / scale <= max(1e-3, ref_err)


def _summary(xs, vi_xs, les, n_rep):
    return dict(package="p", stats=tsp.parity_stats(xs, vi_xs, tsp.cs.TRUTH,
                                                    n_rep, les))


def test_parity_stats_and_the_3se_rule():
    """parity_stats on particles of known spread: the sd ratio, z and
    rep_spread with their replicate errors; the log-evidence's SE is the
    replicates' sd over sqrt(R); compare() agrees with itself and flags a
    mean moved by more than 3 combined SEs (its z and its mean), and
    nothing else."""
    rng = np.random.default_rng(0)
    n_rep, n = 4, 4000
    truth = tsp.cs.TRUTH.astype(np.float64)
    vi_xs = truth + rng.normal(0, 1, (20000, 9)) * 0.02
    xs = truth + rng.normal(0, 1, (n_rep * n, 9)) * 0.01
    les = np.array([10.0, 11.0, 9.0, 10.0])
    a = _summary(xs, vi_xs, les, n_rep)
    age = a["stats"]["logAge"]
    assert abs(age["sd_ratio"] - 0.5) < 0.02 and age["sd_ratio_se"] < 0.01
    assert abs(age["z"]) < 0.1 and age["z_se"] < 0.05
    assert age["rep_spread_se"] == pytest.approx(
        age["rep_spread"] / np.sqrt(6.0))
    assert a["stats"]["log_evidence"]["value"] == 10.0
    assert a["stats"]["log_evidence"]["se"] == pytest.approx(
        np.std(les) / 2.0)
    assert tsp.compare(a, a)["agree"]
    moved = xs.copy()
    moved[:, 0] += 0.005                       # half an sd: z moves by 0.5
    res = tsp.compare(a, _summary(moved, vi_xs, les, n_rep))
    assert not res["agree"]
    assert [k for k, r in res["rows"].items() if not r[4]] == [
        "logAge.z", "logAge.mean"]


def test_port_recipe_short(monkeypatch, data):
    """torch_smc_parity.run on the catalog's first 40 stars, VI cut to 12
    steps, 2 replicates of 32 particles, in blocks of 16 rows: every
    replicate at beta = 1, VI's calls the steps, a summary of every free
    parameter with finite figures, and the blocks change no particle (a
    run in one block gives the same particles bit for bit)."""
    monkeypatch.setattr(tsp.cs, "VI_CFG5", dict(tsp.cs.VI_CFG5, n_steps=12))
    mags, sigmas = data["mags"][:40], data["sigmas"][:40]
    dev = torch.device("cpu")
    res = tsp.run(dev, mags, sigmas, 1, 2, 32, 16)
    assert res["vi_density_calls"] == 12 and res["stages"] >= 1
    assert res["smc_density_calls"] >= 1
    assert set(res["stats"]) == set(tsp.FREE_NAMES) | {"log_evidence"}
    for name in tsp.FREE_NAMES:
        assert all(np.isfinite(v) for v in res["stats"][name].values())
    assert len(res["stats"]["log_evidence"]["per_replicate"]) == 2
    whole = tsp.run(dev, mags, sigmas, 1, 2, 32, None)
    assert whole["stats"] == res["stats"]
