"""The catalogs of base_tpu's last two slow checks as data
(tests/data/slow_checks_stars.npz, written by
scripts/slow_checks_stars_from_jax.py): each bit for bit against base_tpu's
builders on the CPU, and the port's models on them (scripts/
torch_slow_checks.py: case A's two-population model, case C's
single-population one) against base_tpu's: log_post through the sampling
transform and its z-space gradient at the truth and two nearby points.
A short run of each case checks the script's evaluations and launches.
The cases themselves, at base_tpu's lengths, are the `slow` twins in
tests/test_torch_slow_checks.py."""
import os
import sys

import numpy as np
import pytest
import torch

import test_multipop as jtest_mp
import test_vi as jtest_vi
from base_tpu.model import multipop as jmp
from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu_torch.model import multipop as tmp
from base_tpu_torch.model import posterior as tpost
from test_torch_multipop import _check_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import slow_checks_stars_from_jax as gen  # noqa: E402
import torch_slow_checks as sc  # noqa: E402

torch.set_num_threads(1)

CATALOGS = {"mp": gen.mp_catalog, "vi": gen.vi_catalog}


@pytest.fixture(scope="module")
def data():
    with np.load(sc.DATA) as f:
        return {k: f[k] for k in f.files}


def test_constants_are_base_tpus(small_grid, data):
    """The truths, priors, grid axes and settings in the file and the
    scripts are tests/test_multipop.py's, tests/test_vi.py's and
    tests/conftest.py's."""
    assert np.array_equal(data["mp_truth"], jtest_mp.TRUTH)
    assert np.array_equal(data["vi_truth"], jtest_vi.TRUTH)
    assert data["cm_prior"].dtype == np.float32 and data["cm_prior"] == \
        np.float32(0.999)
    for name in ("feh_axis", "y_axis", "age_axis"):
        assert np.array_equal(data[name], sc.GRID_AXES[name])
        assert np.array_equal(data[name], gen.GRID_AXES[name])
    assert np.array_equal(np.asarray(small_grid.age), sc.GRID_AXES[
        "age_axis"].astype(np.float32))
    assert int(data["n_eep"]) == sc.GRID_AXES["n_eep"]
    assert list(data["bands"]) == list(small_grid.bands)
    assert tuple(data["mp_keys"]) == (51, 52, 53)
    assert tuple(data["vi_keys"]) == (61, 62)
    assert (sc.N_CHAINS_A, sc.INIT_SD, sc.N_Q) == (8, 0.01, 6)
    assert sc.HMC == dict(n_warmup=500, n_samples=500, l_max=16,
                          n_windows=4, dense_mass=True)
    assert sc.VI == dict(n_steps=600, n_mc=8, learning_rate=1e-2)


@pytest.mark.parametrize("name", list(CATALOGS))
def test_catalog_is_base_tpus(small_grid, data, name):
    """The stored photometry equals base_tpu's simulate_cluster +
    scatter_cluster at the tests' keys, bit for bit."""
    mags, sigmas = CATALOGS[name](small_grid)
    assert mags.shape == data[f"{name}_mags"].shape == (
        {"mp": 80, "vi": 48}[name], 8)
    assert np.array_equal(mags, data[f"{name}_mags"])
    assert np.array_equal(sigmas, data[f"{name}_sigmas"])


@pytest.fixture(scope="module")
def jax_models(small_grid, data):
    """base_tpu's two models on the stored catalogs, built as its tests
    build them."""
    cm = float(data["cm_prior"])
    mp_stars = jmake_stars(data["mp_mags"], data["mp_sigmas"], cm_prior=cm)
    vi_stars = jmake_stars(data["vi_mags"], data["vi_sigmas"], cm_prior=cm)
    return dict(
        mp=jmp.make_multipop_model(small_grid, mp_stars, data["mp_truth"],
                                   sc.MP_PRIOR_SIGMA, n_q=6,
                                   binaries=False),
        vi=jpost.make_single_pop_model(small_grid, vi_stars,
                                       prior_mean=data["vi_truth"],
                                       prior_sigma=sc.VI_PRIOR_SIGMA,
                                       n_q=6, binaries=False))


@pytest.mark.parametrize("name", ["mp", "vi"])
def test_model_density_matches_base_tpu(data, jax_models, name):
    """log_post through the sampling transform (the ordered one for two
    populations) and its gradient in z, the port's model of the script
    (the kernels' plain versions on the CPU) against base_tpu's jitted
    ones at the truth and two nearby points: value to 1e-4 of
    |log_post|, gradient to 1e-3 of its largest component
    (test_torch_multipop._check_parity).  The two-population truth's age
    (9.2) and Y_B (0.31, the hull) are grid nodes, where JAX's clip gives
    half the gradient: the truth's gradient is held in the other dims,
    the nearby points' in every dim."""
    jm = jax_models[name]
    tm, truth = (sc.mp_model if name == "mp" else sc.vi_model)("cpu")
    assert np.array_equal(truth, data[f"{name}_truth"])
    pts = sc.parity_points(truth)
    if name == "mp":
        assert (pts[:, jmp.MP_YYB] > pts[:, jmp.MP_YYA]).all()
    _check_parity(jm, tm, pts, single=name == "vi",
                  node_hits=((0, 0), (0, jmp.MP_YYB)) if name == "mp" else ())
    assert (tmp if name == "mp" else tpost).free_mask(tm) == tuple(
        float(v) for v in (jmp if name == "mp" else jpost).free_mask(jm))


@pytest.mark.parametrize("case", ["A", "C"])
def test_slow_check_case_short(monkeypatch, case):
    """A case of the script cut to a few transitions (A: 8 + 4 at l_max
    2) or steps (C: 12): one density call an evaluation on all chains,
    finite draws, every criterion and parameter reported, no kernel
    launch on the CPU."""
    monkeypatch.setattr(sc, "HMC", dict(sc.HMC, n_warmup=8, n_samples=4,
                                        l_max=2))
    monkeypatch.setattr(sc, "VI", dict(sc.VI, n_steps=12))
    res = sc.run_case(case, "cpu")
    names = [c["name"] for c in res["criteria"]]
    if case == "A":
        assert res["evaluations"] == 1 + (8 + 4) * 2
        assert res["chains"] == 8 and res["draws"] == 4
        assert set(res["posterior"]) == set(sc.RHAT_PARAMS)
        assert len(names) == 5 + len(sc.RHAT_PARAMS)
    else:
        assert res["evaluations"] == 12 and res["draws"] == sc.N_DRAWS_C
        assert set(res["posterior"]) == set(sc.VI_PARAMS)
        assert names == ["all draws finite", "|mean age - truth|"]
    assert all(np.isfinite(p["mean"]) for p in res["posterior"].values())
    assert res["launches"] == dict.fromkeys(sc.KERNEL_NAMES, 0)
