"""base_tpu's 64 SBC data sets as data (tests/data/sbc_stars.npz, written
by scripts/sbc_stars_from_jax.py): the truths and the first replicas of
each collection bit for bit against base_tpu's builders on the CPU (the
`slow` twin: all 64), and the port's stacked stars against base_tpu's
make_ms_stars on them."""
import os
import sys

import numpy as np
import pytest

import test_calibration as jcal
from base_tpu.model.stardata import make_ms_stars as jmake_stars

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import sbc_stars_from_jax as gen  # noqa: E402
import torch_sbc  # noqa: E402

FEW = 3


@pytest.fixture(scope="module")
def data():
    with np.load(torch_sbc.DATA) as f:
        return {k: f[k] for k in f.files}


def _check_ms(small_grid, data, monkeypatch, k):
    """tests/test_calibration.py's own `_make_batched_stars` on the first
    k replicas (its R cut to k after the truths are drawn at R = 64)."""
    truths = jcal._draw_truths(np.random.default_rng(7))
    assert np.array_equal(truths, data["truths"])
    monkeypatch.setattr(jcal, "R", k)
    stars = jcal._make_batched_stars(small_grid, truths)
    assert np.array_equal(np.asarray(stars.obs_mags), data["ms_mags"][:k])
    assert np.array_equal(np.asarray(stars.obs_sigma), data["ms_sigmas"][:k])


def _check_bin(small_grid, data, k):
    """The binaries test's draw (gen.bin_catalog repeats its
    `draw_from_density` + scatter_cluster with base_tpu's functions)."""
    mags, sigmas = gen.collection(gen.bin_catalog, small_grid,
                                  data["truths"], range(k))
    assert np.array_equal(mags, data["bin_mags"][:k])
    assert np.array_equal(sigmas, data["bin_sigmas"][:k])


def test_sbc_ms_sets_match_base_tpu(small_grid, data, monkeypatch):
    assert data["ms_mags"].shape == (64, 32, 8)
    assert list(data["bands"]) == list(small_grid.bands)
    _check_ms(small_grid, data, monkeypatch, FEW)


def test_sbc_binaries_sets_match_base_tpu(small_grid, data):
    assert data["bin_mags"].shape == (64, 20, 8)
    _check_bin(small_grid, data, FEW)


@pytest.mark.parametrize("collection", ["ms", "bin"])
def test_port_stacked_stars_match_base_tpu(data, collection):
    """stack_ms_stars of the port's make_ms_stars on the first replicas:
    every field [G, S, ...] within float32 rounding of base_tpu's
    make_ms_stars on each set."""
    model, _ = torch_sbc.sbc_model(collection, 4, False, "cpu", FEW)
    for g in range(FEW):
        want = jmake_stars(data[f"{collection}_mags"][g],
                           data[f"{collection}_sigmas"][g], cm_prior=0.999)
        for name in ("obs_over_var", "inv_var", "c0", "log_norm", "log_cm",
                     "log_1m_cm", "field_logdens", "star_mask", "obs_mags",
                     "obs_sigma"):
            np.testing.assert_allclose(
                getattr(model.stars, name)[g].numpy(),
                np.asarray(getattr(want, name)), rtol=1e-6, err_msg=name)


@pytest.mark.slow
def test_sbc_all_sets_match_base_tpu(small_grid, data, monkeypatch):
    _check_ms(small_grid, data, monkeypatch, 64)
    _check_bin(small_grid, data, 64)
