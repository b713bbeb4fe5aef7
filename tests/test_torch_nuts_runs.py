"""The port's NUTS runs: the moment tests of tests/test_nuts.py (threefry
and Philox streams differ, so there is no bit parity with base_tpu's
draws), the chunked runner against run_nuts bit for bit, and the
lockstep: one density call per leaf for all chains
(tests/test_torch_nuts.py holds the U-turn, the leaf and the checkpoint
stack against base_tpu)."""
import numpy as np
import torch

from base_tpu_torch.inference import nuts
from base_tpu_torch.inference.hmc import da_init
from test_torch_nuts import COV, MEAN, _init, gauss_lp

torch.set_num_threads(1)


def test_nuts_gaussian_moments():
    cfg = nuts.NUTSConfig(n_warmup=150, n_samples=250, max_depth=6)
    samples, info = nuts.run_nuts(gauss_lp, _init(0, (4, 2)),
                                  torch.Generator().manual_seed(1), cfg)
    flat = samples.reshape(-1, 2).numpy()
    assert float(info["accept_prob"]) > 0.5
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.35)
    # Trees actually doubled (more than 1 leapfrog per transition).
    assert float(info["mean_leapfrogs"]) > 3.0


def test_nuts_dense_metric_whitens():
    """With the dense metric the 0.9-correlated Gaussian is whitened:
    correct moments at a near-unit step size and short trees."""
    cfg = nuts.NUTSConfig(n_warmup=150, n_samples=250, max_depth=6,
                          n_windows=3, dense_mass=True)
    samples, info = nuts.run_nuts(gauss_lp, _init(5, (4, 2)),
                                  torch.Generator().manual_seed(6), cfg)
    flat = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.35)
    assert float(info["step_size"]) > 0.4          # whitened scale
    assert float(info["mean_leapfrogs"]) < 6.0     # short trees suffice
    assert tuple(info["inv_mass"].shape) == (2, 2)


def test_nuts_free_mask_pins_dims():
    """Pinned dims never move and the live dim still samples correctly."""
    cfg = nuts.NUTSConfig(n_warmup=100, n_samples=150, max_depth=5,
                          n_windows=2, free_mask=(1.0, 0.0))
    init = torch.tensor([[0.3, 2.5]] * 4)

    def lp(z):
        return -0.5 * z[:, 0] ** 2   # dim 1 flat

    samples, _ = nuts.run_nuts(lp, init, torch.Generator().manual_seed(8),
                               cfg)
    assert bool((samples[:, :, 1] == 2.5).all())
    assert 0.7 < float(samples[:, :, 0].std()) < 1.4


def test_nuts_scales_trajectory_with_anisotropy():
    """A long narrow Gaussian needs longer trajectories than an isotropic
    one at the same (unadapted) step size."""

    def narrow(z):
        return -0.5 * (z[:, 0] ** 2 / 400.0 + z[:, 1] ** 2)

    def iso(z):
        return -0.5 * (z * z).sum(-1)

    cfg = nuts.NUTSConfig(n_warmup=50, n_samples=60, max_depth=9,
                          n_windows=1, init_step=0.5)
    init = torch.zeros(4, 2) + 0.1

    def mean_lf(lp):
        _, info = nuts.run_nuts(lp, init, torch.Generator().manual_seed(2),
                                cfg)
        return float(info["mean_leapfrogs"])

    assert mean_lf(narrow) > 1.5 * mean_lf(iso)


def test_nuts_chunked_runner_bit_identical():
    """The chunked runner (per-window warmup, uneven sampling chunks) ==
    run_nuts bit for bit under one generator seed."""
    cfg = nuts.NUTSConfig(n_warmup=45, n_samples=30, max_depth=5,
                          n_windows=3, dense_mass=True)
    init = _init(3, (4, 2), 0.3)
    zs_mono, info_mono = nuts.run_nuts(gauss_lp, init,
                                       torch.Generator().manual_seed(4), cfg)
    zs_chunk, info_chunk = nuts.make_nuts_chunked_runner(
        gauss_lp, cfg, chunk_draws=11)(init, torch.Generator().manual_seed(4))
    assert torch.equal(zs_mono, zs_chunk)
    for key in ("inv_mass", "step_size", "logposts", "accept_prob",
                "mean_leapfrogs"):
        assert torch.equal(info_mono[key], info_chunk[key]), key


def test_one_density_call_per_leaf():
    """Every leaf is one density call on all chains: with one chain the
    calls of a transition equal its leapfrog count; with six, every call
    holds all six rows, and the calls (the lockstep tree) are at least the
    largest chain's count and fewer than the chains' counts summed."""

    def run(C, seed):
        rows = []

        def lp(z):
            rows.append(z.shape[0])
            return gauss_lp(z)

        z = _init(seed, (C, 2))
        lp0, g0 = nuts.value_and_grad(gauss_lp)(z)
        st = nuts.NUTSChainState(z, lp0, g0, da_init(0.2, C, "cpu"))
        _, acc, nlf = nuts.nuts_transition(
            nuts.value_and_grad(lp), st, torch.tensor(0.2), torch.ones(2),
            nuts.NUTSConfig(max_depth=6), torch.Generator().manual_seed(seed))
        assert bool(((acc >= 0) & (acc <= 1)).all())
        return rows, nlf

    rows, nlf = run(1, 0)
    assert len(rows) == int(nlf[0]) > 1
    rows, nlf = run(6, 1)
    assert set(rows) == {6}
    assert int(nlf.max()) <= len(rows) < int(nlf.sum())
