"""HMC with replica blocks (`run_hmc(..., replicas=R)`): the C chains as R
independent problems, each adapting its own metric and step size, the
port's counterpart of base_tpu's `vmap` of run_hmc over data sets
(tests/test_calibration.py).  R = 1 is the one-problem path bit for bit;
a replica's draws do not depend on the other replicas' data (HMC and the
per-chain adaptive MH, on a density over star sets)."""
import os
import sys

import numpy as np
import pytest
import torch

from base_tpu_torch.inference import hmc, mh
from base_tpu_torch.inference.driver import make_hmc_chunked_runner
from base_tpu_torch.model import posterior as tpost
from test_torch_hmc import COV, MEAN, gauss_logpost

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_sbc  # noqa: E402

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_run_hmc_replicas_one_is_the_one_problem_path():
    """run_hmc(replicas=1) equals run_hmc without the keyword and the
    chunked driver (which passes none) bit for bit, with one [P, P]
    metric and one step size, dense and diagonal."""
    init = torch.randn((6, 2), generator=_gen(1))
    for dense in (True, False):
        cfg = hmc.HMCConfig(n_warmup=40, n_samples=12, l_max=6,
                            n_windows=3, dense_mass=dense)
        a, ia = hmc.run_hmc(gauss_logpost, init, _gen(2), cfg, replicas=1)
        b, ib = hmc.run_hmc(gauss_logpost, init, _gen(2), cfg)
        c, ic = make_hmc_chunked_runner(gauss_logpost, cfg, 5)(init,
                                                                _gen(2))
        assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(ia["inv_mass"], ic["inv_mass"])
        assert ia["inv_mass"].shape == ((2, 2) if dense else (2,))
        assert ia["step_size"].ndim == 0


def test_replica_helpers_equal_per_block_calls():
    """With R = 3 blocks of 2 chains: the window's metric estimate, the
    frozen step size, the momenta (from the same normals), Sigma p and the
    kinetic energy equal the one-problem functions on each block."""
    R, k, P = 3, 2, 4
    C = R * k
    rng = np.random.default_rng(0)
    zs = torch.from_numpy(rng.normal(size=(C, 5, P)).astype(np.float32))
    zs = zs * torch.tensor([1.0, 3.0, 0.3])[:, None, None].repeat_interleave(
        k, 0)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0])
    p = torch.from_numpy(rng.normal(size=(C, P)).astype(np.float32))
    da = hmc.da_init(0.1, C, "cpu")
    da = da._replace(log_eps_avg=torch.from_numpy(
        rng.normal(size=C).astype(np.float32)))
    states = hmc.HMCChainState(zs[:, 0], torch.zeros(C), zs[:, 0], da)
    for dense in (True, False):
        cfg = hmc.HMCConfig(n_windows=3, dense_mass=dense)
        m0 = hmc.initial_metric(cfg, P, "cpu", replicas=R)
        _, est = hmc._window_update(states, m0, zs, 0, cfg, mask,
                                    replicas=R)
        chol = hmc._metric_chol(est, R)
        mom = hmc._sample_momentum(_gen(3), chol, C, P, R)
        xi = torch.randn(C, P, generator=_gen(3))
        for r in range(R):
            rows = slice(r * k, (r + 1) * k)
            one = states._replace(z=states.z[rows])
            _, want = hmc._window_update(
                one, hmc.initial_metric(cfg, P, "cpu"), zs[rows], 0, cfg,
                mask)
            assert torch.equal(est[r], want)
            cr = hmc._metric_chol(want)
            want_p = (xi[rows] / cr if not dense else
                      torch.linalg.solve_triangular(cr.T, xi[rows].T,
                                                    upper=True).T)
            torch.testing.assert_close(mom[rows], want_p, rtol=1e-6,
                                       atol=0)
            torch.testing.assert_close(
                hmc._mass_matvec(est, p, R)[rows],
                hmc._mass_matvec(want, p[rows]), rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(
                hmc._kinetic(est, p, R)[rows], hmc._kinetic(want, p[rows]),
                rtol=1e-6, atol=1e-7)
    eps = hmc.freeze_step_size(states, replicas=R)
    for r in range(R):
        one = states._replace(da=hmc.DAState(
            *(x[r * k:(r + 1) * k] for x in states.da)))
        assert torch.equal(eps[r], hmc.freeze_step_size(one))


def test_replica_blocks_adapt_to_their_own_targets():
    """Two replicas of 4 chains, block 1's Gaussian 10x wider than block
    0's: each block's dense metric approaches its own covariance (so the
    step sizes, in the metric's units, come out alike), and its draws have
    its own mean and sd."""
    scale = torch.tensor([1.0, 10.0]).repeat_interleave(4)[:, None]

    def f(x):
        return gauss_logpost(x / scale) - 2.0 * torch.log(scale[:, 0])

    init = torch.randn((8, 2), generator=_gen(4)) * scale
    cfg = hmc.HMCConfig(n_warmup=300, n_samples=400, l_max=16, n_windows=3,
                        dense_mass=True)
    xs, info = hmc.run_hmc(f, init, _gen(5), cfg, replicas=2)
    assert info["inv_mass"].shape == (2, 2, 2)
    eps = info["step_size"]
    assert eps.shape == (2,) and 0.5 < float(eps[1] / eps[0]) < 2.0
    for r, s in enumerate((1.0, 10.0)):
        block = xs[:, 4 * r:4 * (r + 1)].reshape(-1, 2) / s
        np.testing.assert_allclose(block.mean(0).numpy(), MEAN, atol=0.35)
        np.testing.assert_allclose(block.std(0).numpy(),
                                   np.sqrt(np.diag(COV)), rtol=0.2)
        np.testing.assert_allclose(info["inv_mass"][r].numpy() / s**2, COV,
                                   atol=0.5)


def _check_independent(run):
    """run(model, truths) -> draws [n, C, ...] with 2 chains a set, on the
    SBC model over base_tpu's first 4 data sets: with set 2's stars moved
    by 0.05 mag, replicas 0, 1 and 3 draw bit for bit the same and replica
    2 does not."""
    a = run(*torch_sbc.sbc_model("ms", 4, False, "cpu", 4))
    b = run(*torch_sbc.sbc_model("ms", 4, False, "cpu", 4, moved_set=2))
    for r in range(4):
        same = torch.equal(a[:, 2 * r:2 * r + 2], b[:, 2 * r:2 * r + 2])
        assert same == (r != 2), r


def test_hmc_replicas_independent_of_other_replicas_stars():
    """run_hmc with 4 replicas of 2 chains on a density over 4 star sets
    (dense metric, length jitter, 3 windows of 10 transitions, 4 draws):
    moving one set's stars changes that replica's draws only."""
    cfg = hmc.HMCConfig(n_warmup=30, n_samples=4, l_max=4, n_windows=3,
                        dense_mass=True, free_mask=torch_sbc.FREE)

    def run(model, truths):
        tr = tpost.default_transform(model)
        z0 = tr.inverse(torch.from_numpy(np.repeat(truths, 2, axis=0)))
        zs, info = hmc.run_hmc(tpost.make_logpost_z_fn(model, tr), z0,
                               _gen(9), cfg, replicas=4)
        assert info["inv_mass"].shape == (4, 9, 9)
        assert info["accept_prob"] > 0.3
        return zs

    _check_independent(run)


def test_mh_replicas_independent_of_other_replicas_stars():
    """run_adaptive_mh (which adapts every chain on its own) on a density
    over 4 star sets, 2 chains a set, 50 + 20 + 20 steps: moving one set's
    stars changes that replica's draws only."""
    cfg = mh.MHConfig(n_stage1=50, n_stage2=20, n_main=20)

    def run(model, truths):
        x0 = torch.from_numpy(np.repeat(truths, 2, axis=0))
        xs, _ = mh.run_adaptive_mh(tpost.make_logpost_fn(model), x0,
                                   _gen(5), torch_sbc.STEP0_MH, cfg)
        return xs

    _check_independent(run)


def test_replicas_refuse_what_they_cannot_split():
    """replicas that do not divide the chains, with a chain_chunk block
    smaller than the chains (a block would see its rows as chains 0..k-1
    of the star sets) or with a rank group raise."""
    init = torch.zeros((6, 2))
    with pytest.raises(ValueError, match="replicas"):
        hmc.run_hmc(gauss_logpost, init, _gen(0), hmc.HMCConfig(), replicas=4)
    with pytest.raises(ValueError, match="chain_chunk"):
        hmc.run_hmc(gauss_logpost, init, _gen(0),
                    hmc.HMCConfig(chain_chunk=2), replicas=3)
    with pytest.raises(ValueError, match="group"):
        hmc.warmup(gauss_logpost, hmc.init_chains(
            gauss_logpost, init, hmc.HMCConfig(), replicas=3),
            hmc.HMCConfig(), _gen(0), group=object(), replicas=3)
