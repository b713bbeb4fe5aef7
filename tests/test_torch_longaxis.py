"""chain_chunk and jitter_traj, base_tpu's HMCConfig / NUTSConfig fields
that config 5's long-axis recipe (benchmarks/longaxis_10k_converged.py)
passes: HMC with chain_chunk against the same run unchunked, bit for bit,
with every density call's row count recorded (and base_tpu's fallback
when the chunk does not divide the chains); jitter_traj=False against
jitter mode "none"; tests/test_nuts.py's chain_chunk moment test.  The
sharded recipe (VI into run_hmc_sharded(inv_mass0=) with chain_chunk) is
tests/test_torch_parallel.py (h)."""
import dataclasses

import numpy as np
import pytest
import torch

from base_tpu_torch.inference import hmc, nuts

torch.set_num_threads(1)

# tests/test_torch_hmc.py's target, and tests/test_torch_nuts.py's.
COV = np.array([[1.0, 0.7], [0.7, 2.0]], np.float32)
MEAN = np.array([1.0, -2.0], np.float32)
PREC = torch.from_numpy(np.linalg.inv(COV).astype(np.float32))
NUTS_COV = np.array([[1.0, 0.9], [0.9, 1.0]], np.float32)
NUTS_MEAN = np.array([0.5, -1.5], np.float32)
NUTS_PREC = torch.from_numpy(np.linalg.inv(NUTS_COV).astype(np.float32))


def gauss_logpost(x):
    d = x - torch.from_numpy(MEAN)
    return -0.5 * ((d @ PREC) * d).sum(-1)


def nuts_gauss_lp(z):
    d = z - torch.from_numpy(NUTS_MEAN)
    return -0.5 * ((d @ NUTS_PREC) * d).sum(-1)


def _init(seed, shape, scale=1.0):
    return scale * torch.randn(shape, generator=torch.Generator()
                               .manual_seed(seed))


def _rows_counted(fn):
    """fn with a record of the row count of every call."""
    rows = []

    def f(z):
        rows.append(z.shape[0])
        return fn(z)

    return f, rows


@pytest.mark.parametrize("C, chunk, block_rows", [
    (4, 2, 2), (6, 2, 2),
    (4, 3, 4),      # 3 does not divide 4: base_tpu's fallback, one call
])
def test_chain_chunk_equals_unchunked(C, chunk, block_rows):
    """chain_chunk runs the density on blocks of `chunk` rows one after
    another; the draws, log densities, metric and step size equal the
    unchunked run's bit for bit (the density's rows do not depend on the
    batch), and every call holds one block's rows."""
    cfg = hmc.HMCConfig(n_warmup=30, n_samples=20, l_max=5, n_windows=3,
                        dense_mass=True, jitter_mode="step")
    init = _init(11, (C, 2))
    runs = []
    for cc in (None, chunk):
        f, rows = _rows_counted(gauss_logpost)
        zs, info = hmc.run_hmc(
            f, init, torch.Generator().manual_seed(12),
            dataclasses.replace(cfg, chain_chunk=cc))
        runs.append((zs, info, rows))
    (zs0, info0, rows0), (zs1, info1, rows1) = runs
    assert set(rows0) == {C}
    assert set(rows1) == {block_rows}
    assert len(rows1) == len(rows0) * hmc.chain_blocks(C, chunk)
    assert len(rows1) == len(rows0) * C // block_rows
    assert torch.equal(zs0, zs1)
    for key in ("logposts", "inv_mass", "step_size", "accept_prob"):
        assert torch.equal(info0[key], info1[key]), key
    with pytest.raises(ValueError, match="chain_chunk"):
        hmc.value_and_grad(gauss_logpost, 0)


def test_jitter_traj_false_is_mode_none():
    """jitter_traj=False (base_tpu's legacy switch) forces mode "none"
    whatever jitter_mode says: bit for bit the run with mode "none", here
    both with chain_chunk 8 on 16 chains.  (From 16 rows on, the CPU's
    matmul backward rounds differently in blocks of 8 than in one call of
    16, up to 2.4e-7 in this density's gradient, so chunked and unchunked
    runs are compared at 4 and 6 chains above.)"""
    base = dict(n_warmup=20, n_samples=10, l_max=4, n_windows=2,
                dense_mass=True, chain_chunk=8)
    init = _init(13, (16, 2))

    def run(**kw):
        f, rows = _rows_counted(gauss_logpost)
        zs, info = hmc.run_hmc(f, init, torch.Generator().manual_seed(14),
                               hmc.HMCConfig(**base, **kw))
        assert set(rows) == {8}
        return zs, info

    zs0, info0 = run(jitter_mode="none")
    zs1, info1 = run(jitter_traj=False)       # jitter_mode "length"
    assert torch.isfinite(zs1).all()
    assert torch.equal(zs0, zs1)
    assert torch.equal(info0["step_size"], info1["step_size"])
    zs2, _ = run(jitter_mode="length")
    assert not torch.equal(zs0, zs2)      # the jitter does draw


def test_nuts_chain_chunk_gaussian_moments():
    """tests/test_nuts.py's chain_chunk moment test (at this file's
    150 + 250 draws on 4 chains): chain_chunk is a memory bound, not a
    different sampler.  Every leaf's density evaluation runs as blocks of
    2 rows, and the moments are exact."""
    cfg = nuts.NUTSConfig(n_warmup=150, n_samples=250, max_depth=6,
                          chain_chunk=2)
    rows = []

    def lp(z):
        rows.append(z.shape[0])
        return nuts_gauss_lp(z)

    samples, info = nuts.run_nuts(lp, _init(5, (4, 2)),
                                  torch.Generator().manual_seed(6), cfg)
    assert tuple(samples.shape) == (250, 4, 2)
    assert set(rows) == {2} and len(rows) % 2 == 0
    flat = samples.reshape(-1, 2).numpy()
    assert float(info["accept_prob"]) > 0.5
    np.testing.assert_allclose(flat.mean(0), NUTS_MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), NUTS_COV, atol=0.35)
