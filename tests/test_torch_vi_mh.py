"""The port's VI (base_tpu_torch.inference.vi) against base_tpu's: the Adam
loop fed base_tpu's own noise tracks base_tpu.inference.vi.run_vi step
for step; and the moment tests of tests/test_vi.py on the port's own
draws (threefry and Philox streams differ, so a whole run has no bit
parity with base_tpu).  The adaptive MH tests are in
tests/test_torch_mh.py (a file holds at most 8 Tier-1 tests:
pytest-xdist's loadfile hands out files with more tests ahead of the JAX
long pole, tests/test_cli_mesh.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.inference import vi as jvi
from base_tpu_torch.inference import vi

torch.set_num_threads(1)

# tests/test_vi.py's targets.
MEAN = np.array([2.0, -1.0], np.float32)
SD = np.array([0.5, 1.5], np.float32)
COV = np.array([[1.0, 0.8], [0.8, 1.0]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def _quad(mean, prec):
    """Batched log density -0.5 d^T prec d, [n, P] -> [n], and base_tpu's
    one-point form."""
    m, pr = torch.from_numpy(mean), torch.from_numpy(prec)

    def lp(z):
        d = z - m
        return -0.5 * ((d @ pr) * d).sum(-1)

    def jlp(z):
        d = z - jnp.asarray(mean)
        return -0.5 * d @ jnp.asarray(prec) @ d

    return lp, jlp


def _diag_lp(z):
    return (-0.5 * ((z - torch.from_numpy(MEAN))
                    / torch.from_numpy(SD)) ** 2).sum(-1)


@pytest.mark.parametrize("full_rank", [False, True])
def test_vi_tracks_jax_under_shared_noise(full_rank):
    """fit_vi on base_tpu's own draws (jax.random.normal(k, (n_mc, P)) for
    k in jax.random.split(key, n_steps)) follows base_tpu's run_vi on the
    correlated Gaussian: mu and the scale within 1e-4 after 50 Adam steps
    (torch.optim.Adam is optax.adam's update), and the ELBO trace within
    1e-4 relative."""
    lp, jlp = _quad(MEAN, PREC)
    cfg = vi.VIConfig(n_steps=50, n_mc=16, full_rank=full_rank)
    jcfg = jvi.VIConfig(n_steps=50, n_mc=16, full_rank=full_rank)
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda k: jvi.run_vi(jlp, jnp.zeros(2), k, jcfg))(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (16, 2)))
                      for k in jax.random.split(key, 50)])
    got = vi.fit_vi(lp, torch.zeros(2), torch.from_numpy(noise), cfg)
    np.testing.assert_allclose(got.mu.numpy(), np.asarray(want.mu),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=0, atol=1e-4)
    assert got.scale.shape == want.scale.shape
    np.testing.assert_allclose(got.elbo_trace.numpy(),
                               np.asarray(want.elbo_trace), rtol=1e-4,
                               atol=1e-4)
    # The fit moved: 50 steps of 2e-2 from the origin.
    assert float(got.mu[0]) > 0.5


def test_meanfield_recovers_diagonal_gaussian():
    cfg = vi.VIConfig(n_steps=1200, n_mc=16)
    res = vi.run_vi(_diag_lp, torch.zeros(2),
                    torch.Generator().manual_seed(0), cfg)
    np.testing.assert_allclose(res.mu.numpy(), MEAN, atol=0.1)
    np.testing.assert_allclose(res.scale.numpy(), SD, rtol=0.2)
    tr = res.elbo_trace.numpy()
    assert tr[-50:].mean() > tr[:50].mean()


def test_fullrank_recovers_correlation():
    lp, _ = _quad(MEAN, PREC)
    cfg = vi.VIConfig(n_steps=2000, n_mc=16, full_rank=True)
    gen = torch.Generator().manual_seed(1)
    res = vi.run_vi(lp, torch.zeros(2), gen, cfg)
    np.testing.assert_allclose(vi.posterior_covariance(res).numpy(), COV,
                               atol=0.2)
    samples = vi.sample_posterior(res, gen, 4000).numpy()
    assert np.corrcoef(samples.T)[0, 1] > 0.6


def test_vi_signatures_match_base_tpu():
    """run_vi, run_vi_chunked and vi_warm_start take base_tpu's
    parameters with its defaults (the JAX key is a torch.Generator); the
    chunked run is run_vi, chunk_steps marking only where a checkpoint
    would go."""
    import inspect

    for name, key in (("run_vi", "gen"), ("run_vi_chunked", "gen"),
                      ("vi_warm_start", "gen")):
        ours = inspect.signature(getattr(vi, name)).parameters
        ref = inspect.signature(getattr(jvi, name)).parameters
        assert [key if p == "key" else p for p in ref] == list(ours)
        for p, q in zip(ref.values(), ours.values()):
            if p.name != "cfg":
                assert p.default == q.default
    lp, _ = _quad(MEAN, PREC)
    cfg = vi.VIConfig(n_steps=40, n_mc=4, full_rank=True)
    a = vi.run_vi(lp, torch.zeros(2), torch.Generator().manual_seed(5), cfg)
    b = vi.run_vi_chunked(lp, torch.zeros(2),
                          torch.Generator().manual_seed(5), cfg,
                          chunk_steps=7)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_vi_warm_start_pins():
    """vi_warm_start's default config is base_tpu's; pinned dims keep z0
    in every draw and a unit diagonal, without cross terms, in the
    metric; the free block of the metric is the fitted covariance."""
    assert jvi.VIConfig(n_steps=600, n_mc=8, full_rank=True,
                        learning_rate=2e-2, init_log_sd=-4.0) == \
        jvi.VIConfig(**vars(vi.VIConfig(n_steps=600, n_mc=8, full_rank=True,
                                        learning_rate=2e-2,
                                        init_log_sd=-4.0)))
    mean = np.array([1.0, 5.0, -1.0], np.float32)
    lp, _ = _quad(mean, np.diag([4.0, 1.0, 1.0]).astype(np.float32))
    z0 = torch.tensor([0.0, 7.0, 0.0])
    free = (1.0, 0.0, 1.0)
    draws, cov, res = vi.vi_warm_start(lp, z0, torch.Generator()
                                       .manual_seed(2), 6, free_mask=free)
    assert draws.shape == (6, 3) and cov.shape == (3, 3)
    assert bool((draws[:, 1] == 7.0).all())
    assert float(draws[:, 0].std()) > 0
    assert float(cov[1, 1]) == 1.0
    assert bool((cov[1, [0, 2]] == 0).all() and (cov[[0, 2], 1] == 0).all())
    full = vi.posterior_covariance(res)
    torch.testing.assert_close(cov[[0, 2]][:, [0, 2]],
                               full[[0, 2]][:, [0, 2]])
    np.testing.assert_allclose(res.mu[[0, 2]].numpy(), mean[[0, 2]],
                               atol=0.15)
