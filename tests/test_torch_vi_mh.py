"""The port's VI (base_tpu_torch.inference.vi) and adaptive MH
(base_tpu_torch.inference.mh) against base_tpu's: the Adam loop fed
base_tpu's own noise tracks base_tpu.inference.vi.run_vi step for step;
one Metropolis step given the same offset and uniform agrees; and the
moment tests of tests/test_vi.py and tests/test_samplers.py on the port's
own draws (threefry and Philox streams differ, so a whole run has no bit
parity with base_tpu)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.inference import mh as jmh
from base_tpu.inference import vi as jvi
from base_tpu_torch.inference import mh
from base_tpu_torch.inference import vi

torch.set_num_threads(1)

# tests/test_vi.py's targets.
MEAN = np.array([2.0, -1.0], np.float32)
SD = np.array([0.5, 1.5], np.float32)
COV = np.array([[1.0, 0.8], [0.8, 1.0]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)
# tests/test_samplers.py's MH target.
S_COV = np.array([[1.0, 0.7], [0.7, 2.0]], np.float32)
S_MEAN = np.array([1.0, -2.0], np.float32)
S_PREC = np.linalg.inv(S_COV).astype(np.float32)


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


def test_mh_step_matches_jax():
    """One Metropolis step of 6 chains given the same offsets and accept
    uniforms (base_tpu draws its uniform from split(state.key)[1]):
    identical acceptances and states, and a proposal out of the support
    (NEG_INF) is never taken."""
    lp, jlp = _quad(S_MEAN, S_PREC)
    neg = -1e30

    def lp_cut(x):
        return torch.where(x[:, 0] > 2.5, torch.full_like(x[:, 0], neg),
                           lp(x))

    def jlp_cut(x):
        return jnp.where(x[0] > 2.5, neg, jlp(x))

    rng = np.random.default_rng(3)
    pos = rng.normal(0, 1, (6, 2)).astype(np.float32)
    pos[5] = (2.0, -2.0)
    delta = rng.normal(0, 1.5, (6, 2)).astype(np.float32)
    delta[5] = (1.0, 0.0)                     # lands where lp is NEG_INF
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    jstate = jmh.MHState(position=jnp.asarray(pos),
                         logpost=jax.vmap(jlp_cut)(jnp.asarray(pos)),
                         key=keys)
    jnew, jacc = jax.vmap(lambda s, d: jmh._mh_step(jlp_cut, s, d))(
        jstate, jnp.asarray(delta))
    u = np.array([float(jax.random.uniform(jax.random.split(k)[1], ()))
                  for k in keys], np.float32)
    state = mh.MHState(position=torch.from_numpy(pos),
                       logpost=lp_cut(torch.from_numpy(pos)))
    new, acc = mh._mh_step(lp_cut, state, torch.from_numpy(delta),
                           torch.from_numpy(u))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert 0 < int(acc.sum()) < 5 and not bool(acc[5])
    np.testing.assert_array_equal(new.position.numpy(),
                                  np.asarray(jnew.position))
    np.testing.assert_allclose(new.logpost.numpy(), np.asarray(jnew.logpost),
                               rtol=1e-6)


def test_mh_gaussian_moments():
    """tests/test_samplers.py's moment test on 8 chains at once."""
    lp, _ = _quad(S_MEAN, S_PREC)
    cfg = mh.MHConfig(n_stage1=500, n_stage2=500, n_main=4000)
    samples, info = mh.run_adaptive_mh(lp, torch.zeros(8, 2),
                                       torch.Generator().manual_seed(0),
                                       torch.ones(2) * 0.5, cfg)
    assert samples.shape == (4000, 8, 2)
    flat = samples.reshape(-1, 2).numpy()
    rate = float(info["accept_rate"].mean())
    assert 0.1 < rate < 0.7
    np.testing.assert_allclose(flat.mean(0), S_MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), S_COV, atol=0.4)
    assert info["stage1_rates"].shape == (10, 8)
    assert info["chol"].shape == (8, 2, 2) and info["step"].shape == (8, 2)
    assert info["logposts"].shape == (4000, 8)


def test_mh_pinned_params_never_move():
    lp, _ = _quad(S_MEAN, S_PREC)
    cfg = mh.MHConfig(n_stage1=200, n_stage2=200, n_main=500)
    samples, _ = mh.run_adaptive_mh(lp, torch.tensor([[0.0, 3.5]]),
                                    torch.Generator().manual_seed(3),
                                    torch.tensor([0.5, 0.0]), cfg)
    s = samples[:, 0].numpy()
    assert np.all(s[:, 1] == 3.5)
    assert np.std(s[:, 0]) > 0.1


def test_mh_burnin_density_and_handoff():
    """Stages 1-2 run on logpost_burnin_fn; stage 3 targets the full
    density, re-evaluated at the hand-off: every recorded log posterior
    is the full density at its sample."""
    lp, _ = _quad(S_MEAN, S_PREC)

    def burn(x):
        return 0.5 * lp(x)

    cfg = mh.MHConfig(n_stage1=100, n_stage2=100, n_main=50, thin=2)
    samples, info = mh.run_adaptive_mh(lp, torch.zeros(3, 2),
                                       torch.Generator().manual_seed(6),
                                       torch.ones(2) * 0.5, cfg,
                                       logpost_burnin_fn=burn)
    assert samples.shape == (25, 3, 2)
    torch.testing.assert_close(info["logposts"], lp(samples), rtol=1e-6,
                               atol=1e-6)
