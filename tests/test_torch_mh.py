"""The port's adaptive MH (base_tpu_torch.inference.mh) against base_tpu's:
one Metropolis step given the same offset and uniform agrees; and the
moment tests of tests/test_samplers.py on the port's own draws (threefry
and Philox streams differ, so a whole run has no bit parity with
base_tpu).  The VI tests are in tests/test_torch_vi_mh.py."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from base_tpu.inference import mh as jmh
from base_tpu_torch.inference import mh
from test_torch_vi_mh import _quad

torch.set_num_threads(1)

# tests/test_samplers.py's MH target.
S_COV = np.array([[1.0, 0.7], [0.7, 2.0]], np.float32)
S_MEAN = np.array([1.0, -2.0], np.float32)
S_PREC = np.linalg.inv(S_COV).astype(np.float32)


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
