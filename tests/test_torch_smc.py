"""The port's tempered SMC (base_tpu_torch.inference.smc): the ESS
fraction, systematic resampling and one stage's beta and log-evidence
increment against base_tpu's on identical float32 state, and `group` over
a world of one.  The moment and evidence tests, the folded replicates and
the chunked runner are in tests/test_torch_smc_runs.py (a file holds at
most 8 Tier-1 tests: pytest-xdist's loadfile hands out files with more
tests ahead of the JAX long pole, tests/test_cli_mesh.py)."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.inference import smc as jsmc
from base_tpu_torch.inference import smc

torch.set_num_threads(1)

P = 2
MEAN = np.array([1.5, -0.5], np.float32)
COV = np.array([[0.5, 0.2], [0.2, 0.8]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)
# target = unnormalized Gaussian: log Z = log((2 pi)^{d/2} |COV|^{1/2})
LOG_Z = 0.5 * P * np.log(2 * np.pi) + 0.5 * np.log(np.linalg.det(COV))
Q0_SD = 4.0


def log_target(z):
    d = z - torch.from_numpy(MEAN)
    return -0.5 * ((d @ torch.from_numpy(PREC)) * d).sum(-1)


def log_q0(z):
    return (-0.5 * (z / Q0_SD) ** 2 - math.log(Q0_SD)
            - 0.5 * math.log(2 * math.pi)).sum(-1)


def sample_q0(gen, n):
    return Q0_SD * torch.randn((n, P), generator=gen)


def _jlog_target(z):
    d = z - jnp.asarray(MEAN)
    return -0.5 * d @ jnp.asarray(PREC) @ d


def _jlog_q0(z):
    return jnp.sum(-0.5 * (z / Q0_SD) ** 2 - jnp.log(Q0_SD)
                   - 0.5 * jnp.log(2 * jnp.pi))


def _particles(seed, n):
    """q0 particles made with numpy, their log target and log q0."""
    z = (Q0_SD * np.random.default_rng(seed).normal(size=(n, P))).astype(
        np.float32)
    zt = torch.from_numpy(z)
    return z, log_target(zt).numpy(), log_q0(zt).numpy()


def test_ess_fraction_matches_jax():
    """_ess_fraction on spread log weights == base_tpu's to 1e-5."""
    log_w = np.random.default_rng(0).normal(0, 3.0, (4, 300)).astype(
        np.float32)
    got = smc._ess_fraction(torch.from_numpy(log_w), 300.0).numpy()
    want = jax.jit(jax.vmap(lambda w: jsmc._ess_fraction(
        w, jnp.float32(300.0), None)))(log_w)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    assert 0.0 < got.min() and got.max() < 1.0


def test_systematic_resample_matches_jax():
    """Given base_tpu's own uniform, _systematic_resample picks the same
    ancestors: the resampled particles are equal."""
    rng = np.random.default_rng(1)
    z = rng.normal(size=(200, P)).astype(np.float32)
    log_w = rng.normal(0, 2.0, 200).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jax.jit(lambda k, w, x: jsmc._systematic_resample(
        k, w, x, None))(key, jnp.asarray(log_w), jnp.asarray(z)))
    u = torch.tensor([float(jax.random.uniform(key, ()))])
    got, anc = smc._systematic_resample(u, torch.from_numpy(log_w)[None],
                                        torch.from_numpy(z)[None])
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert len(set(anc[0].tolist())) < 200     # weights told


STAGE_CFG = smc.SMCConfig(n_particles=256, n_move=1)


@functools.cache
def _jax_stage():
    """base_tpu's stage at STAGE_CFG, jitted once for both cases."""
    return jax.jit(jsmc._make_smc_stage(_jlog_target, _jlog_q0, STAGE_CFG,
                                        None, jnp.float32(256.0), P))


@pytest.mark.parametrize("beta", [0.0, 0.3])
def test_stage_beta_and_evidence_match_jax(beta):
    """One stage from identical particles (at beta 0 and at 0.3): the next
    beta and the log-evidence increment, both deterministic in the stage,
    equal base_tpu's to 1e-5."""
    cfg = STAGE_CFG
    z, lt, lq = _particles(3, 256)
    jstage = _jax_stage()
    jstate = jsmc.SMCState(
        z=jnp.asarray(z), log_target=jnp.asarray(lt),
        log_q0=jnp.asarray(lq), beta=jnp.float32(beta),
        log_evidence=jnp.float32(0.0), log_move_scale=jnp.float32(0.0),
        key=jax.random.PRNGKey(4))
    jnew, _ = jstage(jstate)
    stage = smc._make_smc_stage(log_target, log_q0, cfg, None, 256.0, P)
    state = smc.SMCState(
        z=torch.from_numpy(z), log_target=torch.from_numpy(lt),
        log_q0=torch.from_numpy(lq), beta=torch.tensor([beta]),
        log_evidence=torch.zeros(1), log_move_scale=torch.zeros(1))
    new, (b, _, act) = stage(state, [torch.Generator().manual_seed(5)])
    assert bool(act[0]) and beta < float(b[0]) < 1.0
    np.testing.assert_allclose(float(new.beta[0]), float(jnew.beta),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(new.log_evidence[0]),
                               float(jnew.log_evidence), rtol=1e-5,
                               atol=1e-5)


def test_axis_name_not_supported():
    """base_tpu's axis_name is the port's `group` (a chain process group):
    run_smc over the group of a world of one equals run_smc without a
    group, bit for bit (base_tpu_torch.parallel runs the wider worlds)."""
    import torch.distributed as dist

    from base_tpu_torch.parallel import distributed

    cfg = smc.SMCConfig(n_particles=128, n_move=2, max_stages=8)
    want, wi = smc.run_smc(log_target, sample_q0, log_q0,
                           torch.Generator().manual_seed(0), cfg)
    with distributed.world_of_one("cpu"):
        got, gi = smc.run_smc(log_target, sample_q0, log_q0,
                              torch.Generator().manual_seed(0), cfg,
                              group=dist.group.WORLD)
    assert torch.equal(got, want)
    for key, value in wi.items():
        assert torch.equal(gi[key], value), key
