"""The port's tempered SMC runs: the moment and evidence tests of
tests/test_smc.py (threefry and Philox streams differ, so there is no bit
parity with base_tpu's draws); the folded replicates against runs of each
replicate alone and the chunked runner against run_smc_replicated, bit
for bit; one density call per move for all replicates' particles
(tests/test_torch_smc.py holds the pieces held to base_tpu)."""
import math

import numpy as np
import torch

from base_tpu_torch.inference import smc
from test_torch_smc import COV, LOG_Z, MEAN, log_q0, log_target, sample_q0

torch.set_num_threads(1)


def test_smc_gaussian_moments_and_evidence():
    cfg = smc.SMCConfig(n_particles=2048, n_move=4)
    z, info = smc.run_smc(log_target, sample_q0, log_q0,
                          torch.Generator().manual_seed(0), cfg)
    zs = z.numpy()
    assert float(info["beta"]) == 1.0
    assert int(info["n_stages"]) < cfg.max_stages
    assert info["betas"].shape == (cfg.max_stages,)
    np.testing.assert_allclose(zs.mean(0), MEAN, atol=0.1)
    np.testing.assert_allclose(np.cov(zs.T), COV, atol=0.25)
    np.testing.assert_allclose(float(info["log_evidence"]), LOG_Z, atol=0.15)


def test_smc_bimodal_mode_weights():
    """Two well-separated modes with 70/30 weights: tempering keeps
    both."""
    mu = 4.0

    def lt(z):
        a = -0.5 * ((z - mu) ** 2).sum(-1) + math.log(0.7)
        b = -0.5 * ((z + mu) ** 2).sum(-1) + math.log(0.3)
        return torch.logaddexp(a, b)

    z, _ = smc.run_smc(lt, sample_q0, log_q0,
                       torch.Generator().manual_seed(1),
                       smc.SMCConfig(n_particles=2048, n_move=4))
    frac_pos = float((z[:, 0] > 0).float().mean())
    assert 0.55 < frac_pos < 0.85, frac_pos


def test_smc_move_autotune_reaches_band():
    """A move kernel 30x too wide is pulled into a usable acceptance band
    by the per-stage autotuner, and the posterior is still right."""
    cfg = smc.SMCConfig(n_particles=1024, n_move=4, move_scale=30.0,
                        max_stages=32, ess_target=0.8)
    z, info = smc.run_smc(log_target, sample_q0, log_q0,
                          torch.Generator().manual_seed(3), cfg)
    assert float(info["move_scale"]) < 10.0
    np.testing.assert_allclose(z.numpy().mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(float(info["log_evidence"]), LOG_Z, atol=0.2)


def test_smc_replicated_evidence_se():
    """run_smc_replicated: pooled particles and a repeat-run standard error
    that covers the analytic log evidence."""
    cfg = smc.SMCConfig(n_particles=512, n_move=3)
    z, info = smc.run_smc_replicated(log_target, sample_q0, log_q0,
                                     torch.Generator().manual_seed(4), cfg,
                                     n_rep=4)
    assert z.shape == (4 * 512, 2)
    le, se = float(info["log_evidence"]), float(info["log_evidence_se"])
    assert se > 0.0
    assert info["log_evidences"].shape == (4,)
    assert info["betas"].shape == (4, cfg.max_stages)
    assert abs(le - LOG_Z) < max(4 * se, 0.25)
    np.testing.assert_allclose(z.numpy().mean(0), MEAN, atol=0.15)


def test_folded_replicates_equal_single_runs_and_chunked():
    """The replicates of one folded run (3 x 128 particles, one density
    call per move for all 384 rows) equal runs of each replicate alone on
    its generator, bit for bit in particles, betas and log-evidence; the
    chunked runner equals run_smc_replicated bit for bit; every density
    call after the first holds all rows, one per move of each stage."""
    cfg = smc.SMCConfig(n_particles=128, n_move=2, max_stages=16)
    rows = []

    def lt(z):
        rows.append(z.shape[0])
        return log_target(z)

    z, info = smc.run_smc_replicated(lt, sample_q0, log_q0,
                                     torch.Generator().manual_seed(11), cfg,
                                     n_rep=3)
    assert set(rows) == {384}
    assert len(rows) == 1 + cfg.n_move * int(info["n_stages"])
    gens = smc.replicate_generators(torch.Generator().manual_seed(11), 3)
    for r, gen in enumerate(gens):
        zr, ir = smc.run_smc(log_target, sample_q0, log_q0, gen, cfg)
        assert torch.equal(zr, z[128 * r:128 * (r + 1)])
        assert torch.equal(ir["betas"], info["betas"][r])
        assert torch.equal(ir["log_evidence"], info["log_evidences"][r])
    zc, ic = smc.make_smc_chunked_runner(log_target, sample_q0, log_q0,
                                         cfg, n_rep=3)(
        torch.Generator().manual_seed(11))
    assert torch.equal(zc, z)
    assert torch.equal(ic["log_evidences"], info["log_evidences"])
    for key in ("log_evidence", "log_evidence_se", "beta", "n_stages",
                "accept", "move_scale"):
        assert ic[key] == info[key].item(), key
