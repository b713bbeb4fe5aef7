"""The port's HMC (base_tpu_torch.inference): moment tests on the Gaussian
targets of tests/test_samplers.py (threefry and Philox streams differ, so
there is no bit parity with base_tpu), the chunked runner against run_hmc
bit for bit, the diagnostics against base_tpu's on a fixed sample array,
and a check that the port never imports JAX."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from base_tpu.inference import diagnostics as jdiag
from base_tpu_torch.inference import diagnostics as tdiag
from base_tpu_torch.inference import hmc
from base_tpu_torch.inference.driver import make_hmc_chunked_runner

torch.set_num_threads(1)

COV = np.array([[1.0, 0.7], [0.7, 2.0]], np.float32)
MEAN = np.array([1.0, -2.0], np.float32)
PREC = torch.from_numpy(np.linalg.inv(COV).astype(np.float32))


def gauss_logpost(x):
    d = x - torch.from_numpy(MEAN)
    return -0.5 * ((d @ PREC) * d).sum(-1)


def _init(seed, shape, scale=1.0):
    return scale * torch.randn(shape, generator=torch.Generator()
                               .manual_seed(seed))


def test_hmc_gaussian_moments():
    cfg = hmc.HMCConfig(n_warmup=400, n_samples=500, l_max=16)
    samples, info = hmc.run_hmc(gauss_logpost, _init(1, (8, 2)),
                                torch.Generator().manual_seed(2), cfg)
    flat = samples.reshape(-1, 2).numpy()
    assert float(info["accept_prob"]) > 0.5
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.4)
    im = info["inv_mass"].numpy()   # adaptation learned the scale order
    assert im[1] > im[0]


def test_hmc_step_jitter_gaussian_moments():
    """jitter_mode='step' with a dense metric, the bench's mode."""
    cfg = hmc.HMCConfig(n_warmup=400, n_samples=500, l_max=16,
                        jitter_mode="step", dense_mass=True)
    samples, info = hmc.run_hmc(gauss_logpost, _init(7, (8, 2)),
                                torch.Generator().manual_seed(8), cfg)
    flat = samples.reshape(-1, 2).numpy()
    assert float(info["accept_prob"]) > 0.6
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.4)


def test_hmc_dense_mass_correlated_gaussian():
    """The dense metric recovers a strongly correlated Gaussian's
    covariance, in the samples and in the adapted metric."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    cov = a @ a.T + 0.1 * np.eye(4, dtype=np.float32)
    icov = torch.from_numpy(np.linalg.inv(cov))

    def logpost(z):
        return -0.5 * ((z @ icov) * z).sum(-1)

    cfg = hmc.HMCConfig(n_warmup=400, n_samples=400, l_max=12,
                        dense_mass=True)
    samples, info = hmc.run_hmc(logpost, _init(5, (8, 4)),
                                torch.Generator().manual_seed(6), cfg)
    assert float(info["accept_prob"]) > 0.6
    im = info["inv_mass"].numpy()
    assert im.shape == (4, 4)
    emp = np.cov(samples.reshape(-1, 4).numpy().T)
    assert np.abs(emp - cov).max() / np.abs(cov).max() < 0.25
    assert np.abs(im - cov).max() / np.abs(cov).max() < 0.35


def test_pinned_params_never_move():
    """free_mask 0 pins a dim: its momentum and gradient are zero."""
    cfg = hmc.HMCConfig(n_warmup=40, n_samples=40, l_max=8, dense_mass=True,
                        free_mask=(1.0, 0.0))
    init = _init(9, (4, 2))
    samples, _ = hmc.run_hmc(gauss_logpost, init,
                             torch.Generator().manual_seed(10), cfg)
    assert torch.equal(samples[:, :, 1], init[None, :, 1].expand(40, 4))
    assert samples[:, :, 0].std() > 0.1


def test_chunked_runner_bit_identical():
    """The chunked runner (per-window warmup, uneven sampling chunks) ==
    run_hmc bit for bit under one generator seed."""
    cfg = hmc.HMCConfig(n_warmup=90, n_samples=60, l_max=6, n_windows=3,
                        dense_mass=True)
    init = _init(3, (6, 2), 0.3)
    zs_mono, info_mono = hmc.run_hmc(gauss_logpost, init,
                                     torch.Generator().manual_seed(4), cfg)
    zs_chunk, info_chunk = make_hmc_chunked_runner(
        gauss_logpost, cfg, chunk_draws=25)(
        init, torch.Generator().manual_seed(4))
    assert torch.equal(zs_mono, zs_chunk)
    assert torch.equal(info_mono["inv_mass"], info_chunk["inv_mass"])
    assert torch.equal(info_mono["step_size"], info_chunk["step_size"])
    assert torch.equal(info_mono["logposts"], info_chunk["logposts"])


def test_hmc_same_seed_bit_identical():
    cfg = hmc.HMCConfig(n_warmup=20, n_samples=20, l_max=4, n_windows=2)

    def run(seed):
        return hmc.run_hmc(gauss_logpost, _init(0, (3, 2), 0.1),
                           torch.Generator().manual_seed(seed), cfg)[0]

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))


def test_diagnostics_match_jax():
    """split_rhat and ess on a fixed AR(1) sample array [N, C, P] equal
    base_tpu's to float32 FFT reassociation (rtol 1e-4)."""
    rng = np.random.default_rng(11)
    n, c, p = 400, 6, 3
    x = np.zeros((n, c, p), np.float32)
    phi = np.array([0.0, 0.6, 0.95], np.float32)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + rng.normal(size=(c, p))
    x[:, 0, 2] += 0.5                       # one offset chain: R-hat > 1
    for name in ("split_rhat", "ess"):
        want = np.asarray(getattr(jdiag, name)(jnp.asarray(x)))
        got = getattr(tdiag, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=name)


def test_port_never_imports_jax():
    """Every base_tpu_torch module imports, and a CPU density + gradient
    runs, in a process that never loads JAX."""
    code = """
import importlib, pkgutil, sys
import numpy as np, torch
import base_tpu_torch
for m in pkgutil.walk_packages(base_tpu_torch.__path__, "base_tpu_torch."):
    importlib.import_module(m.name)
from base_tpu_torch.grids import synthetic
from base_tpu_torch.inference.hmc import value_and_grad
from base_tpu_torch.model import posterior as post
from base_tpu_torch.model.stardata import make_ms_stars
grid = synthetic.make_grid(n_eep=12, device="cpu")
stars = make_ms_stars(np.full((4, 8), 18.0), np.full((4, 8), 0.05),
                      device="cpu")
truth = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
m = post.make_single_pop_model(grid, stars, truth, np.full(9, -1.0),
                               n_q=3, device="cpu")
tr = post.default_transform(m)
z = tr.inverse(torch.as_tensor(truth))[None].repeat(2, 1)
lp, g = value_and_grad(post.make_logpost_z_fn(m, tr))(z)
assert torch.isfinite(lp).all() and torch.isfinite(g).all()
assert "jax" not in sys.modules, sorted(k for k in sys.modules if "jax" in k)
print("ok")
"""
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
