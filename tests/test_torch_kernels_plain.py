"""The plain PyTorch versions of kernels 3 and 4 (base_tpu_torch.ops.marglik,
what a CPU tensor runs) against base_tpu's jnp path and its Pallas kernels
in interpret mode, forward and backward, on identical float32 inputs made
with numpy, and the wrappers' chain limit; with the problem builders of
the files that hold the rest (a file holds at most 8 Tier-1 tests:
pytest-xdist's loadfile hands out files with more tests ahead of the JAX
long pole, tests/test_cli_mesh.py): kernels 1 and 2 in
tests/test_torch_table_plain.py, kernel 1's window in
tests/test_torch_table_window.py, kernel 4's skip rules in
tests/test_torch_marglik_skip.py and, at 29 bands,
tests/test_torch_marglik_skip_wide.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.model import likelihood as jlk
from base_tpu.model.stardata import make_ms_stars
from base_tpu.ops.pallas_marglik import fused_log_marginals as jfused
from base_tpu_torch.model import likelihood as tlk
from base_tpu_torch.ops import marglik as tml

torch.set_num_threads(1)


def _problem(seed, S, T, B=8):
    """A random marginal problem as tests/test_pallas_marglik.py builds it:
    (base_tpu stars, base_tpu table)."""
    rng = np.random.default_rng(seed)
    model_mags = rng.normal(12.0, 3.0, (T + 1, B)).astype(np.float32)
    lo = model_mags[:-1]
    hi = lo + rng.normal(0.0, 0.3, (T, B)).astype(np.float32)
    pick = rng.integers(0, T, S)
    obs = lo[pick] + rng.normal(0, 0.05, (S, B)).astype(np.float32)
    sig = np.abs(rng.normal(0.05, 0.02, (S, B))).astype(np.float32) + 0.01
    sig[rng.random((S, B)) < 0.1] = -9.0  # unobserved bands
    stars = make_ms_stars(obs, sig)
    logw = rng.normal(-2.0, 1.0, T).astype(np.float32)
    mask = rng.random(T) > 0.15
    table = jlk.SegmentTable(lo=jnp.asarray(lo), hi=jnp.asarray(hi),
                             logw=jnp.asarray(logw), mask=jnp.asarray(mask))
    return stars, table


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_args(stars, table):
    """fused_log_marginals arguments with a chain axis of 1."""
    return (_t(stars.obs_mags), _t(stars.inv_var), _t(stars.log_norm),
            _t(table.lo)[None], _t(table.hi)[None], _t(table.logw)[None],
            _t(table.mask)[None].float())


# base_tpu's references, jitted: each compiles once per shape, where eager
# dispatch compiles every primitive on its first call.
_jfused = jax.jit(jfused, static_argnums=7)
_jms_marginals = jax.jit(jlk.ms_star_log_marginals)


def _pallas(stars, table, log_norm=None, lo=None, hi=None, logw=None):
    return _jfused(
        stars.obs_mags, stars.inv_var,
        stars.log_norm if log_norm is None else log_norm,
        table.lo if lo is None else lo, table.hi if hi is None else hi,
        table.logw if logw is None else logw,
        table.mask.astype(jnp.float32), True,  # interpret on CPU
    )


@pytest.mark.parametrize("shape", [(37, 133), (64, 128)])
def test_marglik_plain_forward(shape):
    """Kernel 3's plain version == base_tpu ms_star_log_marginals and the
    interpret-mode Pallas kernel: the same formula, so atol 1e-4 (float32
    transcendental ulps) where the value is > -200."""
    stars, table = _problem(1, *shape)
    got = tml.marglik_fwd_plain(*_torch_args(stars, table)).numpy()[0]
    for want in (np.asarray(_jms_marginals(stars, table)),
                 np.asarray(_pallas(stars, table))):
        sel = want > -200
        assert sel.sum() > 10
        np.testing.assert_allclose(got[sel], want[sel], rtol=0, atol=1e-4)


def test_marglik_plain_backward_matches_pallas_vjp():
    """Kernel 4's plain version (the analytic truncated-Gaussian moments)
    == jax.grad of the interpret-mode Pallas kernel, whose backward is the
    same analytic formula: scaled atol 1e-4."""
    S = 23
    stars, table = _problem(2, S, 67)
    g = np.random.default_rng(3).normal(0, 1.0, S).astype(np.float32)

    def f(lo, hi, logw, ln):
        return jnp.sum(_pallas(stars, table, ln, lo, hi, logw) * g)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        table.lo, table.hi, table.logw, stars.log_norm)
    args = list(_torch_args(stars, table))
    for i in (2, 3, 4, 5):
        args[i].requires_grad_(True)
    out = tml.fused_log_marginals(*args)
    got = torch.autograd.grad((out[0] * _t(g)).sum(),
                              [args[3], args[4], args[5], args[2]])
    for w, gt, name in zip(want, got, ["lo", "hi", "logw", "log_norm"]):
        w = np.asarray(w)
        gt = gt.numpy().reshape(w.shape)
        scale = np.abs(w).max() + 1e-6
        np.testing.assert_allclose(gt / scale, w / scale, atol=1e-4,
                                   err_msg=name)


def test_marglik_analytic_backward_matches_autograd():
    """The analytic backward against torch autograd through the plain
    forward: both differentiate the same function, but autograd goes
    through the erf polynomial while the analytic form uses exact Gaussian
    moments, so scaled atol 5e-3 as tests/test_pallas_marglik.py allows."""
    stars, table = _problem(4, 19, 53)
    args = list(_torch_args(stars, table))
    g = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (1, 19))
                         .astype(np.float32))
    grads = []
    for fn in (tml.fused_log_marginals, tml.marglik_fwd_plain):
        a = [x.clone() for x in args]
        for i in (3, 4, 5):
            a[i].requires_grad_(True)
        grads.append(torch.autograd.grad((fn(*a) * g).sum(), a[3:6]))
    for got, want, name in zip(*grads, ["lo", "hi", "logw"]):
        scale = want.abs().max() + 1e-6
        np.testing.assert_allclose((got / scale).numpy(),
                                   (want / scale).numpy(), atol=5e-3,
                                   err_msg=name)


def test_marglik_chain_axis():
    """Chains carry their own tables against shared photometry: the
    [C, T, B] call equals C single-chain calls bit for bit."""
    stars, table = _problem(6, 17, 45)
    obs, iv, ln, lo, hi, logw, mk = _torch_args(stars, table)
    los = torch.cat([lo + 0.01 * i for i in range(3)])
    his = torch.cat([hi + 0.01 * i for i in range(3)])
    both = tml.marglik_fwd_plain(obs, iv, ln, los, his, logw.expand(3, -1),
                                 mk.expand(3, -1))
    for i in range(3):
        one = tml.marglik_fwd_plain(obs, iv, ln, los[i:i + 1],
                                    his[i:i + 1], logw, mk)
        torch.testing.assert_close(both[i], one[0], rtol=0, atol=0)


# --- Fused table build (kernels 1 and 2) -----------------------------------


# --- Kernel 2's sparse window (ops.table.hat_zero_bounds / hat_window) ----


# --- Kernel 4's skip rule (ops.marglik.marglik_bwd_skip) -------------------

TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.0, 0.0, 0.0], np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32)
FREE = np.array([1, 1, 1, 1, 1, 0, 0, 0, 0], np.float32)


def _config1_marglik_args(upsample, chains=4):
    """Kernel 4's inputs on the config-1 path (synthetic grid of 64 EEPs,
    100 simulated stars with 30% binaries, n_q 8) at `chains` points
    scattered around the truth, through the port's own fixtures."""
    from base_tpu_torch.grids import synthetic as tsyn
    from base_tpu_torch.grids.isochrone import derive_isochrone as tderive
    from base_tpu_torch.grids.isochrone import upsample_isochrone as tups
    from base_tpu_torch.model import posterior as tpost
    from base_tpu_torch.model.stardata import make_ms_stars as tstars
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    grid = tsyn.make_grid(n_eep=64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cat = simulate_cluster(grid, torch.as_tensor(TRUTH), 100, gen,
                           percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    stars = tstars(sc.mags.numpy(), sc.sigmas.numpy(), cm_prior=0.99,
                   device="cpu")
    model = tpost.make_single_pop_model(grid, stars, TRUTH, PRIOR_SIGMA,
                                        n_q=8, upsample=upsample,
                                        device="cpu")
    tr = tpost.default_transform(model)
    noise = np.random.default_rng(1).normal(0, 0.05, (chains, 9)) * FREE
    noise[0] = 0.0
    z = tr.inverse(torch.as_tensor(TRUTH)) + _t(noise.astype(np.float32))
    x = tr.forward(z)
    base = tderive(grid, x[:, 2], x[:, 1], x[:, 0])
    table = tlk.build_segment_table_fused(
        tups(base, upsample), model.q_grid, x[:, 3], x[:, 4],
        model.abs_coefs, sec_iso=base)
    return (stars.obs_mags, stars.inv_var, stars.log_norm, table.lo,
            table.hi, table.logw, table.mask.float())


def _softmax_weights(args, out, g=None):
    """marglik_bwd_plain's per-element weights g exp(core - out') width
    [C, S, T], zero on masked segments."""
    obs, iv, ln, lo, hi, logw, mask = args
    alpha, beta, gamma, _, _, _ = tml._abg(obs, iv, lo, hi)
    live = (mask > 0.5)[:, None, :]
    core, width, _ = tml._core_width(alpha, beta, gamma, logw[:, None, :],
                                     live)
    w = torch.exp(core - (out - ln)[:, :, None]) * width
    if g is not None:
        w = g[:, :, None] * w
    return torch.where(live, w, torch.zeros_like(w))


def _skip_misses(args, out, g=None):
    """(marked elements with a non-zero weight, marked, live elements)."""
    skip = tml.marglik_bwd_skip(*args, out)
    w = _softmax_weights(args, out, g)
    live = int((args[6] > 0.5).sum()) * args[0].shape[0]
    return int((skip & (w != 0.0)).sum()), int(skip.sum()), live


def _group_misses(args, out, g=None):
    """Kernel 4's group rule: (marked (chain, star, group)s holding an
    element with a non-zero weight, marked, those with a live segment)."""
    marked = tml.marglik_bwd_group_skip(*args, out)
    w = _softmax_weights(args, out, g)
    C, S, T = w.shape
    pad = marked.shape[2] * tml.SKIP_GROUP - T
    live = torch.nn.functional.pad(args[6] > 0.5, (0, pad))
    nonzero = torch.nn.functional.pad(w != 0.0, (0, pad))
    nonzero = nonzero.reshape(C, S, -1, tml.SKIP_GROUP).any(-1)
    live = live.reshape(C, 1, -1, tml.SKIP_GROUP).any(-1).expand_as(marked)
    return (int((marked & nonzero).sum()), int(marked.sum()),
            int(live.sum()))


def _adversarial_args(case, C=2, S=29, T=67, B=8, seed=13):
    """A random marginal problem bent toward one edge of the rule."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(12.0, 3.0, (C, T, B))
    hi = lo + rng.normal(0.0, 0.3, (C, T, B))
    sig = np.abs(rng.normal(0.05, 0.02, (S, B))) + 0.01
    pick = rng.integers(0, T, S)
    obs = lo[0, pick] + rng.normal(0, 0.05, (S, B))
    mask = rng.random((C, T)) > 0.15
    if case == "flat":          # alpha = 0 exactly, or below _FLAT_EPS
        hi[:, ::3] = lo[:, ::3]
        hi[:, 1::3] = lo[:, 1::3] + 1e-6 * rng.choice([-1.0, 1.0],
                                                      hi[:, 1::3].shape)
        obs = lo[0, pick] + rng.normal(0, 0.3, (S, B))
    elif case == "far_mu":      # obs far along the segment: mu ~ +-50
        k = rng.choice([-50.0, -3.0, 4.0, 50.0], (S, 1))
        obs = lo[0, pick] + k * (hi[0, pick] - lo[0, pick])
    elif case == "huge_gamma":  # gamma ~ 1e7 against chi2c = O(1-100)
        sig[:] = 0.01
        hi = lo + rng.normal(0.0, 10.0, (C, T, B))
        u = rng.uniform(0.2, 0.8, (S, 1))
        obs = (lo[0, pick] + u * (hi[0, pick] - lo[0, pick])
               + rng.normal(0, 0.02, (S, B)))
    elif case == "unobserved":  # whole bands with inv_var = 0
        sig[rng.random((S, B)) < 0.5] = -9.0
        sig[0] = -9.0           # a star with no band at all
    elif case == "masked":      # a chain with every segment masked
        mask[1] = False
    iv = np.where(sig > 0, 1.0 / sig**2, 0.0)
    ln = np.where(sig > 0, -np.log(np.abs(sig)) - 0.9189385332046727,
                  0.0).sum(-1)
    logw = rng.normal(-2.0, 1.0, (C, T))
    arrays = (obs, iv, ln, lo, hi, logw, mask)
    return tuple(torch.as_tensor(np.asarray(a, np.float32)) for a in arrays)


def test_kernel_wrappers_refuse_more_chains_than_the_grid_takes():
    """The kernels put the chain axis on gridDim.y (at most 65535 blocks):
    each CUDA wrapper raises on 65536 chains before it looks at the device
    or launches, and counts no launch."""
    from base_tpu_torch.ops import build
    from base_tpu_torch.ops import table as ttb

    C = build.MAX_CHAINS + 1
    stars, table = _problem(7, 2, 2, B=1)
    obs, iv, ln, lo, hi, logw, mk = _torch_args(stars, table)
    big = (obs, iv, ln, *(t.expand(C, *t.shape[1:]).contiguous()
                          for t in (lo, hi, logw, mk)))
    node = torch.zeros(C, 1, 3)
    axis = torch.zeros(C, 2, 1)
    tbig = (torch.zeros(C, 1, 3), node, node, torch.zeros(C, 1, 2),
            axis, axis, axis, axis)
    before = (tml.marglik_fwd_launches, tml.marglik_bwd_launches,
              ttb.table_fwd_launches, ttb.table_bwd_launches)
    out = torch.zeros(C, 2)
    for call in (lambda: tml.marglik_fwd_cuda(*big),
                 lambda: tml.marglik_bwd_cuda(*big, out, out),
                 lambda: ttb.table_fwd_cuda(*tbig),
                 lambda: ttb.table_bwd_cuda(*tbig, tbig[0])):
        with pytest.raises(ValueError, match="at most 65535"):
            call()
    assert (tml.marglik_fwd_launches, tml.marglik_bwd_launches,
            ttb.table_fwd_launches, ttb.table_bwd_launches) == before
