"""The plain PyTorch versions of the four kernels (base_tpu_torch.ops.table
and .marglik, what a CPU tensor runs) against base_tpu's jnp path and its
Pallas kernels in interpret mode, forward and backward, on identical
float32 inputs made with numpy."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.grids import synthetic as jsyn
from base_tpu.grids.isochrone import derive_isochrone as jderive
from base_tpu.grids.isochrone import upsample_isochrone as jupsample
from base_tpu.model import likelihood as jlk
from base_tpu.model.stardata import make_ms_stars
from base_tpu.ops.pallas_marglik import fused_log_marginals as jfused
from base_tpu_torch.grids.isochrone import Isochrone as TIsochrone
from base_tpu_torch.model import likelihood as tlk
from base_tpu_torch.ops import marglik as tml
from base_tpu_torch.ops.special import NEG_INF

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


@functools.cache
def _iso_problem(upsample, E=24, B=6):
    """base_tpu (iso, base iso, q, coefs) as tests/test_pallas_marglik.py
    builds them (derive_isochrone jitted), once per upsample."""
    grid = jsyn.make_grid(n_eep=E, bands=["U", "B", "V", "R", "I", "J"][:B])
    base = jax.jit(jderive)(grid, jnp.asarray(-0.5), jnp.asarray(0.27),
                            jnp.asarray(9.3))
    iso = jupsample(base, upsample) if upsample > 1 else base
    q = jnp.linspace(0.0, 1.0, 7)
    coefs = jnp.asarray(np.linspace(1.2, 0.4, B), jnp.float32)
    return iso, base, q, coefs


def _to_torch_iso(iso):
    """A base_tpu Isochrone as the port's, with a chain axis of 1."""
    return TIsochrone(**{f.name: _t(getattr(iso, f.name))[None]
                         for f in dataclasses.fields(iso)})


@pytest.mark.parametrize("upsample", [1, 3])
def test_fused_table_forward(upsample):
    """The fused table (kernel 1's plain version) == base_tpu's
    build_segment_table_fused in interpret mode, atol 2e-4 as the
    reference's own fused-vs-jnp test; weights to 1e-5 (log of float32
    masses through a different log10)."""
    iso, base, q, coefs = _iso_problem(upsample)
    mod, av = 9.7, 0.23
    want = jax.jit(lambda i, b: jlk.build_segment_table_fused(
        i, q, jnp.asarray(mod), jnp.asarray(av), coefs, sec_iso=b,
        interpret=True))(iso, base)
    got = tlk.build_segment_table_fused(
        _to_torch_iso(iso), _t(q), torch.tensor([mod]), torch.tensor([av]),
        _t(coefs), sec_iso=_to_torch_iso(base))
    for name in ("lo", "hi"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=2e-4, err_msg=name)
    np.testing.assert_allclose(got.logw[0].numpy(), np.asarray(want.logw),
                               atol=1e-5)
    np.testing.assert_array_equal(got.mask[0].numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("upsample", [1, 3])
def test_fused_table_backward(upsample):
    """Kernel 2's plain version (analytic cotangents through the flux
    combine and the smoothstep weights) == jax.grad of base_tpu's fused
    table in interpret mode, on a functional with separate scales for the
    node masses, the base lookup axis and min_mass (as
    tests/test_pallas_marglik.py:183-234): scaled atol 2e-4."""
    iso, base, q, coefs = _iso_problem(upsample)
    rng = np.random.default_rng(8)
    n_lo = (iso.mass.shape[0] - 1) * q.shape[0]
    w_lo = rng.normal(0, 1, (n_lo, coefs.shape[0])).astype(np.float32)

    def f_jax(mod, av, mags, sec_mags, s_mass, s_axis, s_mm):
        iso2 = dataclasses.replace(iso, mags=mags, mass=s_mass * iso.mass)
        base2 = dataclasses.replace(
            base, mags=sec_mags, mass_sorted=s_axis * base.mass_sorted,
            min_mass=s_mm * base.min_mass)
        t = jlk.build_segment_table_fused(iso2, q, mod, av, coefs,
                                          sec_iso=base2, interpret=True)
        return jnp.sum(t.lo * w_lo) + jnp.sum(jnp.cos(t.hi))

    vals = (9.7, 0.23, iso.mags, base.mags, 1.03, 1.01, 0.98)
    want = jax.jit(jax.grad(f_jax, argnums=tuple(range(7))))(
        *[jnp.asarray(v) for v in vals])

    t_iso, t_base = _to_torch_iso(iso), _to_torch_iso(base)
    xs = [torch.tensor([vals[0]]), torch.tensor([vals[1]]),
          _t(iso.mags)[None], _t(base.mags)[None],
          torch.tensor(vals[4]), torch.tensor(vals[5]),
          torch.tensor(vals[6])]
    for x in xs:
        x.requires_grad_(True)
    mod, av, mags, sec_mags, s_mass, s_axis, s_mm = xs
    iso2 = dataclasses.replace(t_iso, mags=mags, mass=s_mass * t_iso.mass)
    base2 = dataclasses.replace(
        t_base, mags=sec_mags, mass_sorted=s_axis * t_base.mass_sorted,
        min_mass=s_mm * t_base.min_mass)
    t = tlk.build_segment_table_fused(iso2, _t(q), mod, av, _t(coefs),
                                      sec_iso=base2)
    out = (t.lo[0] * _t(w_lo)).sum() + torch.cos(t.hi[0]).sum()
    got = torch.autograd.grad(out, xs)
    for w, gt, name in zip(want, got, ["mod", "av", "mags", "sec_mags",
                                       "s_mass", "s_axis", "s_minmass"]):
        w = np.asarray(w)
        gt = gt.numpy().reshape(w.shape)
        scale = np.abs(w).max() + 1e-6
        np.testing.assert_allclose(gt / scale, w / scale, atol=2e-4,
                                   err_msg=name)


# --- Kernel 2's sparse window (ops.table.hat_zero_bounds / hat_window) ----


def _window_misses(x, q):
    """Entries outside the window of kernel 2's rule where the dense
    weight or a factor 6u(1-u) is not exactly 0.0, and the window widths,
    for sorted-or-not axes x [C, E2] and queries q [C, N] (float32)."""
    from base_tpu_torch.ops import table as ttb

    cols = ttb.base_axis_columns(torch.as_tensor(x, dtype=torch.float32))
    m2 = torch.as_tensor(q, dtype=torch.float32)[:, None, :]
    w, up, dn = ttb._weights(m2, *cols)                   # [C, E2, N]
    touched = ((w != 0.0) | (6.0 * up * (1.0 - up) != 0.0)
               | (6.0 * dn * (1.0 - dn) != 0.0))
    lo, hi = ttb.hat_window(m2, *ttb.hat_zero_bounds(*cols))
    e = torch.arange(x.shape[1])[None, :, None]
    inside = (e >= lo[:, None, :]) & (e <= hi[:, None, :])
    return int((touched & ~inside).sum()), (hi - lo + 1).clamp_min(0)


def _ulp_neighbours(v, k=2):
    """v with its float32 neighbours up to k ulps either side."""
    v = np.asarray(v, np.float32)
    out = [v]
    up, dn = v.copy(), v.copy()
    for _ in range(k):
        up = np.nextafter(up, np.float32(np.inf))
        dn = np.nextafter(dn, np.float32(-np.inf))
        out += [up, dn]
    return np.concatenate(out)


def test_table_window_config1_axis():
    """On the config-1 base axes (synthetic grid, 64 EEPs, pads above the
    valid masses) at 8 chain points, every node's non-zero hat weights and
    factors lie in its window, and the window is at most 3 entries of 64."""
    from base_tpu_torch.grids import synthetic as tsyn
    from base_tpu_torch.grids.isochrone import derive_isochrone as tderive

    grid = tsyn.make_grid(n_eep=64, device="cpu")
    rng = np.random.default_rng(11)
    pts = np.array([9.3, 0.27, -0.5]) + rng.normal(0, 0.05, (8, 3))
    pts[0] = (9.3, 0.27, -0.5)
    age, y, feh = (torch.as_tensor(pts[:, i], dtype=torch.float32)
                   for i in range(3))
    iso = tderive(grid, feh, y, age)
    q = (iso.mass[:, :, None] * torch.linspace(0.0, 1.0, 8)).reshape(8, -1)
    misses, width = _window_misses(iso.mass_sorted, q)
    assert misses == 0
    assert int(width.max()) <= 3


@pytest.mark.parametrize("case", ["ties", "near_ties", "pads", "unsorted"])
def test_table_window_adversarial_axes(case):
    """Axes with ties (inverse spacing 1e30), near-ties at float32
    resolution next to a wide gap, pad masses, and an unsorted axis; queries
    on every node and 1-2 ulps either side, below and above the axis, and
    between nodes.  Outside the window every weight and factor is exactly
    0.0; the sorted axes keep the window narrow."""
    f = np.float32
    one_up = np.nextafter(f(1.0), f(2.0))
    axes = {
        "ties": [0.1, 0.3, 0.3, 0.5, 0.5, 0.5, 0.9, 1.2],
        "near_ties": [0.2, 1.0, one_up, np.nextafter(one_up, f(2.0)),
                      1.0000004, 1000.0, 1.0e4, 1.0e4 + 1.0],
        "pads": [0.15, 0.4, 0.8, 1.6, 1.0e4, 1.0e4 + 1, 1.0e4 + 2,
                 1.0e4 + 3],
        "unsorted": [0.4, 0.1, 0.9, 0.3, 1.5, 0.3, 2.0, 0.7],
    }
    x = np.asarray(axes[case], np.float32)
    rng = np.random.default_rng(12)
    q = np.concatenate([
        _ulp_neighbours(x),
        [0.0, x.min() / 2, x.max() * 2, 1.0e5, 1.0e30],
        (x[1:] + x[:-1]) / 2,
        rng.uniform(0.0, 2.5, 64),
    ]).astype(np.float32)
    misses, width = _window_misses(x[None], q[None])
    assert misses == 0
    if case != "unsorted":
        assert int(width.max()) <= 5


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


@pytest.mark.parametrize("upsample", [1, 4])
def test_marglik_skip_config1(upsample):
    """On config-1 inputs at 4 chains the element rule marks no element
    whose weight is non-zero and marks >= 90% of the live elements (98%
    and 99% at 64 chains, upsample 1 and 4); the group rule marks no group
    holding a non-zero weight and marks >= 75% of the (group, star) pairs
    with a live segment (89% and 94% here)."""
    args = _config1_marglik_args(upsample)
    out = tml.marglik_fwd_plain(*args)
    misses, marked, live = _skip_misses(args, out)
    assert misses == 0
    assert marked >= 0.9 * live
    misses, marked, groups = _group_misses(args, out)
    assert misses == 0
    assert marked >= 0.75 * groups


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


@pytest.mark.parametrize("case", ["flat", "far_mu", "huge_gamma",
                                  "unobserved", "masked"])
def test_marglik_skip_adversarial_inputs(case):
    """Flat segments, mu far outside [0, 1], gamma ~ 1e7, unobserved
    bands, and a chain with every segment masked (out = NEG_INF): no marked
    element has a non-zero weight, and masked segments are never marked."""
    args = _adversarial_args(case)
    out = tml.marglik_fwd_plain(*args)
    if case == "masked":
        assert bool((out[1] == NEG_INF + args[2]).all())
    misses, marked, live = _skip_misses(args, out)
    assert misses == 0
    skip = tml.marglik_bwd_skip(*args, out)
    assert not bool((skip & ~(args[6] > 0.5)[:, None, :]).any())
    if case in ("far_mu", "huge_gamma"):
        assert marked > 0
    misses, marked, groups = _group_misses(args, out)
    assert misses == 0
    assert marked <= groups


@pytest.mark.parametrize("case", ["plain", "flat", "far_mu", "huge_gamma",
                                  "unobserved"])
def test_marglik_skip_rules_at_29_bands(case):
    """The adversarial inputs at B = 29, every filter of grids/filters.py
    (the kernels take up to 32 bands): neither rule marks an element or a
    group holding a non-zero weight, and both still mark."""
    args = _adversarial_args(case, B=29)
    out = tml.marglik_fwd_plain(*args)
    misses, marked, live = _skip_misses(args, out)
    assert misses == 0
    assert 0 < marked <= live
    misses, marked, groups = _group_misses(args, out)
    assert misses == 0
    assert marked <= groups


def test_marglik_skip_outputs_near_threshold():
    """With out' set so that the elements' log weights lie around the
    rules' threshold, and out' = NEG_INF for one star, neither rule marks
    an element or a group with a non-zero weight (nor any of that star's);
    with g = 0 every weight is zero and the rules do not depend on g."""
    args = _adversarial_args("plain")
    obs, iv, ln, lo, hi, logw, mask = args
    alpha, beta, gamma, _, _, _ = tml._abg(obs, iv, lo, hi)
    live = (mask > 0.5)[:, None, :]
    core, width, _ = tml._core_width(alpha, beta, gamma, logw[:, None, :],
                                     live)
    peak = (core + torch.log(width)).amax(-1)                # [C, S]
    rng = np.random.default_rng(14)
    total = total_groups = 0
    for shift in (60.0, 90.0, 100.0, 104.0, 110.0, 125.0):
        jitter = _t(rng.uniform(-8.0, 8.0, peak.shape).astype(np.float32))
        out = peak + shift + jitter + ln
        out[0, 3] = NEG_INF + ln[3]
        misses, marked, _ = _skip_misses(args, out)
        assert misses == 0
        assert not bool(tml.marglik_bwd_skip(*args, out)[0, 3].any())
        total += marked
        g0 = torch.zeros_like(out)
        assert _skip_misses(args, out, g0)[:2] == (0, marked)
        misses, marked, _ = _group_misses(args, out)
        assert misses == 0
        assert not bool(tml.marglik_bwd_group_skip(*args, out)[0, 3].any())
        total_groups += marked
    assert total > 0 and total_groups > 0


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
