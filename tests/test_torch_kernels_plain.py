"""The plain PyTorch versions of the four kernels (base_tpu_torch.ops.table
and .marglik, what a CPU tensor runs) against base_tpu's jnp path and its
Pallas kernels in interpret mode, forward and backward, on identical
float32 inputs made with numpy."""
import dataclasses

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


def _pallas(stars, table, log_norm=None, lo=None, hi=None, logw=None):
    return jfused(
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
    for want in (np.asarray(jlk.ms_star_log_marginals(stars, table)),
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

    want = jax.grad(f, argnums=(0, 1, 2, 3))(
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


def _iso_problem(upsample, E=24, B=6):
    """base_tpu (iso, base iso, q, coefs) as tests/test_pallas_marglik.py
    builds them."""
    grid = jsyn.make_grid(n_eep=E, bands=["U", "B", "V", "R", "I", "J"][:B])
    base = jderive(grid, jnp.asarray(-0.5), jnp.asarray(0.27),
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
    want = jlk.build_segment_table_fused(
        iso, q, jnp.asarray(mod), jnp.asarray(av), coefs, sec_iso=base,
        interpret=True)
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
    want = jax.grad(f_jax, argnums=tuple(range(7)))(
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
