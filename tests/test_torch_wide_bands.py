"""Wide band sets: the kernel wrappers take up to 32 bands (all 29 filters
of grids/filters.py), the port's density at B = 29 against base_tpu's, and
the matmul form of the marginal (`fused_log_marginals(..., matmul=True)`,
the plain versions of kernels 3m and 4m) against base_tpu's Pallas mm form
in interpret mode, forward and backward, at B = 8 and B = 29."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.grids import synthetic as jsyn
from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu.ops.pallas_marglik import fused_log_marginals as jfused
from base_tpu_torch import convert
from base_tpu_torch.grids.filters import FILTERS
from base_tpu_torch.model import posterior as tpost
from base_tpu_torch.ops import marglik as tml
from base_tpu_torch.ops.special import NEG_INF
from base_tpu_torch.ops import table as ttb

torch.set_num_threads(1)

ALL_BANDS = tuple(FILTERS)
TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.0, 0.0, 0.0], np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32)


def _marglik_args(B, C=2, S=6, T=5):
    rng = np.random.default_rng(B)
    arrays = (rng.normal(15, 1, (S, B)), np.ones((S, B)), np.zeros(S),
              rng.normal(15, 1, (C, T, B)), rng.normal(15, 1, (C, T, B)),
              np.zeros((C, T)), np.ones((C, T)))
    return tuple(torch.as_tensor(np.asarray(a, np.float32)) for a in arrays)


def test_filters_hold_29_bands():
    assert len(ALL_BANDS) == 29


@pytest.mark.parametrize("B", [29, 32])
def test_kernel_wrappers_take_up_to_32_bands(B):
    """The wrappers' shape checks pass B = 29 and 32 and refuse only what
    the card does: a CPU tensor (kernels 1-2 also fit their shared memory
    at the CLI's base axis of E2 = 80)."""
    args = _marglik_args(B)
    for fn in (tml.marglik_fwd_cuda, tml.marglik_mm_fwd_cuda):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(*args)
    app1 = torch.zeros((2, B, 7))
    secT = torch.zeros((2, B, 80))
    sizes, shapes = ttb._shapes(app1, secT)
    assert sizes == (2, B, 7, 80) and shapes[3] == (2, B, 80)
    assert ttb.smem_bytes(B, 80) <= ttb.MAX_SMEM_BYTES


def test_kernel_wrappers_refuse_33_bands():
    """Past the kernels' largest band class the wrappers raise, naming the
    limit, and count no launch."""
    args = _marglik_args(33)
    before = (tml.marglik_fwd_launches, tml.marglik_mm_fwd_launches,
              ttb.table_fwd_launches)
    for fn in (tml.marglik_fwd_cuda, tml.marglik_mm_fwd_cuda):
        with pytest.raises(ValueError, match="at most 32 bands, got 33"):
            fn(*args)
    with pytest.raises(ValueError, match="at most 32 bands, got 33"):
        ttb.table_fwd_cuda(torch.zeros((2, 33, 7)), *([None] * 2),
                           torch.zeros((2, 33, 80)), *([None] * 4))
    assert before == (tml.marglik_fwd_launches, tml.marglik_mm_fwd_launches,
                      ttb.table_fwd_launches)


def _fields(obj, static=("bands", "name")):
    return {f.name: (getattr(obj, f.name) if f.name in static
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def wide_grid():
    return jsyn.make_grid(feh_axis=np.linspace(-1.5, 0.3, 3),
                          y_axis=np.linspace(0.24, 0.31, 2),
                          age_axis=np.linspace(8.6, 10.1, 4),
                          n_eep=32, bands=ALL_BANDS)


def _double(obj):
    """obj with every floating tensor in it, through nested dataclass
    fields, in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _double(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _value_and_grad(model, pts):
    x = torch.from_numpy(pts).to(model.priors.mean.dtype).requires_grad_(True)
    v = tpost.log_post(model, x)
    (g,) = torch.autograd.grad(v.sum(), x)
    return v.detach().numpy(), g.numpy()


def test_log_post_at_29_bands_matches_jax(wide_grid):
    """log_post and its gradient on a 29-band grid (10 simulated stars,
    binaries, upsample 1, the plain path) against jax.value_and_grad of
    base_tpu.  In float32 the value to 3e-4 relative, as
    tests/test_torch_posterior.py holds it.  The gradient is a sum of 29
    bands' large per-star terms that cancel, so both are evaluated in
    float64 too (base_tpu under jax.enable_x64): there the port's value is
    held to base_tpu's to 1e-6 relative and its gradient to 1e-4 of the
    largest component (6e-8 and 8e-6 here), and the port's float32 gradient
    to base_tpu's float64 one to 2e-3 (1.7e-3 here; jitted base_tpu's own
    float32 gradient sits 2.2e-2 from it, in the absorption component)."""
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    tgrid = convert.grid_from_numpy(**_fields(wide_grid), device="cpu")
    gen = torch.Generator().manual_seed(0)
    cat = simulate_cluster(tgrid, torch.from_numpy(TRUTH), 10, gen,
                           percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    assert sc.mags.shape == (10, 29)
    stars = jmake_stars(sc.mags.numpy(), sc.sigmas.numpy(), cm_prior=0.99)
    jm = jpost.make_single_pop_model(wide_grid, stars, TRUTH, PRIOR_SIGMA,
                                     n_q=4, use_pallas=False)
    tm = convert.model_from_numpy(
        _fields(wide_grid), _fields(stars), TRUTH, PRIOR_SIGMA,
        np.asarray(jm.q_grid), np.asarray(jm.abs_coefs), use_pallas=False,
        device="cpu")
    rng = np.random.default_rng(10)
    pts = np.tile(TRUTH, (3, 1))
    pts[1:, :5] += rng.normal(0, [0.05, 0.01, 0.05, 0.05, 0.03], (2, 5))
    pts = pts.astype(np.float32)

    def jax_value_and_grad(model, p):
        return map(np.asarray, jax.jit(jax.vmap(jax.value_and_grad(
            lambda q: jpost.log_post(model, q))))(p))

    want_v, _ = jax_value_and_grad(jm, jnp.asarray(pts))
    with jax.enable_x64(True):
        jm64 = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jm)
        want64_v, want64_g = jax_value_and_grad(
            jm64, jnp.asarray(pts, jnp.float64))
    assert want64_g.dtype == np.float64
    got_v, got_g = _value_and_grad(tm, pts)
    got64_v, got64_g = _value_and_grad(_double(tm), pts)
    assert np.all(np.isfinite(got_v)) and np.all(np.isfinite(got_g))
    np.testing.assert_array_less(np.abs(got_v - want_v),
                                 3e-4 * np.maximum(np.abs(want_v), 1.0))
    np.testing.assert_array_less(np.abs(got64_v - want64_v),
                                 1e-6 * np.maximum(np.abs(want64_v), 1.0))
    scale = np.abs(want64_g).max()
    assert np.abs(got64_g - want64_g).max() / scale <= 1e-4
    assert np.abs(got_g - want64_g).max() / scale <= 2e-3


def _mm_problem(B, S=40, T=130, seed=3):
    """tests/test_pallas_marglik.py's `_random_problem` at B bands, from a
    seeded numpy generator: obs near random table rows, 10% of the
    (star, band) pairs unobserved, 15% of the segments masked."""
    rng = np.random.default_rng(seed)
    model_mags = rng.normal(12.0, 3.0, (T + 1, B)).astype(np.float32)
    lo = model_mags[:-1]
    hi = lo + rng.normal(0.0, 0.3, (T, B)).astype(np.float32)
    pick = rng.integers(0, T, S)
    obs = lo[pick] + rng.normal(0, 0.05, (S, B)).astype(np.float32)
    sig = np.abs(rng.normal(0.05, 0.02, (S, B))).astype(np.float32) + 0.01
    sig[rng.random((S, B)) < 0.1] = -9.0
    stars = jmake_stars(obs, sig)
    logw = rng.normal(-2.0, 1.0, T).astype(np.float32)
    mask = (rng.random(T) > 0.15).astype(np.float32)
    return (np.asarray(stars.obs_mags), np.asarray(stars.inv_var),
            np.asarray(stars.log_norm), lo, hi, logw, mask)


@functools.cache
def _jax_mm(matmul):
    """base_tpu's fused marginal (interpret mode) and its VJP, jitted."""
    def f(*args):
        out, vjp = jax.vjp(lambda *a: jfused(*a, True, matmul=matmul), *args)
        return out, vjp

    return jax.jit(lambda g, *args: (lambda o, v: (o, v(g)))(*f(*args)))


@pytest.mark.parametrize("B", [8, 29])
def test_matmul_form_matches_jax(B):
    """The port's `fused_log_marginals(..., matmul=True)` (kernels 3m and
    4m's plain versions, after the per-band centering) against base_tpu's
    mm form.  Forward: within twice base_tpu's own distance from the
    float64 residual form on these inputs, plus 1e-4 (the expansion's
    float32 cancellation grows with B: 8e-3 at B = 8 and 5e-2 at B = 29
    here, and the two float32 evaluations round apart).  Backward: d
    log_norm, d lo, d hi and d logw within 1e-4 of the largest component."""
    args = _mm_problem(B)
    g = np.random.default_rng(B + 1).normal(size=args[0].shape[0]).astype(
        np.float32)
    out_j, grads_j = _jax_mm(True)(jnp.asarray(g),
                                   *(jnp.asarray(a) for a in args))
    out_j = np.asarray(out_j)

    t = [torch.from_numpy(np.array(a)) for a in args]
    t[3:7] = [x[None] for x in t[3:7]]                 # chain axis of 1
    leaves = [t[i].requires_grad_(True) for i in (2, 3, 4, 5)]
    out_t = tml.fused_log_marginals(*t, matmul=True)
    grads_t = torch.autograd.grad(out_t, leaves, torch.from_numpy(g)[None])

    t64 = [x.detach().double() for x in t]
    ref64 = tml.marglik_fwd_plain(*t64)[0].numpy()
    sel = ref64 > -200
    budget = np.abs(out_j - ref64)[sel].max()
    err = np.abs(out_t.detach().numpy()[0] - out_j)[sel].max()
    assert err <= 2.0 * budget + 1e-4, (err, budget)
    for name, got, want in zip(("log_norm", "lo", "hi", "logw"), grads_t,
                               grads_j[2:6]):
        got = got.numpy()
        got = got if name == "log_norm" else got[0]
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("B", [8, 29])
def test_matmul_plain_versions_match_autograd(B):
    """Kernel 4m's plain version (the analytic cotangents through the five
    star-axis products) against autograd through kernel 3m's plain version
    on two chains: both differentiate the same function, but autograd goes
    through the erf polynomial while the analytic form uses exact Gaussian
    moments, so within 5e-3 of the largest component, as
    tests/test_torch_kernels_plain.py holds the residual form.  With
    matmul=False fused_log_marginals is the residual form."""
    args = _mm_problem(B, S=20, T=70, seed=5)
    rng = np.random.default_rng(6)
    t = [torch.from_numpy(np.array(a)) for a in args]
    lo = torch.stack([t[3], t[3] + torch.from_numpy(
        rng.normal(0, 0.02, args[3].shape).astype(np.float32))])
    hi = torch.stack([t[4], t[4] + 0.01])
    logw = torch.stack([t[5], t[5] - 0.3])
    mask = torch.stack([t[6], t[6]])
    obs, iv, ln = t[:3]
    leaves = [x.clone().requires_grad_(True) for x in (lo, hi, logw)]
    out = tml.marglik_mm_fwd_plain(obs, iv, ln, *leaves, mask)
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    want = torch.autograd.grad(out, leaves, g)
    got = tml.marglik_mm_bwd_plain(obs, iv, ln, lo, hi, logw, mask,
                                   out.detach(), g)
    for a, b in zip(got, want):
        scale = b.abs().max()
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=5e-3)
    torch.testing.assert_close(
        tml.fused_log_marginals(obs, iv, ln, lo, hi, logw, mask,
                                matmul=False),
        tml.marglik_fwd_plain(obs, iv, ln, lo, hi, logw, mask), rtol=0,
        atol=0)


@functools.cache
def _mm_cluster_args(B, chains=2, upsample=2):
    """Kernel 4m's inputs on a simulated cluster (synthetic grid of 48 EEPs
    in the first B filters of grids/filters.py, 100 stars with 30%
    binaries, n_q 8, sigmas from the port's noise model) at `chains`
    points scattered around the truth, centered per band as
    fused_log_marginals(..., matmul=True) passes them."""
    from base_tpu_torch.grids import synthetic as tsyn
    from base_tpu_torch.grids.isochrone import derive_isochrone
    from base_tpu_torch.grids.isochrone import upsample_isochrone
    from base_tpu_torch.model import likelihood as tlk
    from base_tpu_torch.model.stardata import make_ms_stars as tstars
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    grid = tsyn.make_grid(n_eep=48, bands=ALL_BANDS[:B], device="cpu")
    gen = torch.Generator().manual_seed(B)
    cat = simulate_cluster(grid, torch.as_tensor(TRUTH), 100, gen,
                           percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    stars = tstars(sc.mags.numpy(), sc.sigmas.numpy(), cm_prior=0.99,
                   device="cpu")
    model = tpost.make_single_pop_model(grid, stars, TRUTH, PRIOR_SIGMA,
                                        n_q=8, upsample=upsample,
                                        device="cpu")
    tr = tpost.default_transform(model)
    free = np.array([1, 1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    noise = np.random.default_rng(B).normal(0, 0.05, (chains, 9)) * free
    noise[0] = 0.0
    x = tr.forward(tr.inverse(torch.as_tensor(TRUTH))
                   + torch.from_numpy(noise.astype(np.float32)))
    base = derive_isochrone(grid, x[:, 2], x[:, 1], x[:, 0])
    table = tlk.build_segment_table_fused(
        upsample_isochrone(base, upsample), model.q_grid, x[:, 3], x[:, 4],
        model.abs_coefs, sec_iso=base)
    obs, lo, hi = tml.center_bands(stars.obs_mags, stars.inv_var, table.lo,
                                   table.hi)
    return (obs, stars.inv_var, stars.log_norm, lo, hi, table.logw,
            table.mask.float())


def _mm_group_misses(args, out):
    """Kernel 4m's group rule against marglik_mm_bwd_plain's weights:
    (marked (chain, star, group)s holding an element with a non-zero
    weight, marked, those with a live segment)."""
    marked = tml.marglik_mm_bwd_group_skip(*args, out)
    gw = tml._cotangent_weights(*tml._abg_mm(args[0], args[1], args[3],
                                             args[4]),
                                args[2], args[5], args[6], out,
                                torch.ones_like(out))[0]
    C, S, T = gw.shape
    pad = marked.shape[2] * tml.SKIP_GROUP - T
    nonzero = torch.nn.functional.pad(gw != 0.0, (0, pad))
    nonzero = nonzero.reshape(C, S, -1, tml.SKIP_GROUP).any(-1)
    live = torch.nn.functional.pad(args[6] > 0.5, (0, pad))
    live = live.reshape(C, 1, -1, tml.SKIP_GROUP).any(-1).expand_as(marked)
    return (int((marked & nonzero).sum()), int(marked.sum()),
            int(live.sum()))


@pytest.mark.parametrize("B", [8, 29])
def test_mm_group_skip_marks_only_zero_weights(B):
    """Kernel 4m's group rule (`marglik_mm_bwd_group_skip`) on a simulated
    cluster in B bands: every (chain, star, group) it marks holds only exact
    0.0 softmax weights of marglik_mm_bwd_plain, at the forward's own output
    and at outputs set so that the log weights lie around the rule's
    threshold (-105, with a star at out' = NEG_INF), and it marks most
    pairs (89% at B = 8, 94% at B = 29 here, kernel 4's rule 89% and 94% on
    the residual form) -- its slack covers the expansion's rounding
    without giving up the skip."""
    args = _mm_cluster_args(B)
    out = tml.marglik_mm_fwd_plain(*args)
    misses, marked, groups = _mm_group_misses(args, out)
    assert misses == 0
    assert marked >= 0.8 * groups
    alpha, beta, gamma = tml._abg_mm(args[0], args[1], args[3], args[4])
    live = (args[6] > 0.5)[:, None, :]
    core, width, _ = tml._core_width(alpha, beta, gamma,
                                     args[5][:, None, :], live)
    peak = (core + torch.log(width)).amax(-1)                 # [C, S]
    rng = np.random.default_rng(B)
    total = 0
    for shift in (90.0, 104.0, 110.0, 125.0):
        jitter = rng.uniform(-8.0, 8.0, peak.shape).astype(np.float32)
        out = peak + shift + torch.from_numpy(jitter) + args[2]
        out[0, 3] = NEG_INF + args[2][3]
        misses, marked, _ = _mm_group_misses(args, out)
        assert misses == 0
        total += marked
    assert total > 0
