"""The four CUDA kernels against their plain versions, on the card.  A
CUDA kernel has no interpret mode, so these tests are marked `gpu` and
skip without a CUDA device; run them on the card with
`python -m pytest tests/test_torch_cuda.py -q -m gpu --noconftest`."""
import numpy as np
import pytest
import torch

from base_tpu_torch.ops import marglik as ml
from base_tpu_torch.ops import table as tb

pytestmark = pytest.mark.gpu


def _randn(shape, dev, seed=0):
    """Cotangents from a seeded generator, so that a test does not depend
    on the tests run before it."""
    return torch.randn(shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _marglik_inputs(dev, C=3, S=37, T=133, B=8, seed=0, wide=False,
                    near=False):
    """Random marginal inputs: stars near segments, so that kernel 4's skip
    rule marks almost every element; with `wide`, sigmas of 20-40 mag, so
    that every weight is non-zero and the rule marks none.  Each chain has
    its own random table; with `near`, chain 0's table moved by 0.02 mag
    (chains near one another, as on the main path) with no segment flatter
    than 0.1 mag in any band, which keeps the float32 floor low."""
    rng = np.random.default_rng(seed)
    lo = rng.normal(12.0, 3.0, (C, T, B)).astype(np.float32)
    hi = lo + rng.normal(0.0, 0.3, (C, T, B)).astype(np.float32)
    if near:
        d = hi[:1] - lo[:1]
        d = np.where(d < 0, -0.1, 0.1) + d
        lo = lo[:1] + rng.normal(0.0, 0.02, (C, T, B)).astype(np.float32)
        hi = lo + d + rng.normal(0.0, 0.02, (C, T, B)).astype(np.float32)
    obs = lo[0, rng.integers(0, T, S)] + rng.normal(0, 0.05, (S, B))
    sig = np.abs(rng.normal(0.05, 0.02, (S, B))) + 0.01
    if wide:
        sig = rng.uniform(20.0, 40.0, (S, B))
    iv = np.where(rng.random((S, B)) < 0.1, 0.0, 1.0 / sig**2)
    ln = (-np.log(sig) - 0.9189385332046727).sum(-1)
    logw = rng.normal(-2.0, 1.0, (C, T))
    mask = (rng.random((C, T)) > 0.15).astype(np.float32)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in (obs, iv, ln, lo, hi, logw, mask))


def _table_inputs(dev, C=3, B=6, E=17, Q=5, E2=24, seed=1, ties=False,
                  pads=False, nan=False):
    """Random node-table inputs; with `ties`, the base axis repeats masses
    (a pair and a triple) and some nodes sit exactly on axis masses; with
    `pads`, the axis ends in pad masses 1e4 + k; with `nan`, a few node
    queries are NaN."""
    rng = np.random.default_rng(seed)
    N = E * Q
    x = np.sort(rng.uniform(0.15, 1.5, (C, E2)), axis=1).astype(np.float32)
    m2 = rng.uniform(0.0, 1.6, (C, 1, N)).astype(np.float32)
    if ties:
        x[:, 5] = x[:, 4]
        x[:, 11:14] = x[:, 10:11]
        m2[:, 0, : E2 // 2] = x[:, ::2]
    if pads:
        x[:, -4:] = 1.0e4 + np.arange(4, dtype=np.float32)
        m2[:, 0, -3:] = (1.0e4, 2.0e4, 1.0e5)
    if nan:
        m2[:, 0, 1::17] = np.nan
    cols = tb.base_axis_columns(torch.as_tensor(x))
    arrays = (
        rng.normal(15, 2, (C, B, N)),                       # app1N
        m2,
        rng.uniform(0.0, 1.0, (C, 1, N)),                   # litN
        rng.normal(16, 2, (C, B, E2)),                      # secT
        *(c.numpy() for c in cols),                         # xl .. inv_dr
    )
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in arrays)


@pytest.mark.parametrize("ties", [False, True])
def test_table_kernels_match_plain(cuda, ties):
    args = _table_inputs(cuda, ties=ties)
    torch.testing.assert_close(tb.table_fwd_cuda(*args),
                               tb.table_fwd_plain(*args), rtol=0, atol=1e-4)
    g = _randn(args[0].shape, cuda)
    for got, want in zip(tb.table_bwd_cuda(*args, g),
                         tb.table_bwd_plain(*args, g)):
        scale = want.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(got / scale, want / scale, rtol=0,
                                   atol=1e-3)


def _dense_table_fwd(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr):
    """Kernel 1's value at every node as a dense loop over the axis in
    order, with the kernel's clamp (a NaN ramp clamps to 0, so a NaN query
    weighs every entry -1)."""
    q = m2N
    up = torch.nan_to_num((q - xl) * inv_dl, nan=0.0).clamp(0.0, 1.0)
    dn = torch.nan_to_num((xr - q) * inv_dr, nan=0.0).clamp(0.0, 1.0)
    w = up * up * (3.0 - 2.0 * up) + dn * dn * (3.0 - 2.0 * dn) - 1.0
    mags2 = secT @ w
    f1 = torch.exp(-tb.LN10_04 * app1N)
    return -tb.INV_LN10_04 * torch.log(f1 + litN * torch.exp(-tb.LN10_04
                                                              * mags2))


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("case", ["ties", "pads", "nan"])
def test_table_fwd_sparse_window(cuda, case, B):
    """Kernel 1 over its sparse windows, on axes with ties or pad masses
    and with NaN queries, against the dense weights: atol 1e-4."""
    args = _table_inputs(cuda, B=B, **{case: True})
    got = tb.table_fwd_cuda(*args)
    torch.testing.assert_close(got, _dense_table_fwd(*args), rtol=0,
                               atol=1e-4)
    if case != "nan":
        torch.testing.assert_close(got, tb.table_fwd_plain(*args), rtol=0,
                                   atol=1e-4)


# The marginal's float32 floor (chip_smoke.py MARGLIK_TOL): gamma -
# beta^2/alpha and r - <t> d cancel, so any float32 evaluation of kernel
# 4's formula sits up to ~1e-3 (scaled) from float64, and two of them
# (kernel, plain) up to twice that from each other.
MARGLIK_TOL = 5e-3


def _check_marglik_bwd(args, g):
    """Kernel 4 against its plain version and against the plain version
    in float64, scaled by the float64 output's max: MARGLIK_TOL."""
    out = ml.marglik_fwd_plain(*args)
    args64 = tuple(t.double() for t in args)
    out64 = ml.marglik_fwd_plain(*args64)
    got = ml.marglik_bwd_cuda(*args, out, g)
    plain = ml.marglik_bwd_plain(*args, out, g)
    want = ml.marglik_bwd_plain(*args64, out64, g.double())
    for a, p, w in zip(got, plain, want):
        scale = float(w.abs().max()) + 1e-30
        assert float((a - p).abs().max()) / scale <= MARGLIK_TOL
        assert float((a.double() - w).abs().max()) / scale <= MARGLIK_TOL


@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("T", [133, 1500])
@pytest.mark.parametrize("S", [1, 37, 300])
def test_marglik_bwd_kernel_shapes(cuda, S, T, B):
    """Kernel 4 with fewer stars than warps, a ragged star slice and more
    than one staged star tile; T not a multiple of 32; 1, 8 and 16 bands."""
    args = _marglik_inputs(cuda, S=S, T=T, B=B, seed=S + T + B, near=True)
    _check_marglik_bwd(args, _randn((3, S), cuda))


@pytest.mark.parametrize("wide", [False, True])
def test_marglik_bwd_skip_extremes(cuda, wide):
    """Inputs on which the skip rule marks almost every element, and
    inputs on which it marks none: kernel 4 agrees either way."""
    args = _marglik_inputs(cuda, S=64, T=700, wide=wide, near=True)
    out = ml.marglik_fwd_plain(*args)
    live = int((args[6] > 0.5).sum()) * args[0].shape[0]
    marked = int(ml.marglik_bwd_skip(*args, out).sum())
    assert (marked == 0) if wide else (marked > 0.9 * live)
    _check_marglik_bwd(args, _randn(out.shape, cuda))


@pytest.mark.parametrize("T", [133, 1500])
def test_marglik_kernels_match_plain(cuda, T):
    """T = 1500 spans several of the forward kernel's staged tiles."""
    args = _marglik_inputs(cuda, T=T)
    want = ml.marglik_fwd_plain(*args)
    got = ml.marglik_fwd_cuda(*args)
    sel = want > -200
    torch.testing.assert_close(got[sel], want[sel], rtol=0, atol=1e-4)
    g = _randn(want.shape, cuda)
    for a, b in zip(ml.marglik_bwd_cuda(*args, want, g),
                    ml.marglik_bwd_plain(*args, want, g)):
        scale = b.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=1e-3)


def test_kernels_deterministic_and_counted(cuda):
    """Same inputs give bit-identical outputs (fixed-order sums, no
    atomics), and each wrapper counts one launch per call."""
    args = _marglik_inputs(cuda, T=1500)
    before = ml.marglik_fwd_launches, ml.marglik_bwd_launches
    out = ml.marglik_fwd_cuda(*args)
    assert torch.equal(out, ml.marglik_fwd_cuda(*args))
    g = torch.ones_like(out)
    first = ml.marglik_bwd_cuda(*args, out, g)
    second = ml.marglik_bwd_cuda(*args, out, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert (ml.marglik_fwd_launches, ml.marglik_bwd_launches) == (
        before[0] + 2, before[1] + 2)

    targs = _table_inputs(cuda, ties=True, pads=True)
    before = tb.table_fwd_launches, tb.table_bwd_launches
    assert torch.equal(tb.table_fwd_cuda(*targs), tb.table_fwd_cuda(*targs))
    gt = _randn(targs[0].shape, cuda)
    first = tb.table_bwd_cuda(*targs, gt)
    second = tb.table_bwd_cuda(*targs, gt)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert (tb.table_fwd_launches, tb.table_bwd_launches) == (
        before[0] + 2, before[1] + 2)


def test_wrappers_refuse_bad_inputs(cuda):
    args = list(_marglik_inputs(cuda))
    args[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ml.marglik_fwd_cuda(*args)
    args = list(_marglik_inputs(cuda))
    args[5] = args[5].double()
    with pytest.raises(ValueError, match="float32"):
        ml.marglik_fwd_cuda(*args)


def _wd_marglik_inputs(dev, mz, C=16, S=38, seed=0):
    """Kernels 3 and 4's inputs on the WD branch of config 3: the
    concatenated DA + DB segment table over the precursor nodes `mz` (T = 2
    (K - 1)) on the synthetic grids for C chains around the config-3
    truth, the last chain with an IFMR that leaves every node invalid.  Of
    the S WDs, observed with 0.01-0.05 mag errors, two thirds sit near
    chain 0's valid nodes and a third before its first valid segment (mu
    well below 0 on that steep segment)."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.grids.filters import absorption_coefs
    from base_tpu_torch.grids.wd_atmosphere import synthetic_bergeron
    from base_tpu_torch.grids.wd_cooling import synthetic_wd_cooling
    from base_tpu_torch.model import wd

    rng = np.random.default_rng(seed)
    grid = synthetic.make_grid(n_eep=64, device=dev)
    truth = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.7, 0.08, 0.0])
    p = np.tile(truth, (C, 1))
    p[1:, :8] += rng.normal(0, [0.02, 0.005, 0.02, 0.02, 0.01, 0.05, 0.01,
                                0.005], (C - 1, 8))
    p[-1, 6] = -3.0
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    mz = torch.as_tensor(mz, dtype=torch.float32, device=dev)
    mags, _, valid = wd.wd_model_mags(
        grid, synthetic_wd_cooling(device=dev), synthetic_bergeron(device=dev),
        p, mz, "linear")
    coefs = torch.as_tensor(absorption_coefs(grid.bands), device=dev)
    table = wd.wd_segment_table(mags, valid, mz, p[:, 3], p[:, 4], coefs)
    app = (mags[0] + p[0, 3] + p[0, 4] * coefs).cpu().numpy()  # [2, K, B]
    ok = np.flatnonzero(valid[0].cpu().numpy())
    n_edge = S // 3
    k = rng.choice(ok, S - n_edge)
    kind = (rng.random(S) < 0.1).astype(np.int64)
    first = app[kind[:n_edge], ok[0]]
    step = app[kind[:n_edge], ok[0] + 1] - first
    obs = np.concatenate([first - rng.uniform(0.5, 3.0, (n_edge, 1)) * step,
                          app[kind[n_edge:], k]])
    sig = rng.uniform(0.01, 0.05, (S, 8))
    obs = obs + rng.normal(0, sig)
    iv = 1.0 / sig**2
    ln = (-np.log(sig) - 0.9189385332046727).sum(-1)
    host = tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in (obs, iv, ln))
    return (*host, table.lo.contiguous(), table.hi.contiguous(),
            table.logw.contiguous(), table.mask.float())


def _config3_wd_inputs(dev):
    """chip_smoke.py's config-3 WD inputs (512 simulated stars, 40 WDs, 16
    chains, the last one with no valid node): on these, kernel 4 once
    computed <t> with an FMA-contracted exponent and sat 2e-2 (scaled)
    from float64.  Run from the repository root, which holds
    chip_smoke.py."""
    import chip_smoke

    model = chip_smoke.make_model3(chip_smoke.make_data3(), dev)
    return chip_smoke.wd_marglik_inputs(model,
                                        chip_smoke.config3_points(model))


WD_TABLES = {
    "config3": _config3_wd_inputs,
    "synthetic_K96": lambda dev: _wd_marglik_inputs(
        dev, np.linspace(0.8, 8.0, 96)),
    # One DA and one DB segment (T = 2) between 2.9 and 3.1 Msun.
    "synthetic_K2": lambda dev: _wd_marglik_inputs(dev, [2.9, 3.1]),
}


@pytest.mark.parametrize("case", list(WD_TABLES))
def test_marglik_kernels_on_wd_tables(cuda, case):
    """Kernels 3 and 4 on config 3's WD tables (C 16, S ~40, T 190, B 8;
    and T = 2), stars before the first valid segment among them: the
    forward within MARGLIK_TOL of plain and of float64 where plain is
    above -200, the backward within MARGLIK_TOL of plain and of float64;
    on the chain with no valid node the forward is exactly NEG_INF +
    log_norm and every gradient exactly zero."""
    args = WD_TABLES[case](cuda)
    want = ml.marglik_fwd_plain(*args)
    want64 = ml.marglik_fwd_plain(*(t.double() for t in args))
    got = ml.marglik_fwd_cuda(*args)
    sel = want > -200
    assert int(sel.sum()) > 0
    assert float((got - want).abs()[sel].max()) <= MARGLIK_TOL
    assert float((got.double() - want64).abs()[sel].max()) <= MARGLIK_TOL
    assert bool((args[6][-1] == 0).all())
    assert torch.equal(got[-1], ml.NEG_INF + args[2])
    g = _randn(want.shape, cuda, seed=args[3].shape[1])
    _check_marglik_bwd(args, g)
    for d in ml.marglik_bwd_cuda(*args, want, g):
        assert bool((d[-1] == 0).all()) and bool(torch.isfinite(d).all())


def test_config3_density_deterministic(cuda):
    """chip_smoke.py's config-3 log_post + gradient (the WD branch
    included) on the card, twice: bit-identical (no atomic scatter in the
    WD chain's backward).  Run from the repository root."""
    import chip_smoke

    model = chip_smoke.make_model3(chip_smoke.make_data3(), cuda)
    z = chip_smoke.config3_points(model)
    vg = chip_smoke.density_fn(model)
    (lp1, g1), (lp2, g2) = vg(z), vg(z)
    assert bool(torch.isfinite(lp1).all() and torch.isfinite(g1).all())
    assert torch.equal(lp1, lp2) and torch.equal(g1, g2)


def _config4(dev):
    """chip_smoke.py's config-4 model (400 stars, two populations,
    upsample 4) and its 32 chain points.  Run from the repository root."""
    import chip_smoke

    model = chip_smoke.make_model4(chip_smoke.make_data4(), dev)
    return model, chip_smoke.config4_points(model)


def test_config4_kernels_match_plain(cuda):
    """Kernels 1-4 at config 4's shapes (64 table chains, S = 400, T =
    2016, N = 2024) within chip_smoke.py's tolerances of their plain
    versions, and kernels 3-4 of float64 (check_kernels raises past
    them)."""
    import chip_smoke

    model, z = _config4(cuda)
    errs = chip_smoke.check_kernels(model, z, "config 4")
    assert set(errs) == set(chip_smoke.KERNELS)


def test_config4_fold_bit_identical(cuda):
    """Each kernel's launch on both populations folded on the chain axis
    equals its launches on each population alone, bit for bit
    (check_fold raises otherwise)."""
    import chip_smoke

    model, z = _config4(cuda)
    table_in, marg_in = chip_smoke.kernel_inputs(model, z)
    assert table_in[0].shape[0] == 2 * z.shape[0]
    chip_smoke.check_fold(table_in, marg_in, z.shape[0])


def test_config4_density_deterministic(cuda):
    """chip_smoke.py's config-4 log_post + gradient on the card, twice:
    bit-identical."""
    import chip_smoke

    model, z = _config4(cuda)
    vg = chip_smoke.density_fn(model)
    (lp1, g1), (lp2, g2) = vg(z), vg(z)
    assert bool(torch.isfinite(lp1).all() and torch.isfinite(g1).all())
    assert torch.equal(lp1, lp2) and torch.equal(g1, g2)


@pytest.mark.parametrize("with_wd", [False, True])
def test_multipop_launch_counts(cuda, with_wd):
    """One value + gradient evaluation of a two-population model on the
    card (4 chains) launches each of kernels 1-4 once, not once per
    population; with WDs kernels 3 and 4 launch twice (MS and WD
    tables) and kernels 1 and 2 once."""
    import chip_smoke
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.grids.wd_atmosphere import synthetic_bergeron
    from base_tpu_torch.grids.wd_cooling import synthetic_wd_cooling
    from base_tpu_torch.model import multipop as mp
    from base_tpu_torch.model.stardata import make_ms_stars

    (ms, wd, _) = chip_smoke.make_data3()
    kw = {}
    if with_wd:
        kw = dict(wd_cooling=synthetic_wd_cooling(device=cuda),
                  wd_atm=synthetic_bergeron(device=cuda),
                  wd_stars=make_ms_stars(*wd, cm_prior=0.99, device=cuda))
    truth = np.concatenate([chip_smoke.TRUTH3, [0.26, 0.28, 0.6]])
    sigma = np.concatenate([chip_smoke.PRIOR_SIGMA3, [-1, -1, -1]])
    model = mp.make_multipop_model(
        synthetic.make_grid(n_eep=64, device=cuda),
        make_ms_stars(*ms, cm_prior=0.99, device=cuda), truth, sigma,
        n_q=8, upsample=4, device=cuda, **kw)
    x = torch.as_tensor(np.tile(truth, (4, 1)), dtype=torch.float32,
                        device=cuda).requires_grad_(True)
    chip_smoke.reset_launch_counts()
    mp.log_post(model, x).sum().backward()
    torch.cuda.synchronize()
    n = 2 if with_wd else 1
    assert chip_smoke.launch_counts() == {
        "table_fwd": 1, "table_bwd": 1, "marglik_fwd": n, "marglik_bwd": n}
    assert bool(torch.isfinite(x.grad).all())


def test_chain_axis_above_grid_limit_raises(cuda):
    """The kernels put the chain axis on gridDim.y (at most 65535): a
    launch of 65536 chains raises before any launch, in every wrapper."""
    from base_tpu_torch.ops import build

    C = build.MAX_CHAINS + 1
    args = _marglik_inputs(cuda, C=1, S=2, T=2, B=1)
    big = args[:3] + tuple(t.expand(C, *t.shape[1:]).contiguous()
                           for t in args[3:])
    before = ml.marglik_fwd_launches, ml.marglik_bwd_launches
    with pytest.raises(ValueError, match="65535"):
        ml.marglik_fwd_cuda(*big)
    out = torch.zeros(C, 2, device=cuda)
    with pytest.raises(ValueError, match="65535"):
        ml.marglik_bwd_cuda(*big, out, out)
    assert (ml.marglik_fwd_launches, ml.marglik_bwd_launches) == before
    targs = _table_inputs(cuda, C=1, B=1, E=2, Q=2, E2=2)
    tbig = tuple(t.expand(C, *t.shape[1:]).contiguous() for t in targs)
    with pytest.raises(ValueError, match="65535"):
        tb.table_fwd_cuda(*tbig)
    with pytest.raises(ValueError, match="65535"):
        tb.table_bwd_cuda(*tbig, tbig[0])
    ok = args[:3] + tuple(t.expand(build.MAX_CHAINS, *t.shape[1:])
                          .contiguous() for t in args[3:])
    assert torch.equal(ml.marglik_fwd_cuda(*ok)[-1],
                       ml.marglik_fwd_cuda(*args)[0])


def test_kernels_1_and_3_at_10k_stars(cuda):
    """chip_smoke.py's config-5 photometry (10 000 stars, upsample 4) on 64
    chains: kernels 1 and 3 on every row against their plain versions on
    4 rows, first and last among them, within FWD_TOL and MARGLIK_TOL."""
    import chip_smoke
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars

    model = post.make_single_pop_model(
        synthetic.make_grid(n_eep=64, device=cuda),
        make_ms_stars(*chip_smoke.make_data5(), cm_prior=0.99, device=cuda),
        chip_smoke.TRUTH, chip_smoke.PRIOR_SIGMA, n_q=8, upsample=4,
        device=cuda)
    z = chip_smoke.chain_points(model, 0.02, seed=3)
    assert z.shape[0] == 64
    table_in, marg_in = chip_smoke.kernel_inputs(model, z)
    assert marg_in[0].shape[0] == 10_000 and marg_in[3].shape[1] == 2016
    rows = torch.tensor([0, 21, 42, 63], device=cuda)
    errs = chip_smoke.check_rows(table_in, marg_in, rows, "10k stars")
    assert errs["table_fwd"] <= chip_smoke.FWD_TOL
    assert errs["marglik_fwd"] <= chip_smoke.MARGLIK_TOL


def test_nuts_launches_equal_density_calls(cuda):
    """A short chunked NUTS run of config 1 on the card (8 chains, 40
    stars): every leaf one density call on all chains, each of kernels
    1-4 launched once per call, finite draws."""
    import chip_smoke
    from base_tpu_torch.inference.nuts import (NUTSConfig,
                                               make_nuts_chunked_runner)

    mags, sig = chip_smoke.make_data()
    model = chip_smoke.make_model((mags[:40], sig[:40]), cuda)
    rows = []
    f0 = chip_smoke.logpost_z_fn(model)

    def fz(z):
        rows.append(z.shape[0])
        return f0(z)

    cfg = NUTSConfig(n_warmup=8, n_samples=8, max_depth=4, n_windows=2,
                     dense_mass=True, free_mask=chip_smoke.FREE)
    init = chip_smoke.chain_points(model, 0.02, seed=2, n_chains=8)
    chip_smoke.reset_launch_counts()
    zs, info = make_nuts_chunked_runner(fz, cfg, chunk_draws=8)(
        init, torch.Generator(device=cuda).manual_seed(4))
    counts = chip_smoke.launch_counts()
    assert set(rows) == {8} and len(rows) > 16
    assert counts == dict.fromkeys(chip_smoke.KERNELS, len(rows))
    assert zs.shape == (8, 8, 9) and bool(torch.isfinite(zs).all())
    assert 0.0 < float(info["accept_prob"]) <= 1.0


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_chain_chunk_launches_per_block(cuda, sampler):
    """chain_chunk 4 on 8 chains (config 1, 40 stars): every density call
    holds one block of 4 rows, in evaluations of two calls, and each of
    kernels 1-4 launches once per call: twice an evaluation."""
    import chip_smoke
    from base_tpu_torch.inference.driver import make_hmc_chunked_runner
    from base_tpu_torch.inference.hmc import HMCConfig
    from base_tpu_torch.inference.nuts import (NUTSConfig,
                                               make_nuts_chunked_runner)

    mags, sig = chip_smoke.make_data()
    model = chip_smoke.make_model((mags[:40], sig[:40]), cuda)
    fz, rows = chip_smoke.counted_rows(chip_smoke.logpost_z_fn(model))
    common = dict(n_warmup=8, n_samples=8, n_windows=2, dense_mass=True,
                  free_mask=chip_smoke.FREE, chain_chunk=4)
    if sampler == "hmc":
        runner = make_hmc_chunked_runner(
            fz, HMCConfig(l_max=6, jitter_mode="step", **common), 8)
    else:
        runner = make_nuts_chunked_runner(
            fz, NUTSConfig(max_depth=4, **common), chunk_draws=8)
    init = chip_smoke.chain_points(model, 0.02, seed=2, n_chains=8)
    chip_smoke.reset_launch_counts()
    zs, _ = runner(init, torch.Generator(device=cuda).manual_seed(4))
    counts = chip_smoke.launch_counts()
    evals = chip_smoke.block_evaluations(sampler, rows, 8, 4)
    assert set(rows) == {4} and len(rows) == 2 * evals
    if sampler == "hmc":
        assert evals == 1 + 16 * 6
    chip_smoke.check_one_launch_per_call(sampler, counts, evals, blocks=2)
    assert zs.shape == (8, 8, 9) and bool(torch.isfinite(zs).all())


def test_smc_folded_replicates_equal_single_runs(cuda):
    """Tempered SMC on the card, 3 replicates x 256 particles folded into
    one particle axis, equals each replicate run alone on its generator:
    betas, log-evidence and particles bit for bit.  The target evaluates
    each particle with elementwise operations alone, so its rows do not
    depend on the batch they come in."""
    import math

    from base_tpu_torch.inference import smc

    mean = torch.tensor([1.5, -0.5], device=cuda)
    inv_sd = torch.tensor([1.0 / 0.7, 1.0 / 0.9], device=cuda)

    def log_target(z):
        e = (z - mean) * inv_sd
        return -0.5 * (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1])

    def log_q0(z):
        return (-0.5 * (z[:, 0] * z[:, 0] + z[:, 1] * z[:, 1]) / 16.0
                - 2.0 * math.log(4.0) - math.log(2.0 * math.pi))

    def sample_q0(gen, n):
        return 4.0 * torch.randn((n, 2), generator=gen, device=cuda)

    cfg = smc.SMCConfig(n_particles=256, n_move=2, max_stages=16)
    z, info = smc.run_smc_replicated(
        log_target, sample_q0, log_q0,
        torch.Generator(device=cuda).manual_seed(11), cfg, n_rep=3)
    assert bool((info["betas"][:, -1] == 1.0).all())
    gens = smc.replicate_generators(
        torch.Generator(device=cuda).manual_seed(11), 3)
    for r, gen in enumerate(gens):
        zr, ir = smc.run_smc(log_target, sample_q0, log_q0, gen, cfg)
        assert torch.equal(ir["betas"], info["betas"][r])
        assert torch.equal(ir["log_evidence"], info["log_evidences"][r])
        assert torch.equal(zr, z[256 * r:256 * (r + 1)])


def test_cli_single_pop_launches_equal_density_calls(cuda, tmp_path):
    """The port's CLI (simulate -> scatter -> single-pop --metrics) on the
    card at a small depth: each kernel's launches over single-pop equal
    the density calls that the CLI counted, kernels 3-4 once per segment
    table (twice when the photometry holds WDs)."""
    import json

    from base_tpu_torch.io.phot import read_phot
    from base_tpu_torch.tools import main as cli

    cfg = tmp_path / "cli.yaml"
    cfg.write_text("simCluster:\n  nStars: 40\nmcmc:\n  chains: 8\n"
                   "  runIter: 64\n  warmup: 8\n  lMax: 4\n  upsample: 2\n")
    base = str(tmp_path / "run")
    args = ["--config", str(cfg), "--outputFileBase", base,
            "--device", "cuda"]
    cli.main(["simulate", *args])
    cli.main(["scatter", *args, "--photFile", base + ".sim.phot"])
    before = (tb.table_fwd_launches, tb.table_bwd_launches,
              ml.marglik_fwd_launches, ml.marglik_bwd_launches)
    cli.main(["single-pop", *args, "--photFile", base + ".phot",
              "--metrics", base + ".jsonl"])
    after = (tb.table_fwd_launches, tb.table_bwd_launches,
             ml.marglik_fwd_launches, ml.marglik_bwd_launches)
    with open(base + ".jsonl") as f:
        calls = json.loads(f.readlines()[-1])["density_calls"]
    tables = 2 if (read_phot(base + ".phot").stage == 3).any() else 1
    assert calls > 0
    assert tuple(a - b for a, b in zip(after, before)) == (
        calls, calls, tables * calls, tables * calls)


@pytest.mark.parametrize("B,E2", [(17, 24), (29, 80), (32, 300)])
def test_kernels_past_16_bands_match_plain(cuda, B, E2):
    """Kernels 1-4 in their wide band class (17..32 bands) against their
    plain versions, as at 1-16 bands: kernel 1 to 1e-4, kernel 2 to 1e-3
    scaled, kernels 3-4 to MARGLIK_TOL against plain and float64.  E2 =
    300 at 32 bands takes kernel 2's node pass past 48 KB of shared
    memory, and B = 29 and 32 take kernel 4's partials past it."""
    targs = _table_inputs(cuda, B=B, E2=E2)
    torch.testing.assert_close(tb.table_fwd_cuda(*targs),
                               tb.table_fwd_plain(*targs), rtol=0, atol=1e-4)
    g = _randn(targs[0].shape, cuda)
    for got, want in zip(tb.table_bwd_cuda(*targs, g),
                         tb.table_bwd_plain(*targs, g)):
        scale = want.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(got / scale, want / scale, rtol=0,
                                   atol=1e-3)
    args = _marglik_inputs(cuda, S=150, T=700, B=B, seed=B, near=True)
    _check_own_outputs(args, _randn((3, 150), cuda),
                       (ml.marglik_fwd_cuda, ml.marglik_bwd_cuda),
                       (ml.marglik_fwd_plain, ml.marglik_bwd_plain))


def _check_own_outputs(args, g, kernels, plains):
    """A forward kernel and its backward against their plain versions and
    the float64 residual form, each backward given its own forward's
    output, as autograd pairs them.  The softmax weights exp(core - out')
    are exponentially sensitive to chi2's rounding, and at 29 bands chi2's
    terms reach ~1e4, so a backward handed another forward's out' moves by
    the difference of two roundings, not by its own error.  Forward: abs
    error; backward: scaled by the float64 output's max; each within
    MARGLIK_TOL."""
    args64 = tuple(t.double() for t in args)
    ref = ml.marglik_fwd_plain(*args64)
    plain = plains[0](*args)
    got = kernels[0](*args)
    sel = ref > -200
    assert float((got - plain).abs()[sel].max()) <= MARGLIK_TOL
    assert float((got.double() - ref).abs()[sel].max()) <= MARGLIK_TOL
    for a, p, w in zip(kernels[1](*args, got, g), plains[1](*args, plain, g),
                       ml.marglik_bwd_plain(*args64, ref, g.double())):
        scale = float(w.abs().max()) + 1e-30
        assert float((a - p).abs().max()) / scale <= MARGLIK_TOL
        assert float((a.double() - w).abs().max()) / scale <= MARGLIK_TOL


def _mm_inputs(dev, B, S=150, T=700, seed=1, C=3):
    """Kernel 3m/4m inputs: _marglik_inputs centered per band, as
    fused_log_marginals(..., matmul=True) passes them."""
    args = _marglik_inputs(dev, C=C, S=S, T=T, B=B, seed=B + seed, near=True)
    obs, lo, hi = ml.center_bands(args[0], args[1], args[3], args[4])
    return (obs, args[1], args[2], lo, hi, args[5], args[6])


def _mm_far_inputs(dev, B, seed=1, C=3, S=150, T=700):
    """Centered kernel 3m/4m inputs on ordered tables (a magnitude ramp
    along the segments, as an isochrone's), with stars 64-127 (kernel
    4m's second star tile) near the first tenth of the segments: for most
    groups of 32 segments the rule marks that whole tile, so 4m's blocks
    skip it."""
    rng = np.random.default_rng(B + seed)
    ramp = 12.0 + 6.0 * np.arange(T)[:, None] / T + np.linspace(0, 1, B)
    lo = ramp[None] + rng.normal(0, 0.02, (C, T, B))
    hi = lo + 6.0 / T + rng.normal(0, 0.005, (C, T, B))
    pick = rng.integers(0, T, S)
    pick[64:128] = rng.integers(0, T // 10, 64)
    obs = lo[0, pick] + rng.normal(0, 0.05, (S, B))
    sig = np.abs(rng.normal(0.05, 0.02, (S, B))) + 0.01
    iv = np.where(rng.random((S, B)) < 0.1, 0.0, 1.0 / sig**2)
    ln = (-np.log(sig) - 0.9189385332046727).sum(-1)
    logw = rng.normal(-2.0, 1.0, (C, T))
    mask = (rng.random((C, T)) > 0.15).astype(np.float32)
    args = [torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in (obs, iv, ln, lo, hi, logw, mask)]
    obs, lo, hi = ml.center_bands(args[0], args[1], args[3], args[4])
    return (obs, args[1], args[2], lo, hi, args[5], args[6])


def _mm_case(dev, B, case, seed):
    """The inputs of test_mm_kernels_match_plain's cases: `base` (C 3, S
    150, T 700; 16 and 64, the kernels' star tiles, do not divide S);
    `one_chunk` (S 37, T 100: kernel 3m's segments in one chunk of one
    partial tile, no merge launch); `many_chunks` (T 1500: 12 chunks, the
    last partial); `long_chunks` (C 64: chunks of 3 tiles, the last
    partial); `masked` (every chain's segments 32-63, a whole group of
    4m, masked, and chain 1 entirely); `far` (_mm_far_inputs)."""
    if case == "far":
        return _mm_far_inputs(dev, B, seed)
    shape = dict(base=(3, 150, 700), one_chunk=(3, 37, 100),
                 many_chunks=(3, 150, 1500), long_chunks=(64, 150, 700),
                 masked=(3, 150, 700))[case]
    C, S, T = shape
    args = list(_mm_inputs(dev, B, S=S, T=T, seed=seed, C=C))
    if case == "masked":
        args[6] = args[6].clone()
        args[6][:, 32:64] = 0.0
        args[6][1] = 0.0
    return tuple(args)


MM_CASES = [("base", 1), ("base", 2), ("base", 3), ("one_chunk", 1),
            ("many_chunks", 1), ("long_chunks", 1), ("masked", 1),
            ("far", 1)]


@pytest.mark.parametrize("case,seed", MM_CASES)
@pytest.mark.parametrize("B", [8, 29])
def test_mm_kernels_match_plain(cuda, B, case, seed):
    """Kernels 3m and 4m against their plain versions, which sum the
    expanded products in the kernels' order with their rounding: forward
    abs and backward scaled error within MARGLIK_TOL, each backward on its
    own forward's output, as kernels 3 and 4 are held to theirs.  Kernel 3
    on the same inputs (the residual form) is the control the forward gate
    must refuse: the expansion's float32 cancellation puts it 6e-3 to 5e-2
    (B = 8) and 4e-2 to 1.6e-1 (B = 29) from the plain version on these
    inputs.  Against the float64 residual form each kernel is held to twice
    the plain version's own distance from it, plus 1e-4 (forward) or
    MARGLIK_TOL (backward), as chip_smoke.py phase 13c holds them.  The
    cases cover the new designs' edges (_mm_case); in `far`, kernel 4m's
    rule marks whole star tiles, and in `masked` a whole group and a whole
    chain get exact zeros."""
    args = _mm_case(cuda, B, case, seed)
    C, S = args[3].shape[0], args[0].shape[0]
    g = _randn((C, S), cuda, seed)
    args64 = tuple(t.double() for t in args)
    ref = ml.marglik_fwd_plain(*args64)
    plain = ml.marglik_mm_fwd_plain(*args)
    got = ml.marglik_mm_fwd_cuda(*args)
    sel = ref > -200

    def dist(a, b):
        return float((a.double() - b.double()).abs()[sel].max())

    assert dist(got, plain) <= MARGLIK_TOL
    assert dist(ml.marglik_fwd_cuda(*args), plain) > MARGLIK_TOL
    assert dist(got, ref) <= 2.0 * dist(plain, ref) + 1e-4
    grads = ml.marglik_mm_bwd_cuda(*args, got, g)
    for a, p, w in zip(grads, ml.marglik_mm_bwd_plain(*args, plain, g),
                       ml.marglik_bwd_plain(*args64, ref, g.double())):
        scale = float(w.abs().max()) + 1e-30
        assert float((a - p).abs().max()) / scale <= MARGLIK_TOL
        budget = 2.0 * float((p.double() - w).abs().max()) / scale \
            + MARGLIK_TOL
        assert float((a.double() - w).abs().max()) / scale <= budget
    if case == "masked":
        assert bool((got[1] == ml.NEG_INF + args[2]).all())
        assert all(bool((x[1] == 0).all()) and bool((x[0, 32:64] == 0).all())
                   for x in grads)
    if case == "far":
        marked = ml.marglik_mm_bwd_group_skip(*args, got)
        assert int(marked[:, 64:128].all(1).sum()) > marked.shape[0]


def test_mm_kernels_deterministic_counted_and_autograd(cuda):
    """Kernels 3m and 4m rerun bit for bit, count one launch a call each,
    and carry fused_log_marginals(..., matmul=True) with its gradient:
    equal to calling them on the centered inputs."""
    args = _marglik_inputs(cuda, S=70, T=500, B=29, seed=3, near=True)
    obs, lo, hi = ml.center_bands(args[0], args[1], args[3], args[4])
    cargs = (obs, args[1], args[2], lo, hi, *args[5:])
    before = ml.marglik_mm_fwd_launches, ml.marglik_mm_bwd_launches
    out = ml.marglik_mm_fwd_cuda(*cargs)
    assert torch.equal(out, ml.marglik_mm_fwd_cuda(*cargs))
    g = _randn(out.shape, cuda)
    first = ml.marglik_mm_bwd_cuda(*cargs, out, g)
    second = ml.marglik_mm_bwd_cuda(*cargs, out, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert (ml.marglik_mm_fwd_launches, ml.marglik_mm_bwd_launches) == (
        before[0] + 2, before[1] + 2)
    leaves = [t.clone().requires_grad_(True) for t in args[3:6]]
    fused = ml.fused_log_marginals(*args[:3], *leaves, args[6], matmul=True)
    assert torch.equal(fused, out)
    grads = torch.autograd.grad(fused, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, first))
    assert (ml.marglik_mm_fwd_launches, ml.marglik_mm_bwd_launches) == (
        before[0] + 3, before[1] + 3)


def test_wrappers_refuse_33_bands_on_the_card(cuda):
    """33 bands: every wrapper raises, naming the limit, before any
    launch."""
    args = _marglik_inputs(cuda, S=5, T=40, B=33)
    out = torch.zeros((3, 5), device=cuda)
    before = _launches()
    for fn in (ml.marglik_fwd_cuda, ml.marglik_mm_fwd_cuda):
        with pytest.raises(ValueError, match="at most 32 bands, got 33"):
            fn(*args)
    for fn in (ml.marglik_bwd_cuda, ml.marglik_mm_bwd_cuda):
        with pytest.raises(ValueError, match="at most 32 bands, got 33"):
            fn(*args, out, out)
    targs = _table_inputs(cuda, B=33)
    with pytest.raises(ValueError, match="at most 32 bands, got 33"):
        tb.table_fwd_cuda(*targs)
    with pytest.raises(ValueError, match="at most 32 bands, got 33"):
        tb.table_bwd_cuda(*targs, targs[0])
    assert _launches() == before


def _launches():
    return (tb.table_fwd_launches, tb.table_bwd_launches,
            ml.marglik_fwd_launches, ml.marglik_bwd_launches,
            ml.marglik_mm_fwd_launches, ml.marglik_mm_bwd_launches)


def test_mesh_1x1_density_bit_identical(cuda):
    """chip_smoke.py phase 14a's density check: in a world of one (NCCL,
    by the backend rule) a 1 x 1 mesh's local_logpost_fn, value and
    gradient on config 1 at 16 chains, equals the unsharded card density
    bit for bit, each kernel launched once."""
    import chip_smoke
    from base_tpu_torch.inference.hmc import value_and_grad
    from base_tpu_torch.parallel import distributed
    from base_tpu_torch.parallel import run as prun
    from base_tpu_torch.parallel.mesh import make_mesh

    model = chip_smoke.make_model(chip_smoke.make_data(), cuda)
    z = chip_smoke.chain_points(model, 0.05, seed=1)[:16]
    with distributed.world_of_one("cuda"):
        mesh = make_mesh(1, 1)
        assert mesh.backend == "nccl"
        fz = prun._logpost_z(model, chip_smoke.transform(model), mesh)
        chip_smoke.reset_launch_counts()
        v, g = value_and_grad(fz)(z)
        assert chip_smoke.launch_counts() == dict.fromkeys(
            chip_smoke.KERNELS, 1)
    want_v, want_g = chip_smoke.density_fn(model)(z)
    assert torch.equal(v, want_v) and torch.equal(g, want_g)


def test_two_ranks_on_one_card_density(cuda):
    """chip_smoke.py phase 14b's density checks: two ranks spawned on the
    card (gloo: they share it), at meshes (1, 2) and (2, 1), the sharded
    value and gradient on config 1 with 100 stars and with 99 (padded to
    100) within tests/test_parallel.py's bounds of the unsharded card
    density (chip_smoke.sharded_density_errs raises past them)."""
    import chip_smoke

    ranks = chip_smoke.spawn_world(2, "density")
    for r in ranks:
        assert set(r["results"]) == {"1x2", "2x1"}
        for res in r["results"].values():
            assert "backend gloo" in res["mesh"]
            for key in ("config1", "config1_99"):
                assert res[key]["value_rel_err"] <= \
                    chip_smoke.SHARD_VALUE_RTOL
                assert res[key]["grad_err_over_bound"] <= 1.0


# ---- star sets (kernels 3-4 over G data sets; scripts/torch_sbc.py) -------

def _sbc(shape, dev, sigma_model=0.0):
    """chip_smoke's phase-16a inputs: kernels 3-4's on SBC_SHAPES16[shape]
    over base_tpu's SBC data sets (tests/data/sbc_stars.npz), with
    `sigma_model` added to the sigmas in quadrature."""
    import chip_smoke

    return chip_smoke.sbc_marglik_inputs(dev, shape, sigma_model)


SBC_SHAPES = ("G64", "G8 k8")


@pytest.mark.parametrize("shape", SBC_SHAPES)
def test_marglik_kernels_over_sets_match_plain(cuda, shape):
    """Kernels 3-4 over star sets at the SBC shapes against their plain
    versions: the forward where plain is above -200, the backward scaled
    by plain's largest magnitude, both within MARGLIK_TOL, on the SBC stars
    with chip_smoke's SIGMA_MODEL16 floor (at their own sigmas of 0.01 the
    float32 formula, plain or kernel, sits up to 1.7-4.5e-2 from float64);
    and on the SBC data as they are against one-set launches on a set's
    chains, bit for bit (the same per-chain work in the same order).  Run
    from the repository root."""
    import chip_smoke

    args = _sbc(shape, cuda, sigma_model=chip_smoke.SIGMA_MODEL16)
    want = ml.marglik_fwd_plain(*args)
    got = ml.marglik_fwd_cuda(*args)
    sel = want > -200
    assert float((got - want).abs()[sel].max()) <= MARGLIK_TOL
    g = _randn(want.shape, cuda)
    grads = ml.marglik_bwd_cuda(*args, want, g)
    for a, b in zip(grads, ml.marglik_bwd_plain(*args, want, g)):
        assert float((a - b).abs().max()) / (
            float(b.abs().max()) + 1e-30) <= MARGLIK_TOL
    args = _sbc(shape, cuda)
    got = ml.marglik_fwd_cuda(*args)
    grads = ml.marglik_bwd_cuda(*args, got, g)
    obs, iv, ln, *tab = args
    G = obs.shape[0]
    k = tab[0].shape[0] // G
    for s in (0, G - 1):
        rows = slice(s * k, (s + 1) * k)
        one = (obs[s], iv[s], ln[s], *(t[rows].contiguous() for t in tab))
        assert torch.equal(got[rows], ml.marglik_fwd_cuda(*one))
        for a, b in zip(grads, ml.marglik_bwd_cuda(*one, got[rows],
                                                   g[rows].contiguous())):
            assert torch.equal(a[rows], b)


def test_marglik_one_set_stacked_is_one_set_kernel(cuda):
    """G = 1 in the stacked form ([1, S, B]) gives the one-set kernel's
    outputs bit for bit (the set offset is 0)."""
    args = _marglik_inputs(cuda, T=700, near=True)
    stacked = (args[0][None], args[1][None], args[2][None], *args[3:])
    out = ml.marglik_fwd_cuda(*args)
    assert torch.equal(ml.marglik_fwd_cuda(*stacked), out)
    g = _randn(out.shape, cuda)
    for a, b in zip(ml.marglik_bwd_cuda(*stacked, out, g),
                    ml.marglik_bwd_cuda(*args, out, g)):
        assert torch.equal(a, b)


def test_stacked_density_card_vs_cpu(cuda):
    """The SBC HMC model over 64 sets (chip_smoke's SIGMA_MODEL16 floor, as
    test_marglik_kernels_over_sets_match_plain), one chain a set about a
    posterior sd from its truth: chip_smoke's check_density (log_post +
    gradient through the kernels on the card against the plain path on
    the CPU within DENSITY_REL_TOL and DENSITY_GRAD_TOL, two card calls
    bit for bit), kernels 3 and 4 launched once a call.  Run from the
    repository root."""
    import chip_smoke

    sbc = chip_smoke.torch_sbc()
    sm = chip_smoke.SIGMA_MODEL16
    model, truths = sbc.sbc_model("ms", 4, False, cuda, sigma_model=sm)
    model_cpu, _ = sbc.sbc_model("ms", 4, False, "cpu", sigma_model=sm)
    z = chip_smoke.transform(model).inverse(torch.as_tensor(
        sbc.near_truths(truths, 1, 1), device=cuda))
    before = ml.marglik_fwd_launches, ml.marglik_bwd_launches
    chip_smoke.check_density(model, model_cpu, z)
    assert (ml.marglik_fwd_launches, ml.marglik_bwd_launches) == (
        before[0] + 2, before[1] + 2)


# ---- base_tpu's last slow checks (scripts/torch_slow_checks.py) ----------

def _slow_checks():
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import torch_slow_checks

    return torch_slow_checks


@pytest.mark.parametrize("name", ["mp", "vi"])
def test_slow_check_models_card_vs_cpu(cuda, name):
    """The two-population model of case A and the VI model of case C on
    base_tpu's catalogs (tests/data/slow_checks_stars.npz): log_post and
    its z-space gradient through the kernels on the card against the
    plain path on the CPU with tests/test_torch_multipop.py
    _check_parity's tolerances (value to 1e-4 of each point's |log_post|,
    gradient to 1e-3 of its largest component over the points: at sigma
    0.01 on the small grid each float32 gradient sits up to ~6e-3 of its
    own point's largest component from float64, on the CPU too), two card
    calls bit for bit, kernels 3 and 4 launched once a call and kernels
    1-2 never (no binaries).  The points: the VI model's truth and two
    nearby points; for the two-population model three nearby points (its
    truth's age and Y_B sit on grid nodes, a kink where a last-bit
    difference picks the other side's gradient).  Run from the
    repository root."""
    import chip_smoke

    sc = _slow_checks()
    build = sc.mp_model if name == "mp" else sc.vi_model
    (model, truth), (model_cpu, _) = build(cuda), build("cpu")
    pts = sc.parity_points(truth, 4)[1:] if name == "mp" else \
        sc.parity_points(truth)
    z = chip_smoke.transform(model).inverse(torch.as_tensor(pts,
                                                            device=cuda))
    before = sc.launch_counts()
    lp, g = chip_smoke.density_fn(model)(z)
    after = sc.launch_counts()
    lp_c, g_c = chip_smoke.density_fn(model_cpu)(z.cpu())
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
    assert ((lp.cpu() - lp_c).abs()
            <= 1e-4 * lp_c.abs().clamp_min(1.0)).all(), (lp, lp_c)
    assert ((g.cpu() - g_c).abs() <= 1e-3 * g_c.abs().max()).all(), (g, g_c)
    lp2, g2 = chip_smoke.density_fn(model)(z)
    assert torch.equal(lp, lp2) and torch.equal(g, g2)
    assert {k: after[k] - before[k] for k in after} == dict(
        table_fwd=0, table_bwd=0, marglik_fwd=1, marglik_bwd=1)


@pytest.mark.parametrize("case", ["A", "C"])
def test_slow_check_case_short_on_the_card(cuda, monkeypatch, case):
    """Case A cut to 8 + 4 transitions at l_max 2 and case C to 12 VI
    steps, on the card: kernels 3 and 4 launched once an evaluation
    (sc.check_launches inside run_case), finite draws."""
    sc = _slow_checks()
    monkeypatch.setattr(sc, "HMC", dict(sc.HMC, n_warmup=8, n_samples=4,
                                        l_max=2))
    monkeypatch.setattr(sc, "VI", dict(sc.VI, n_steps=12))
    res = sc.run_case(case, cuda)
    assert res["evaluations"] == (1 + 12 * 2 if case == "A" else 12)
    assert res["launches"]["marglik_fwd"] == res["evaluations"]
    assert all(np.isfinite(p["mean"]) for p in res["posterior"].values())


ROWS_SUBSETS = ((0, 1), (0, 8), (8, 24), (24, 64), (63, 64), (0, 63))


def test_rows_equal_subsets_on_the_card(cuda):
    """chip_smoke.py's config-1 bench model at 64 chains on the card: the
    rows of derive_isochrone for subsets of the batch (1 to 63 rows)
    equal the batch's bit for bit (the blend is elementwise); log_post's
    value and gradient for the same subsets are held to the card-vs-CPU
    density tolerances (chip_smoke DENSITY_REL_TOL, DENSITY_GRAD_TOL) and
    their largest differences are printed and written to
    chiprun_out/rows_card.json.  The window blend is held against the
    einsum blend it replaced at the kernel gates' tolerances (FWD_TOL on
    the values, GRAD_TOL on the scaled gradients).  Run from the
    repository root."""
    import json
    import os

    import chip_smoke
    from base_tpu_torch.grids.isochrone import derive_isochrone

    model = chip_smoke.make_model(chip_smoke.make_data(), cuda)
    z = chip_smoke.chain_points(model, 0.05, seed=1)
    x = chip_smoke.transform(model).forward(z)
    grid = model.grid

    def iso(p):
        i = derive_isochrone(grid, p[:, 2], p[:, 1], p[:, 0])
        return [i.mass, i.mags, i.valid, i.agb_tip, i.in_bounds,
                i.mass_sorted, i.min_mass]

    vg = chip_smoke.density_fn(model)
    full_iso, (lp, g) = iso(x), vg(z)
    diffs = {"log_post": 0.0, "grad": 0.0}
    for lo, hi in ROWS_SUBSETS:
        for a, b in zip(full_iso, iso(x[lo:hi])):
            assert torch.equal(a[lo:hi], b), (lo, hi)
        lp_s, g_s = vg(z[lo:hi])
        diffs["log_post"] = max(diffs["log_post"], float(
            ((lp[lo:hi] - lp_s).abs() / lp_s.abs().clamp_min(1.0)).max()))
        diffs["grad"] = max(diffs["grad"], float(
            (g[lo:hi] - g_s).abs().max() / g_s.abs().max()))
    assert diffs["log_post"] <= chip_smoke.DENSITY_REL_TOL
    assert diffs["grad"] <= chip_smoke.DENSITY_GRAD_TOL

    q = x[:, :3].detach().clone().requires_grad_(True)
    q_old = q.detach().clone().requires_grad_(True)
    new = derive_isochrone(grid, q[:, 2], q[:, 1], q[:, 0])
    old = chip_smoke.isochrone_dense(grid, q_old[:, 2], q_old[:, 1],
                                     q_old[:, 0])
    valid = new.valid > 0.5
    errs = {}
    for name, a, b in zip(("mass", "mags", "agb_tip"),
                          (new.mass, new.mags, new.agb_tip), old):
        sel = valid if a.shape[:2] == valid.shape else slice(None)
        errs[name] = float((a[sel] - b[sel]).detach().abs().max())
        assert errs[name] <= chip_smoke.FWD_TOL, (name, errs[name])
        w = _randn(a.shape, cuda, seed=3)
        if a.shape[:2] == valid.shape:
            w = w * valid.reshape(valid.shape + (1,) * (a.ndim - 2))
        (ga,) = torch.autograd.grad((a * w).sum(), q, retain_graph=True)
        (gb,) = torch.autograd.grad((b * w).sum(), q_old, retain_graph=True)
        errs[f"d{name}"] = float((ga - gb).abs().max() / gb.abs().max())
        assert errs[f"d{name}"] <= chip_smoke.GRAD_TOL, (name, errs)
    res = dict(card=chip_smoke.nvidia_smi(), chains=int(z.shape[0]),
               subsets=ROWS_SUBSETS, isochrone_rows_bit_equal=True,
               log_post_max_rel_diff=diffs["log_post"],
               grad_max_scaled_diff=diffs["grad"],
               window_vs_einsum=errs)
    print("rows on the card:", json.dumps(res))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "rows_card.json"), "w") as f:
        json.dump(res, f)
