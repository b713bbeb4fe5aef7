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
