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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _marglik_inputs(dev, C=3, S=37, T=133, B=8, seed=0):
    rng = np.random.default_rng(seed)
    lo = rng.normal(12.0, 3.0, (C, T, B)).astype(np.float32)
    hi = lo + rng.normal(0.0, 0.3, (C, T, B)).astype(np.float32)
    obs = lo[0, rng.integers(0, T, S)] + rng.normal(0, 0.05, (S, B))
    sig = np.abs(rng.normal(0.05, 0.02, (S, B))) + 0.01
    iv = np.where(rng.random((S, B)) < 0.1, 0.0, 1.0 / sig**2)
    ln = (-np.log(sig) - 0.9189385332046727).sum(-1)
    logw = rng.normal(-2.0, 1.0, (C, T))
    mask = (rng.random((C, T)) > 0.15).astype(np.float32)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                 for a in (obs, iv, ln, lo, hi, logw, mask))


def _table_inputs(dev, C=3, B=6, E=17, Q=5, E2=24, seed=1, ties=False):
    """Random node-table inputs; with `ties`, the base axis repeats masses
    (a pair and a triple) and some nodes sit exactly on axis masses."""
    rng = np.random.default_rng(seed)
    N = E * Q
    x = np.sort(rng.uniform(0.15, 1.5, (C, E2)), axis=1).astype(np.float32)
    m2 = rng.uniform(0.0, 1.6, (C, 1, N)).astype(np.float32)
    if ties:
        x[:, 5] = x[:, 4]
        x[:, 11:14] = x[:, 10:11]
        m2[:, 0, : E2 // 2] = x[:, ::2]
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
    g = torch.randn(args[0].shape, device=cuda)
    for got, want in zip(tb.table_bwd_cuda(*args, g),
                         tb.table_bwd_plain(*args, g)):
        scale = want.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(got / scale, want / scale, rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("T", [133, 1500])
def test_marglik_kernels_match_plain(cuda, T):
    """T = 1500 spans several of the forward kernel's staged tiles."""
    args = _marglik_inputs(cuda, T=T)
    want = ml.marglik_fwd_plain(*args)
    got = ml.marglik_fwd_cuda(*args)
    sel = want > -200
    torch.testing.assert_close(got[sel], want[sel], rtol=0, atol=1e-4)
    g = torch.randn(want.shape, device=cuda)
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

    targs = _table_inputs(cuda, ties=True)
    before = tb.table_bwd_launches
    gt = torch.randn(targs[0].shape, device=cuda)
    first = tb.table_bwd_cuda(*targs, gt)
    second = tb.table_bwd_cuda(*targs, gt)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert tb.table_bwd_launches == before + 2


def test_wrappers_refuse_bad_inputs(cuda):
    args = list(_marglik_inputs(cuda))
    args[3] = args[3].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ml.marglik_fwd_cuda(*args)
    args = list(_marglik_inputs(cuda))
    args[5] = args[5].double()
    with pytest.raises(ValueError, match="float32"):
        ml.marglik_fwd_cuda(*args)
