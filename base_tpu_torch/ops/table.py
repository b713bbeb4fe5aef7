"""Combined-magnitude node table: kernels 1 and 2 (csrc/table.cu).

Port of base_tpu/ops/pallas_table.py with a leading chain axis.  For every
chain and node n = (e, q):

    W[:, n] = smoothstep hat weights of m2[n] on the BASE mass axis
    mags2   = secT @ W
    comb    = -1/c * log(exp(-c app1) + lit exp(-c mags2)),  c = 0.4 ln 10

`fused_combined_node_mags` is a `torch.autograd.Function`: CUDA tensors go
through the kernels, CPU tensors through the plain versions beside them
(`table_fwd_plain`, and `table_bwd_plain`, the analytic backward).  The
backward carries the cotangent through the flux combine and through the
smoothstep weights into the node masses, the lit ramp, the secondary table
and the four base-axis vectors.

Kernels 1 and 2 evaluate the weights sparsely: `hat_zero_bounds` and
`hat_window` below are the rule for which base-axis entries a node can
touch, and `csrc/table.cu` follows it operation for operation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from base_tpu_torch.ops import build

LN10_04 = 0.9210340371976184
INV_LN10_04 = 1.0857362047581294

# Kernel launches since the last reset; the wrappers add one per launch.
table_fwd_launches = 0
table_bwd_launches = 0

# Pad beyond the ends of the base mass axis: flat extrapolation outside it.
AXIS_HUGE = 1.0e30
# Window bounds: at most this many doubling steps of the probe, the first
# 2^-23 of (|edge| + ramp width).
_PROBE_STEPS = 64
_PROBE_SCALE = 2.0 ** -23


def base_axis_columns(x):
    """The four base-axis columns [C, E2, 1] of a sorted mass axis x
    [C, E2]: left / right neighbours (padded by AXIS_HUGE at the ends) and
    the inverse spacings, 1e30 across a tie."""
    xl = torch.cat([x[:, :1] - AXIS_HUGE, x[:, :-1]], dim=1)[:, :, None]
    xr = torch.cat([x[:, 1:], x[:, -1:] + AXIS_HUGE], dim=1)[:, :, None]
    inv_dl = 1.0 / (x[:, :, None] - xl).clamp_min(1e-30)
    inv_dr = 1.0 / (xr - x[:, :, None]).clamp_min(1e-30)
    return xl, inv_dl, xr, inv_dr


def _probe(edge, ramp, inv, sign):
    """Step c from `edge` in direction `sign`, doubling the step, until
    ramp(c) >= 1; -+inf where that takes more than _PROBE_STEPS steps.  The
    float32 operations are those of csrc/table.cu `probe`."""
    c = edge.clone()
    d = (c.abs() + 1.0 / inv) * _PROBE_SCALE
    for _ in range(_PROBE_STEPS):
        need = ~(ramp(c) >= 1.0)
        if not need.any():
            break
        c = torch.where(need, c + sign * d, c)
        d = torch.where(need, d + d, d)
    return torch.where(ramp(c) >= 1.0, c, torch.full_like(c, sign * torch.inf))


def hat_zero_bounds(xl, inv_dl, xr, inv_dr):
    """The table kernels' window rule, part 1: per axis entry e, bounds
    (lz, rz) [C, E2] such that for every float32 query q <= lz[e] or q >= rz[e] the
    entry's weight and both factors 6u(1-u) are exactly 0.0.

    With up = clamp01((q - xl) idl) and dn = clamp01((xr - q) idr), idl and
    idr > 0: q <= xl gives up == 0, and dn is non-increasing in q, so once
    dn(c) >= 1 every q <= c has dn == 1; then w = S(0) + S(1) - 1 and both
    factors are exact zeros.  The probe finds such a c <= xl starting at xl,
    so lz = c is xl itself unless float rounding (at a tie, or next to a
    wide gap) needs a step; rz mirrors it from xr.  An entry with a
    non-positive or NaN inverse spacing is never skipped.  lz is then made
    non-decreasing (suffix minimum) and rz non-decreasing (prefix maximum):
    that only widens the windows, and makes each one a run of entries."""
    xl, idl, xr, idr = (t[..., 0] for t in (xl, inv_dl, xr, inv_dr))
    c_lo = _probe(xl, lambda c: (xr - c) * idr, idr, -1.0)
    c_hi = _probe(xr, lambda c: (c - xl) * idl, idl, 1.0)
    ok = (idl > 0) & (idr > 0)
    lz = torch.where(ok, c_lo, -torch.inf)
    rz = torch.where(ok, c_hi, torch.inf)
    lz = torch.flip(torch.cummin(torch.flip(lz, [1]), 1).values, [1])
    rz = torch.cummax(rz, 1).values
    return lz, rz


def hat_window(m2N, lz, rz):
    """The table kernels' window rule, part 2: the axis entries lo..hi
    ([C, N] each, inclusive, empty when lo > hi) that node queries m2N
    [C, 1, N] can touch, i.e. lz < q < rz, by binary search on the
    monotone bounds.  A NaN query takes the whole axis."""
    q = m2N[:, 0, :].contiguous()
    lo = torch.searchsorted(rz.contiguous(), q, right=True)
    hi = torch.searchsorted(lz.contiguous(), q, right=False) - 1
    nan = torch.isnan(q)
    lo = torch.where(nan, torch.zeros_like(lo), lo)
    hi = torch.where(nan, torch.full_like(hi, lz.shape[1] - 1), hi)
    return lo, hi


def _weights(m2, xl, inv_dl, xr, inv_dr):
    """Smoothstep hat weights W [C, E2, N] of queries m2 [C, 1, N] against
    the base-axis columns [C, E2, 1] (ops.interp.hat_weight_matrix math)."""
    up = ((m2 - xl) * inv_dl).clamp(0.0, 1.0)
    dn = ((xr - m2) * inv_dr).clamp(0.0, 1.0)
    up_s = up * up * (3.0 - 2.0 * up)
    dn_s = dn * dn * (3.0 - 2.0 * dn)
    return up_s + dn_s - 1.0, up, dn


class _Entry(NamedTuple):
    """One step of a walk along the nodes' windows: per node [C, N], the
    base-axis entry e (clamped into the axis), whether e lies in the
    node's window, the entry's columns and the node's weight and ramps."""

    e: torch.Tensor
    inside: torch.Tensor
    xl: torch.Tensor
    idl: torch.Tensor
    xr: torch.Tensor
    idr: torch.Tensor
    w: torch.Tensor
    up: torch.Tensor
    dn: torch.Tensor


def _window_walk(m2N, xl, inv_dl, xr, inv_dr):
    """The plain versions' sparse form: each node's window lo..hi of
    base-axis entries (the table kernels' rule, hat_zero_bounds and
    hat_window: it holds every non-zero weight and factor 6u(1-u)), walked
    entry by entry, one _Entry a step for all nodes at once.  Sums in
    that order are the products W @ ... with every row computed from its
    own inputs alone, which a batched product's summation order does not
    promise; an entry outside a node's window adds an exact zero."""
    lo, hi = hat_window(m2N, *hat_zero_bounds(xl, inv_dl, xr, inv_dr))
    width = (hi - lo + 1).clamp_min(0)                   # [C, N]
    E2 = xl.shape[1]
    m2 = m2N[:, 0]
    for k in range(int(width.max()) if width.numel() else 0):
        e = (lo + k).clamp(max=E2 - 1)
        cols = [c[:, :, 0].gather(1, e) for c in (xl, inv_dl, xr, inv_dr)]
        w, up, dn = _weights(m2, *cols)
        yield _Entry(e, k < width, *cols, torch.where(k < width, w, 0.0),
                     up, dn)


def table_fwd_plain(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr):
    """Plain PyTorch version of kernel 1: [C, B, N]."""
    C, B, N = app1N.shape
    mags2 = torch.zeros_like(app1N)
    for s in _window_walk(m2N, xl, inv_dl, xr, inv_dr):
        sec = secT.gather(2, s.e[:, None, :].expand(C, B, N))
        mags2 = mags2 + s.w[:, None, :] * sec
    f1 = torch.exp(-LN10_04 * app1N)
    f2 = litN * torch.exp(-LN10_04 * mags2)
    return -INV_LN10_04 * torch.log(f1 + f2)


def table_bwd_plain(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr, g):
    """Plain PyTorch version of kernel 2: the analytic cotangents
    (dapp1, dm2, dlit, dsecT, dxl, dinv_dl, dxr, dinv_dr)."""
    C, B, N = app1N.shape
    steps = list(_window_walk(m2N, xl, inv_dl, xr, inv_dr))
    secs = [secT.gather(2, s.e[:, None, :].expand(C, B, N)) for s in steps]
    mags2 = torch.zeros_like(app1N)
    for s, sec in zip(steps, secs):
        mags2 = mags2 + s.w[:, None, :] * sec
    f1 = torch.exp(-LN10_04 * app1N)
    f2m = torch.exp(-LN10_04 * mags2)
    F = f1 + litN * f2m
    dapp1 = g * f1 / F
    dmags2 = g * litN * f2m / F                          # [C, B, N]
    dlit = (g * (-INV_LN10_04) * f2m / F).sum(1, keepdim=True)
    m2 = m2N[:, 0]
    dm2 = torch.zeros_like(m2)
    dsec = torch.zeros_like(secT)
    daxis = [torch.zeros_like(xl[:, :, 0]) for _ in range(4)]
    for s, sec in zip(steps, secs):
        dW = (sec * dmags2).sum(1)                       # [C, N]
        dup = torch.where(s.inside, dW * (6.0 * s.up * (1.0 - s.up)), 0.0)
        ddn = torch.where(s.inside, dW * (6.0 * s.dn * (1.0 - s.dn)), 0.0)
        dm2 = dm2 + (dup * s.idl - ddn * s.idr)
        dsec.scatter_add_(2, s.e[:, None, :].expand(C, B, N),
                          dmags2 * s.w[:, None, :])
        for acc, term in zip(daxis, (dup * (-s.idl), dup * (m2 - s.xl),
                                     ddn * s.idr, ddn * (s.xr - m2))):
            acc.scatter_add_(1, s.e, term)
    dxl, didl, dxr, didr = (t[:, :, None] for t in daxis)
    return dapp1, dm2[:, None, :], dlit, dsec, dxl, didl, dxr, didr


# Shared memory a block may ask for on Hopper (227 KB); csrc/table.cu asks
# for more than 48 KB where a launch needs it.
MAX_SMEM_BYTES = 227 * 1024
_BWD_NODES = 128   # csrc/table.cu BWD_NODES


def smem_bytes(B: int, E2: int) -> int:
    """Shared memory of kernel 1 and of kernel 2's node pass, whichever is
    larger (csrc/table.cu `window_smem`, `bwd_node_smem`)."""
    groups = _BWD_NODES // E2 if E2 < _BWD_NODES else 1
    node = (B + 6) * E2 + (B + 2) * _BWD_NODES
    if groups > 1:
        node += groups * (B + 4) * E2
    return 4 * max((B + 6) * E2, node)


def _shapes(app1N, secT):
    C, B, N = app1N.shape
    E2 = secT.shape[2]
    build.check_bands("table", B)
    if smem_bytes(B, E2) > MAX_SMEM_BYTES:   # staged axis, table, windows
        raise ValueError(f"table kernels need {smem_bytes(B, E2)} bytes of "
                         f"shared memory at B={B}, E2={E2}; a block has "
                         f"{MAX_SMEM_BYTES}")
    build.check_chains(C)
    node = (C, 1, N)
    axis = (C, E2, 1)
    return (C, B, N, E2), [(C, B, N), node, node, (C, B, E2),
                           axis, axis, axis, axis]


_NAMES = ("app1N", "m2N", "litN", "secT", "xl", "inv_dl", "xr", "inv_dr")


def table_fwd_cuda(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr):
    """Kernel 1 on the card: [C, B, N]."""
    global table_fwd_launches
    args = (app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr)
    sizes, shapes = _shapes(app1N, secT)
    for name, t, shape in zip(_NAMES, args, shapes):
        build.check(name, t, shape)
    out = torch.empty_like(app1N)
    build.launch("btt_table_fwd", [*args, out], sizes)
    table_fwd_launches += 1
    return out


def table_bwd_cuda(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr, g):
    """Kernel 2 on the card: the same cotangents as table_bwd_plain."""
    global table_bwd_launches
    args = (app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr)
    sizes, shapes = _shapes(app1N, secT)
    for name, t, shape in zip(_NAMES, args, shapes):
        build.check(name, t, shape)
    build.check("g", g, shapes[0])
    outs = [torch.empty_like(t) for t in args]           # dapp1 .. dinv_dr
    scratch = torch.empty(build.table_bwd_scratch(*sizes),  # tile partials
                          dtype=torch.float32, device=app1N.device)
    build.launch("btt_table_bwd", [*args, g, *outs, scratch], sizes)
    table_bwd_launches += 1
    return tuple(outs)


class _FusedTable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        if args[0].is_cuda:
            return table_fwd_cuda(*args)
        return table_fwd_plain(*args)

    @staticmethod
    def backward(ctx, g):
        args = ctx.saved_tensors
        if g.is_cuda:
            return table_bwd_cuda(*args, g.contiguous())
        return table_bwd_plain(*args, g)


def fused_combined_node_mags(
    app1N: torch.Tensor,    # [C, B, N] apparent primary mags per node
    m2N: torch.Tensor,      # [C, 1, N] secondary masses per node
    litN: torch.Tensor,     # [C, 1, N] companion lit-ramp weight per node
    secT: torch.Tensor,     # [C, B, E2] apparent secondary mags, base axis
    xl: torch.Tensor,       # [C, E2, 1] base mass axis: left neighbours
    inv_dl: torch.Tensor,   # [C, E2, 1] 1 / (x - xl)
    xr: torch.Tensor,       # [C, E2, 1] right neighbours (extended)
    inv_dr: torch.Tensor,   # [C, E2, 1] 1 / (xr - x)
) -> torch.Tensor:
    """Combined apparent mags at every (EEP node, q) pair: [C, B, N].
    Differentiable with respect to every input."""
    return _FusedTable.apply(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr)
