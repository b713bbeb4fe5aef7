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

Kernel 2 evaluates the weights sparsely: `hat_zero_bounds` and `hat_window`
below are the rule for which base-axis entries a node can touch, and
`csrc/table.cu` follows it operation for operation.
"""
from __future__ import annotations

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
    """Kernel 2's window rule, part 1: per axis entry e, bounds (lz, rz)
    [C, E2] such that for every float32 query q <= lz[e] or q >= rz[e] the
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
    """Kernel 2's window rule, part 2: the axis entries lo..hi ([C, N]
    each, inclusive, empty when lo > hi) that node queries m2N [C, 1, N] can
    touch, i.e. lz < q < rz, by binary search on the monotone bounds.  A
    NaN query takes the whole axis."""
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


def table_fwd_plain(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr):
    """Plain PyTorch version of kernel 1: [C, B, N]."""
    w, _, _ = _weights(m2N, xl, inv_dl, xr, inv_dr)
    mags2 = secT @ w                                     # [C, B, N]
    f1 = torch.exp(-LN10_04 * app1N)
    f2 = litN * torch.exp(-LN10_04 * mags2)
    return -INV_LN10_04 * torch.log(f1 + f2)


def table_bwd_plain(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr, g):
    """Plain PyTorch version of kernel 2: the analytic cotangents
    (dapp1, dm2, dlit, dsecT, dxl, dinv_dl, dxr, dinv_dr)."""
    w, up, dn = _weights(m2N, xl, inv_dl, xr, inv_dr)
    mags2 = secT @ w
    f1 = torch.exp(-LN10_04 * app1N)
    f2m = torch.exp(-LN10_04 * mags2)
    F = f1 + litN * f2m
    dapp1 = g * f1 / F
    dmags2 = g * litN * f2m / F                          # [C, B, N]
    dlit = (g * (-INV_LN10_04) * f2m / F).sum(1, keepdim=True)
    dW = secT.transpose(1, 2) @ dmags2                   # [C, E2, N]
    dup = dW * (6.0 * up * (1.0 - up))
    ddn = dW * (6.0 * dn * (1.0 - dn))
    dm2 = (dup * inv_dl - ddn * inv_dr).sum(1, keepdim=True)
    dsec = dmags2 @ w.transpose(1, 2)                    # [C, B, E2]
    dxl = (dup * (-inv_dl)).sum(2, keepdim=True)
    didl = (dup * (m2N - xl)).sum(2, keepdim=True)
    dxr = (ddn * inv_dr).sum(2, keepdim=True)
    didr = (ddn * (xr - m2N)).sum(2, keepdim=True)
    return dapp1, dm2, dlit, dsec, dxl, didl, dxr, didr


def _shapes(app1N, secT):
    C, B, N = app1N.shape
    E2 = secT.shape[2]
    if B > 16:
        raise ValueError(f"table kernels take at most 16 bands, got {B}")
    if (B + 4) * E2 * 4 > 48 * 1024:   # the staged axis + secondary table
        raise ValueError(f"table kernels stage (B + 4) * E2 floats in 48 KB "
                         f"of shared memory; got B={B}, E2={E2}")
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
