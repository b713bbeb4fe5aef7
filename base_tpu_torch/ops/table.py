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
"""
from __future__ import annotations

import torch

from base_tpu_torch.ops import build

LN10_04 = 0.9210340371976184
INV_LN10_04 = 1.0857362047581294

# Kernel launches since the last reset; the wrappers add one per launch.
table_fwd_launches = 0
table_bwd_launches = 0


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
    scratch = torch.empty_like(app1N)                    # d mags2 per node
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
