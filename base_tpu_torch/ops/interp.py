"""Regular-grid interpolation primitives (port of base_tpu.ops.interp).

Axes are small monotone tensors; the isochrone blend and the secondary-mass
lookup use the gather-free hat-weight form, whose weights are
differentiable in both the query and the axis.  The WD chain (cooling and
atmosphere tables, the precursor-lifetime inversion) uses the corner form:
`locate` + `multilinear` / `gather_corners` + `blend` / `interp1d`, plain
gathers whose lerp weights carry the gradient.  Every function broadcasts
over leading (chain) dimensions.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

_HUGE = 1.0e30  # virtual axis extension for boundary clamping


class AxisLoc(NamedTuple):
    """Location of queries on one monotone 1-D axis."""

    idx: torch.Tensor     # int64, lower corner index in [0, len(axis)-2]
    frac: torch.Tensor    # lerp weight, clamped to [0, 1]
    inside: torch.Tensor  # bool, True where the query lies in the hull


def locate(axis: torch.Tensor, x: torch.Tensor) -> AxisLoc:
    """Find the cell of each query on a monotone-increasing axis: a 1-D
    `axis` [A] with queries `x` of any shape, or a batched `axis` [..., A]
    (one axis per chain) with queries [..., K] broadcast over the same
    leading dimensions.  A batched axis's cell ends are picked by a
    one-hot sum rather than a gather, so that the lerp weight is
    differentiable in the axis with a deterministic backward (a gather's
    backward on CUDA is an atomic scatter-add)."""
    n = axis.shape[-1]
    if axis.ndim == 1:
        idx = torch.searchsorted(axis, x.contiguous(), right=True) - 1
        idx = idx.clamp(0, n - 2)
        lo, hi = axis[idx], axis[idx + 1]
        first, last = axis[0], axis[-1]
    else:
        x = x.expand(axis.shape[:-1] + x.shape[-1:])
        idx = torch.searchsorted(axis.contiguous(), x.contiguous(),
                                 right=True) - 1
        idx = idx.clamp(0, n - 2)
        pos = torch.arange(n, device=axis.device)
        rows = axis.unsqueeze(-2)                             # [..., 1, A]
        zero = torch.zeros((), dtype=axis.dtype, device=axis.device)
        lo = torch.where(pos == idx[..., None], rows, zero).sum(-1)
        hi = torch.where(pos == idx[..., None] + 1, rows, zero).sum(-1)
        first, last = axis[..., :1], axis[..., -1:]
    frac = ((x - lo) / (hi - lo)).clamp(0.0, 1.0)
    inside = (x >= first) & (x <= last)
    return AxisLoc(idx, frac, inside)


def gather_corners(axes: Sequence[torch.Tensor],
                   point: Sequence[torch.Tensor]):
    """(corner index tuples, corner weights, in_bounds) of the 2^k cell
    corners of each query on the tensor-product grid of k 1-D `axes`.  The
    k query tensors broadcast against each other; every index, weight and
    the flag have their broadcast shape."""
    point = torch.broadcast_tensors(*point)
    k = len(axes)
    locs = [locate(a, p) for a, p in zip(axes, point)]
    inside = locs[0].inside
    for loc in locs[1:]:
        inside = inside & loc.inside
    corners, weights = [], []
    for corner in range(1 << k):
        corners.append(tuple(locs[d].idx + ((corner >> d) & 1)
                             for d in range(k)))
        w = 1.0
        for d in range(k):
            t = locs[d].frac
            w = w * (t if (corner >> d) & 1 else 1.0 - t)
        weights.append(w)
    return corners, weights, inside


def blend(corners, weights, values: torch.Tensor) -> torch.Tensor:
    """Blend `values` [n_0, ..., n_{k-1}, *payload] over precomputed
    corners and weights: query shape + payload."""
    out = None
    for idx, w in zip(corners, weights):
        w = w.reshape(w.shape + (1,) * (values.ndim - len(idx)))
        term = values[idx] * w
        out = term if out is None else out + term
    return out


def multilinear(axes: Sequence[torch.Tensor], values: torch.Tensor,
                point: Sequence[torch.Tensor]):
    """Multilinear interpolation of `values` [n_0, ..., n_{k-1},
    *payload] at the queries `point` (k broadcastable tensors), clamped to
    the hull.  Returns (query shape + payload, in_bounds)."""
    corners, weights, inside = gather_corners(axes, point)
    return blend(corners, weights, values), inside


def interp1d(x_axis: torch.Tensor, y: torch.Tensor,
             xq: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation with boundary clamping: y [A,
    *payload] on the monotone `x_axis` ([A], or [..., A] per chain as in
    `locate`) at the queries xq -> xq's (broadcast) shape + payload."""
    loc = locate(x_axis, xq)
    lo = y[loc.idx]
    hi = y[loc.idx + 1]
    t = loc.frac.reshape(loc.frac.shape + (1,) * (y.ndim - 1))
    return lo + (hi - lo) * t


def hat_weight_matrix(x_axis: torch.Tensor, xq: torch.Tensor,
                      smooth: bool = False) -> torch.Tensor:
    """Dense piecewise-linear interpolation weights W [..., Q, E].

    x_axis [..., E] and xq [..., Q] broadcast over their leading
    dimensions; y(xq) == W @ y, boundary-clamped, via the identity

        w_e(x) = clip((x - x_{e-1}) / (x_e - x_{e-1}), 0, 1)
               + clip((x_{e+1} - x) / (x_{e+1} - x_e), 0, 1) - 1

    with the axis virtually extended by +-1e30.  `smooth=True` replaces
    the clip by the smoothstep S(t) = t^2 (3 - 2t): the weights still sum
    to one and hit the nodes exactly, but the interpolant is C^1 in the
    query and the axis (the HMC-critical secondary-mass lookup).
    """
    xl = torch.cat([x_axis[..., :1] - _HUGE, x_axis[..., :-1]], dim=-1)
    xr = torch.cat([x_axis[..., 1:], x_axis[..., -1:] + _HUGE], dim=-1)
    dl = (x_axis - xl).clamp_min(1e-30)
    dr = (xr - x_axis).clamp_min(1e-30)
    q = xq.unsqueeze(-1)                                   # [..., Q, 1]
    up = ((q - xl.unsqueeze(-2)) / dl.unsqueeze(-2)).clamp(0.0, 1.0)
    dn = ((xr.unsqueeze(-2) - q) / dr.unsqueeze(-2)).clamp(0.0, 1.0)
    if smooth:
        up = up * up * (3.0 - 2.0 * up)
        dn = dn * dn * (3.0 - 2.0 * dn)
    return up + dn - 1.0


def interp1d_dense(x_axis: torch.Tensor, y: torch.Tensor, xq: torch.Tensor,
                   smooth: bool = False) -> torch.Tensor:
    """Piecewise-linear lookup W @ y, W = hat_weight_matrix: x_axis [..., E]
    (increasing), y [..., E, P], xq [..., Q] -> [..., Q, P].

    A row of W is zero off the two nodes that bracket its query, and
    torch's clamp gives the node below them a derivative at an exact node
    hit, so the product is summed over the window of three nodes idx - 1,
    idx, idx + 1 (idx from `locate`) in that order, by elementwise
    operations: each row of the result depends on its own inputs alone,
    which a batched product's summation order does not promise.  (Only
    where four nodes tie at the query does W have a non-zero weight off
    the window; its weights do not sum to one there either.)"""
    w = hat_weight_matrix(x_axis, xq, smooth=smooth)          # [..., Q, E]
    lead = w.shape[:-2]
    E = x_axis.shape[-1]
    axis = x_axis.expand(lead + (E,)).contiguous()
    idx = torch.searchsorted(axis, xq.expand(w.shape[:-1]).contiguous(),
                             right=True) - 1
    e = (idx.clamp(0, E - 2)[..., None]
         + torch.arange(-1, 2, device=idx.device))            # [..., Q, 3]
    ec = e.clamp(0, E - 1)
    wk = torch.where(e >= 0, torch.gather(w, -1, ec), 0.0)
    yb = y.expand(lead + y.shape[-2:])
    yk = torch.gather(yb, -2, ec.flatten(-2)[..., None].expand(
        ec.shape[:-2] + (ec.shape[-2] * 3, yb.shape[-1])))
    t = wk[..., None] * yk.unflatten(-2, ec.shape[-2:])      # [..., Q, 3, P]
    return t[..., 0, :] + t[..., 1, :] + t[..., 2, :]
