"""Regular-grid interpolation primitives (port of base_tpu.ops.interp).

Axes are small monotone tensors; the isochrone blend and the secondary-mass
lookup use the gather-free hat-weight form, whose weights are
differentiable in both the query and the axis.  Every function broadcasts
over leading (chain) dimensions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_HUGE = 1.0e30  # virtual axis extension for boundary clamping


class AxisLoc(NamedTuple):
    """Location of queries on one monotone 1-D axis."""

    idx: torch.Tensor     # int64, lower corner index in [0, len(axis)-2]
    frac: torch.Tensor    # lerp weight, clamped to [0, 1]
    inside: torch.Tensor  # bool, True where the query lies in the hull


def locate(axis: torch.Tensor, x: torch.Tensor) -> AxisLoc:
    """Find the cell of each query `x` (any shape) on the 1-D `axis`."""
    n = axis.shape[0]
    idx = torch.searchsorted(axis, x.contiguous(), right=True) - 1
    idx = idx.clamp(0, n - 2)
    lo = axis[idx]
    hi = axis[idx + 1]
    frac = ((x - lo) / (hi - lo)).clamp(0.0, 1.0)
    inside = (x >= axis[0]) & (x <= axis[-1])
    return AxisLoc(idx, frac, inside)


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
    """Piecewise-linear lookup as W @ y: x_axis [..., E], y [..., E, P],
    xq [..., Q] -> [..., Q, P].  The product runs in full float32 (the
    package turns TF32 off at import)."""
    return hat_weight_matrix(x_axis, xq, smooth=smooth) @ y
