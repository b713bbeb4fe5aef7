"""Numerically-stable special ops used by the marginalized likelihood.

Port of base_tpu.ops.special.  float32 throughout, with max-shifted
logsumexp and explicit masking so padded EEP / quadrature slots contribute
exactly zero probability.  `phi_interval_scaled` is the formula that the
CUDA marginal kernels (csrc/marglik.cu `phi_interval_scaled`) copy line for
line; change both together.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # finite stand-in for -inf: keeps gradients NaN-free

_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def masked_logsumexp(x: torch.Tensor, mask: torch.Tensor,
                     axis: int = -1) -> torch.Tensor:
    """log(sum_i mask_i * exp(x_i)) along `axis`, safe for all-masked rows
    (which return NEG_INF, a large negative float32, not -inf)."""
    mask = mask.bool()
    neg = torch.full_like(x, NEG_INF)
    x = torch.where(mask, x, neg)
    m = torch.amax(x, dim=axis, keepdim=True).clamp_min(NEG_INF)
    s = torch.where(mask, torch.exp(x - m), torch.zeros_like(x)).sum(axis)
    out = m.squeeze(axis) + torch.log(s.clamp_min(1e-38))
    return torch.where(s > 0, out, torch.full_like(out, NEG_INF))


def _erf_poly_from_e(ax: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """erf(|x|) via Abramowitz-Stegun 7.1.26 given e = exp(-x^2)
    (|abs err| <= 1.5e-7)."""
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (
        0.254829592
        + t * (-0.284496736
               + t * (1.421413741
                      + t * (-1.453152027 + t * 1.061405429)))
    )
    return 1.0 - poly * e


def _mills_scaled(u_abs: torch.Tensor,
                  extra_log: torch.Tensor) -> torch.Tensor:
    # Q(|u|) * e^{u_near^2/2} with u_near <= u: phi(0)/u * series *
    # exp(-(u^2 - u_near^2)/2); the exponent is <= 0.
    u = u_abs.clamp_min(1.0)
    iu2 = 1.0 / (u * u)
    series = 1.0 - iu2 + 3.0 * iu2 * iu2
    return _INV_SQRT_2PI / u * series * torch.exp(
        torch.clamp(extra_log, max=0.0))


def phi_interval_scaled(u0: torch.Tensor, u1: torch.Tensor):
    """(D_scaled, u_near_sq) with D_scaled = (Phi(u1) - Phi(u0)) *
    exp(u_near^2 / 2), for u1 >= u0, elementwise, float32-robust.

    u_near^2 = min(u0^2, u1^2) when the interval is one-sided (0 when it
    straddles 0), so D_scaled is O(1) and the caller absorbs
    exp(-u_near^2/2) into its max-shifted exponent exactly.  Intervals
    touching the bulk use the erf difference (A-S polynomial); one-sided
    intervals beyond |u| > 3.5 use the Mills asymptotic
    Q(u) e^{u^2/2} = phi(0)/u (1 - 1/u^2 + 3/u^4).
    """
    x0 = u0 * _INV_SQRT2
    x1 = u1 * _INV_SQRT2
    e0 = torch.exp(-x0 * x0)   # = exp(-u0^2 / 2)
    e1 = torch.exp(-x1 * x1)
    erf0 = torch.sign(x0) * _erf_poly_from_e(torch.abs(x0), e0)
    erf1 = torch.sign(x1) * _erf_poly_from_e(torch.abs(x1), e1)
    d_erf = torch.clamp(0.5 * (erf1 - erf0), min=0.0)

    one_sided = (u0 * u1) > 0.0
    unear_sq = torch.where(
        one_sided, torch.minimum(u0 * u0, u1 * u1), torch.zeros_like(u0)
    )
    # erf branch scale factor; clamped so the unselected branch stays
    # finite (0 * inf = NaN hazard in the backward otherwise).
    erf_scale = torch.exp(0.5 * torch.clamp(unear_sq, max=13.0))

    right = u0 > 3.5    # Phi(u1)-Phi(u0) = Q(u0) - Q(u1)
    left = u1 < -3.5    # = Q(|u1|) - Q(|u0|) by symmetry
    au0 = torch.abs(u0)
    au1 = torch.abs(u1)
    u_near = torch.where(right, au0, au1)
    u_far = torch.where(right, au1, au0)
    m_near = _mills_scaled(u_near, torch.zeros_like(u_near))
    m_far = _mills_scaled(u_far, 0.5 * (unear_sq - u_far * u_far))
    d_asym = torch.clamp(m_near - m_far, min=0.0)
    d = torch.where(right | left, d_asym, d_erf * erf_scale)
    return d, unear_sq
