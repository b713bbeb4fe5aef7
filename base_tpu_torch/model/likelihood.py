"""Marginalized per-star photometric likelihood (port of
base_tpu.model.likelihood), batched over chains.

1. Per chain, a combined-magnitude table over (EEP e, mass ratio q) nodes:
   primary mags from the interpolated isochrone, secondary mags by a
   smoothstep lookup of m2 = q m1 on the BASE isochrone, fluxes summed,
   distance modulus and extinction applied.  Adjacent EEP nodes bound
   T = (E-1) Q mass segments, along which magnitudes run linearly.
2. chi2 is quadratic along each segment, so the mass integral of
   exp(-chi2/2) is a closed-form Gaussian segment integral, summed over
   segments with IMF x dM x dm2 weights.
3. The field-star mixture: logaddexp of the cluster marginal against the
   uniform-CMD field density, weighted by the membership prior.

Tables are [C, T, B]; the photometry [S, B] is shared by the chains, or,
as star sets [G, S, B] (stardata.stack_ms_stars), chain c is scored on set
c // (C // G) and every function here returns its [C] or [C, S] as if each
chain had its own set's stars.  The
fused table build and marginal go through the CUDA kernels on a CUDA
tensor and through their plain versions on a CPU tensor (ops.table,
ops.marglik).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from base_tpu_torch.grids.isochrone import Isochrone
from base_tpu_torch.model import priors
from base_tpu_torch.model.stardata import MSStars
from base_tpu_torch.ops.marglik import (
    _ALPHA_EPS,
    _FLAT_EPS,
    _abg,
    chain_rows,
    fused_log_marginals,
    marglik_fwd_plain,
)
from base_tpu_torch.ops.special import NEG_INF, masked_logsumexp
from base_tpu_torch.ops.table import (
    LN10_04,
    base_axis_columns,
    fused_combined_node_mags,
)

LOG_2PI = 1.8378770664093453


class SegmentTable(NamedTuple):
    """Flattened (EEP-segment x q) model table, one per chain.  Within each
    segment the apparent combined magnitudes run linearly from lo to hi
    as primary mass runs across it."""

    lo: torch.Tensor    # [C, T, B] apparent combined mags, segment start
    hi: torch.Tensor    # [C, T, B] apparent combined mags, segment end
    logw: torch.Tensor  # [C, T] log prior-mass weights (IMF x dM x dm2)
    mask: torch.Tensor  # [C, T] bool


def companion_lit_weight(m2: torch.Tensor,
                         min_mass: torch.Tensor) -> torch.Tensor:
    """Dark-companion cutoff as a ramp over 5% of the lowest valid mass
    (broadcasting m2 against min_mass): a hard step would make the density
    discontinuous in the cluster parameters and cap the HMC step size."""
    w = 0.05 * min_mass + 1e-6
    return ((m2 - (min_mass - w)) / w).clamp(0.0, 1.0)


def _distance(modulus, absorption, abs_coefs):
    """[C, B] distance modulus + per-band extinction."""
    return modulus[:, None] + absorption[:, None] * abs_coefs


def combined_node_mags(
    iso: Isochrone,
    q_grid: torch.Tensor,
    modulus: torch.Tensor,
    absorption: torch.Tensor,
    abs_coefs: torch.Tensor,
    sec_iso: Isochrone | None = None,
) -> torch.Tensor:
    """Apparent combined (primary+secondary) magnitudes at every (EEP node,
    mass ratio) pair: [C, E, Q, B].  `sec_iso` is the isochrone the
    secondary lookup runs against: the un-upsampled base isochrone when
    `iso` is quadrature-upsampled, so the continuous model does not change
    with the quadrature resolution."""
    if sec_iso is None:
        sec_iso = iso
    C, E = iso.mass.shape
    Q = q_grid.shape[0]
    dist = _distance(modulus, absorption, abs_coefs)          # [C, B]
    app1 = iso.mags + dist[:, None, :]                        # [C, E, B]
    f1 = torch.exp(-LN10_04 * app1)
    m2 = iso.mass[:, :, None] * q_grid                        # [C, E, Q]
    mags2 = sec_iso.mags_at_mass(m2.reshape(C, E * Q))        # [C, E*Q, B]
    app2 = mags2.reshape(C, E, Q, -1) + dist[:, None, None, :]
    lit = companion_lit_weight(m2, sec_iso.min_mass[:, None, None])
    f2 = torch.exp(-LN10_04 * app2) * lit[..., None]
    return -(1.0 / LN10_04) * torch.log(f1[:, :, None, :] + f2)


def _mass_weights(iso: Isochrone):
    """(logw_m, mask, m_mid), each [C, E-1]: log IMF x dM weight, validity
    and midpoint mass of every EEP segment."""
    m1 = iso.mass
    dm = m1[:, 1:] - m1[:, :-1]
    m_mid = 0.5 * (m1[:, 1:] + m1[:, :-1])
    seg_valid = (iso.valid[:, 1:] > 0.5) & (iso.valid[:, :-1] > 0.5)
    logw_m = priors.log_imf(m_mid) + torch.log(dm.clamp_min(1e-30))
    return logw_m, seg_valid, m_mid


def _segment_weights(iso: Isochrone, q_grid: torch.Tensor, uniform_q: bool):
    """(logw [C, T], mask [C, T]) of the binaries segment table, shared by
    the plain and fused table builders."""
    logw_m, seg_valid, m_mid = _mass_weights(iso)
    C, E1 = m_mid.shape
    Q = q_grid.shape[0]
    log_dq = torch.log(torch.gradient(q_grid)[0])
    if uniform_q:
        logw_q = log_dq.expand(C, E1, Q)
    else:
        # uniform in m2: dm2 = m1 dq
        logw_q = torch.log(m_mid.clamp_min(1e-12))[:, :, None] + log_dq
    logw = logw_m[:, :, None] + logw_q                        # [C, E-1, Q]
    mask = seg_valid[:, :, None].expand(C, E1, Q)
    return logw.reshape(C, -1), mask.reshape(C, -1)


def build_segment_table(
    iso: Isochrone,
    q_grid: torch.Tensor,
    modulus: torch.Tensor,
    absorption: torch.Tensor,
    abs_coefs: torch.Tensor,
    binaries: bool = True,
    uniform_q: bool = False,
    sec_iso: Isochrone | None = None,
) -> SegmentTable:
    """Per-chain segment table in plain PyTorch.  q_grid [Q] mass ratios
    in [0, 1]; q = 0 is the no-companion node.  `uniform_q` switches the
    secondary prior from uniform in m2 (weight m1 dq) to uniform in q."""
    if binaries:
        comb = combined_node_mags(
            iso, q_grid, modulus, absorption, abs_coefs, sec_iso=sec_iso
        )                                                     # [C, E, Q, B]
        C, _, _, B = comb.shape
        logw, mask = _segment_weights(iso, q_grid, uniform_q)
        return SegmentTable(
            lo=comb[:, :-1].reshape(C, -1, B),
            hi=comb[:, 1:].reshape(C, -1, B),
            logw=logw,
            mask=mask,
        )
    logw_m, seg_valid, _ = _mass_weights(iso)
    app = iso.mags + _distance(modulus, absorption, abs_coefs)[:, None, :]
    return SegmentTable(lo=app[:, :-1], hi=app[:, 1:], logw=logw_m,
                        mask=seg_valid)


def fused_table_inputs(
    iso: Isochrone,
    q_grid: torch.Tensor,
    modulus: torch.Tensor,
    absorption: torch.Tensor,
    abs_coefs: torch.Tensor,
    sec_iso: Isochrone | None = None,
) -> tuple[torch.Tensor, ...]:
    """The eight node-layout inputs of ops.table.fused_combined_node_mags
    (node n = e * Q + k), all contiguous."""
    if sec_iso is None:
        sec_iso = iso
    C, E = iso.mass.shape
    Q = q_grid.shape[0]
    B = iso.mags.shape[-1]
    dist = _distance(modulus, absorption, abs_coefs)          # [C, B]
    app1T = (iso.mags + dist[:, None, :]).transpose(1, 2)     # [C, B, E]
    app1N = app1T[:, :, :, None].expand(C, B, E, Q).reshape(C, B, E * Q)
    m2 = iso.mass[:, :, None] * q_grid                        # [C, E, Q]
    m2N = m2.reshape(C, 1, E * Q)
    litN = companion_lit_weight(
        m2, sec_iso.min_mass[:, None, None]).reshape(C, 1, E * Q)
    xl, inv_dl, xr, inv_dr = base_axis_columns(sec_iso.mass_sorted)
    secT = (sec_iso.mags + dist[:, None, :]).transpose(1, 2)  # [C, B, E2]
    return (app1N, m2N.contiguous(), litN.contiguous(), secT.contiguous(),
            xl, inv_dl, xr, inv_dr)


def build_segment_table_fused(
    iso: Isochrone,
    q_grid: torch.Tensor,
    modulus: torch.Tensor,
    absorption: torch.Tensor,
    abs_coefs: torch.Tensor,
    uniform_q: bool = False,
    sec_iso: Isochrone | None = None,
) -> SegmentTable:
    """build_segment_table(binaries=True) with the combined-mags node
    construction in kernel 1 (ops.table).  Node layout n = e * Q + k, so the
    segment rows are the contiguous slices lo = comb[:T], hi = comb[Q:]."""
    comb = fused_combined_node_mags(*fused_table_inputs(
        iso, q_grid, modulus, absorption, abs_coefs, sec_iso))  # [C, B, E*Q]
    Q = q_grid.shape[0]
    T = (iso.mass.shape[1] - 1) * Q
    logw, mask = _segment_weights(iso, q_grid, uniform_q)
    return SegmentTable(
        lo=comb[:, :, :T].transpose(1, 2).contiguous(),
        hi=comb[:, :, Q:].transpose(1, 2).contiguous(),
        logw=logw,
        mask=mask,
    )


def _log_ndtr_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(Phi(b) - Phi(a)) for b >= a, stable in both tails: an interval
    in the right tail is reflected to the left one, where log_ndtr keeps
    its precision."""
    flip = (a + b) > 0
    aa = torch.where(flip, -b, a)
    bb = torch.where(flip, -a, b)
    la = torch.special.log_ndtr(aa)
    lb = torch.special.log_ndtr(bb)
    # la <= lb; the ratio is held away from 1 so that log1p stays finite
    # for infinitesimally thin intervals (their weight is negligible).
    d = torch.clamp(la - lb, max=-1e-7)
    return lb + torch.log1p(-torch.exp(d))


def segment_logintegrals(stars: MSStars, table: SegmentTable):
    """log of the exact per-segment Gaussian mass integral per chain and
    star, [C, S, T].  With chi2(t) = alpha t^2 - 2 beta t + gamma along
    the segment (mags lo + t (hi - lo), t in [0, 1]):

      integral_0^1 exp(-chi2(t)/2) dt
        = exp(-(gamma - beta^2/alpha)/2) sqrt(2 pi / alpha)
          * [Phi(sqrt(alpha)(1 - mu)) - Phi(-sqrt(alpha) mu)],  mu = beta/alpha,

    plus the star's log_norm.  Near-flat segments (alpha below the
    erf-cancellation guard) take the midpoint value."""
    alpha, beta, gamma, _, _, _ = _abg(stars.obs_mags, stars.inv_var,
                                      table.lo, table.hi)
    ac = alpha.clamp_min(_ALPHA_EPS)
    mu = beta / ac
    resid = (gamma - beta * beta / ac).clamp_min(0.0)
    sq = torch.sqrt(ac)
    log_phi = _log_ndtr_diff(-sq * mu, sq * (1.0 - mu))
    log_i = -0.5 * resid + 0.5 * (LOG_2PI - torch.log(ac)) + log_phi
    flat = -0.5 * (gamma - beta + 0.25 * alpha)
    out = torch.where(alpha > _FLAT_EPS, log_i, flat)
    log_norm = (chain_rows(stars.log_norm, out.shape[0]) if stars.stacked
                else stars.log_norm)
    return out + log_norm[..., None]


def ms_star_log_marginals(stars: MSStars, table: SegmentTable):
    """Per-star log marginal cluster likelihood of every chain [C, S]: the
    plain PyTorch path, and the plain version of kernel 3."""
    return marglik_fwd_plain(stars.obs_mags, stars.inv_var, stars.log_norm,
                             table.lo, table.hi, table.logw, table.mask)


def field_mixture_total(stars: MSStars, log_clust: torch.Tensor):
    """Field-star mixture + sum over stars, given per-star cluster
    marginals [C, S]: density_s = CMprior_s L_cluster_s + (1 - CMprior_s)
    L_field_s.  Returns [C]."""
    log_cm, log_1m_cm = stars.log_cm, stars.log_1m_cm
    field, star_mask = stars.field_logdens, stars.star_mask
    if stars.stacked:   # each chain's own set
        C = log_clust.shape[0]
        log_cm, log_1m_cm, field, star_mask = (
            chain_rows(x, C) for x in (log_cm, log_1m_cm, field, star_mask))
    a = log_cm + log_clust
    b = log_1m_cm + field
    m = torch.maximum(a, b)
    per_star = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    per_star = per_star.clamp_min(NEG_INF)
    return (per_star * star_mask).sum(-1)


def mass_prior_log_norm(table: SegmentTable) -> torch.Tensor:
    """log Z(theta) [C]: log of the total IMF x dM (x dm2) weight over the
    valid segments, the normaliser that makes the per-star mass prior a
    proper density (its hull moves with theta)."""
    return masked_logsumexp(table.logw, table.mask, axis=-1)


def ms_log_marginals(stars: MSStars, table: SegmentTable,
                     use_pallas: bool = True) -> torch.Tensor:
    """Per-star log marginal cluster likelihood [C, S]; `use_pallas`
    routes through kernels 3 and 4 (ops.marglik), whose plain versions
    run on CPU tensors."""
    if use_pallas:
        return fused_log_marginals(
            stars.obs_mags, stars.inv_var, stars.log_norm,
            table.lo.contiguous(), table.hi.contiguous(),
            table.logw.contiguous(), table.mask.float(),
        )
    return ms_star_log_marginals(stars, table)


def ms_total_loglik(stars: MSStars, table: SegmentTable,
                    use_pallas: bool = True) -> torch.Tensor:
    """Total MS-star log likelihood (marginal + field mixture) [C]."""
    log_clust = ms_log_marginals(stars, table, use_pallas)
    log_clust = log_clust - mass_prior_log_norm(table)[:, None]
    return field_mixture_total(stars, log_clust)
