"""Per-star conditional posteriors given cluster-parameter draws (port of
base_tpu.model.conditionals): the sampleMass and sampleWDMass steps.

The main sampler marginalises per-star masses out; these recover
p(mass | theta_d, data) for each posterior draw theta_d, sampled exactly
with no inner MCMC:

- MS stars: the marginal likelihood is a sum of closed-form segment
  integrals, so the conditional factorises as categorical(segment, q node)
  x truncated Gaussian (position within the segment).
- WD stars: categorical over (atmosphere type, precursor-mass node), then
  the deterministic chain gives the WD mass and cooling age.

The draws are the port's chain axis: a block of D draws is one batched
evaluation, [D, 9] -> fields [D, S], in sequential blocks of `draw_chunk`
draws (each block holds [D, S, T, B] intermediates).  Randomness comes
from an explicit `torch.Generator`, consumed block by block in order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from base_tpu_torch import constants as C
from base_tpu_torch.grids.isochrone import derive_isochrone
from base_tpu_torch.model import ifmr as ifmr_mod
from base_tpu_torch.model import likelihood as lk
from base_tpu_torch.model import priors
from base_tpu_torch.model import wd as wd_mod
from base_tpu_torch.model.posterior import SinglePopModel
from base_tpu_torch.ops.marglik import _ALPHA_EPS, _abg
from base_tpu_torch.ops.special import NEG_INF, masked_logsumexp


class MSMassSamples(NamedTuple):
    mass1: torch.Tensor       # [D, S] primary ZAMS mass draws
    mass_ratio: torch.Tensor  # [D, S]
    log_marg: torch.Tensor    # [D, S] per-star log marginal (diagnostic)
    p_member: torch.Tensor    # [D, S] P(cluster member | theta, data)


class WDMassSamples(NamedTuple):
    zams_mass: torch.Tensor     # [D, S]
    wd_mass: torch.Tensor       # [D, S] via the draw's IFMR
    log_cool_age: torch.Tensor  # [D, S]
    is_db: torch.Tensor         # [D, S] sampled atmosphere type
    log_marg: torch.Tensor      # [D, S]
    p_member: torch.Tensor      # [D, S] P(cluster member | theta, data)


def membership_posterior(stars, log_marg: torch.Tensor) -> torch.Tensor:
    """p(member | theta, data) per star from the mixture terms: the density
    is CMprior L_cluster + (1 - CMprior) L_field, so the membership
    posterior is one sigmoid of the log-odds."""
    log_odds = (stars.log_cm + log_marg) - (stars.log_1m_cm
                                            + stars.field_logdens)
    return torch.sigmoid(log_odds)


def categorical(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One draw per row of `logits` [..., N] by the Gumbel-max trick."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp(torch.finfo(u.dtype).tiny, 1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def truncated_normal(lo: torch.Tensor, hi: torch.Tensor,
                     gen: torch.Generator) -> torch.Tensor:
    """Standard normal draws truncated to [lo, hi] (elementwise), by the
    inverse CDF in float64, clamped into the interval."""
    lo64, hi64 = lo.double(), hi.double()
    p_lo, p_hi = torch.special.ndtr(lo64), torch.special.ndtr(hi64)
    u = torch.rand(lo.shape, generator=gen, device=lo.device,
                   dtype=torch.float64)
    z = torch.special.ndtri(p_lo + u * (p_hi - p_lo))
    return torch.minimum(torch.maximum(z, lo64), hi64).to(lo.dtype)


def _one_block_ms(model: SinglePopModel, params: torch.Tensor,
                  gen: torch.Generator) -> MSMassSamples:
    """MS conditionals of D draws at once.  The table is the plain one,
    built on the draw's isochrone without upsampling and with the
    secondary lookup on that same isochrone, as base_tpu's conditional
    builds it."""
    age = params[:, C.Param.AGE]
    y = params[:, C.Param.YYY]
    feh = params[:, C.Param.FEH]
    mod = params[:, C.Param.MOD]
    av = params[:, C.Param.ABS]
    iso = derive_isochrone(model.grid, feh, y, age)
    table = lk.build_segment_table(
        iso, model.q_grid, mod, av, model.abs_coefs,
        binaries=model.binaries, uniform_q=model.uniform_q,
    )
    stars = model.stars
    alpha, beta, _, _, _, _ = _abg(stars.obs_mags, stars.inv_var,
                                   table.lo, table.hi)        # [D, S, T]
    logi = lk.segment_logintegrals(stars, table)
    logits = torch.where(table.mask[:, None, :],
                         logi + table.logw[:, None, :],
                         torch.full_like(logi, NEG_INF))
    seg = categorical(logits, gen)                            # [D, S]
    a = alpha.gather(-1, seg[..., None])[..., 0].clamp_min(_ALPHA_EPS)
    mu = beta.gather(-1, seg[..., None])[..., 0] / a
    sd = 1.0 / torch.sqrt(a)
    t = mu + sd * truncated_normal((0.0 - mu) / sd, (1.0 - mu) / sd, gen)
    t = t.clamp(0.0, 1.0)

    # Map (segment, t) back to primary mass and mass ratio.
    if model.binaries:
        Q = model.q_grid.shape[0]
        e = seg // Q
        q = model.q_grid[seg % Q]
    else:
        e = seg
        q = torch.zeros_like(t)
    m_lo = iso.mass.gather(-1, e)
    m_hi = iso.mass.gather(-1, e + 1)
    m1 = m_lo + t * (m_hi - m_lo)
    log_marg = lk.ms_star_log_marginals(stars, table)
    return MSMassSamples(mass1=m1, mass_ratio=q, log_marg=log_marg,
                         p_member=membership_posterior(stars, log_marg))


def _one_block_wd(model: SinglePopModel, params: torch.Tensor,
                  gen: torch.Generator) -> WDMassSamples:
    """WD conditionals of D draws at once: categorical over the 2K (type,
    precursor node) pairs with the nodal weights IMF x dm x type weight."""
    stars = model.wd_stars
    mz = model.mz_grid
    mod = params[:, C.Param.MOD]
    av = params[:, C.Param.ABS]
    mags, _, valid = wd_mod.wd_model_mags(
        model.grid, model.wd_cooling, model.wd_atm, params, mz,
        model.ifmr_kind)                                      # [D, 2, K, B]
    dist = mod[:, None] + av[:, None] * model.abs_coefs       # [D, B]
    app = mags + dist[:, None, None, :]
    diff = stars.obs_mags[None, None, :, None, :] - app[:, :, None]
    chi2 = (diff * diff * stars.inv_var[:, None, :]).sum(-1)  # [D, 2, S, K]
    ll = -0.5 * chi2 + stars.log_norm[:, None]
    dm = torch.gradient(mz)[0]
    logw = priors.log_imf(mz) + torch.log(dm.clamp_min(1e-30))
    wa, wb = wd_mod._type_log_weights(model.p_db)
    type_w = torch.tensor([wa, wb], device=mz.device)[:, None, None]
    logits = torch.where(valid[:, None, None, :], ll + logw + type_w,
                         torch.full_like(ll, NEG_INF))
    D, _, S, K = logits.shape
    flat = logits.transpose(1, 2).reshape(D, S, 2 * K)        # [D, S, 2K]
    idx = categorical(flat, gen)
    is_db = idx >= K
    zams = mz[idx % K]
    m_wd = ifmr_mod.ifmr_mass(model.ifmr_kind, zams, params)
    prec = wd_mod.wd_prec_logage(model.grid, params[:, C.Param.FEH],
                                 params[:, C.Param.YYY], zams)
    log_cool = wd_mod.cooling_log_age(prec, params[:, C.Param.AGE, None])
    log_marg = masked_logsumexp(flat, flat > NEG_INF / 2, dim=-1)
    return WDMassSamples(
        zams_mass=zams, wd_mass=m_wd.expand_as(zams), log_cool_age=log_cool,
        is_db=is_db, log_marg=log_marg,
        p_member=membership_posterior(stars, log_marg))


def _blocks(f: Callable, params_draws: torch.Tensor, gen: torch.Generator,
            chunk: int | None):
    """f over the draw axis in sequential blocks of `chunk` draws (all at
    once for None), fields concatenated along the draw axis."""
    D = params_draws.shape[0]
    chunk = D if chunk is None else max(min(chunk, D), 1)
    outs = [f(params_draws[i:i + chunk], gen) for i in range(0, D, chunk)]
    return type(outs[0])(*(torch.cat(xs) for xs in zip(*outs)))


@torch.no_grad()
def sample_ms_masses(model: SinglePopModel, params_draws: torch.Tensor,
                     gen: torch.Generator,
                     draw_chunk: int | None = 64) -> MSMassSamples:
    """Exact (mass1, mass ratio) conditional draws for every (posterior
    draw, MS star): params_draws [D, 9] -> fields [D, S]."""
    return _blocks(lambda p, g: _one_block_ms(model, p, g), params_draws,
                   gen, draw_chunk)


@torch.no_grad()
def sample_wd_masses(model: SinglePopModel, params_draws: torch.Tensor,
                     gen: torch.Generator,
                     draw_chunk: int | None = 64) -> WDMassSamples:
    """Precursor/WD mass and cooling-age conditional draws for every
    (posterior draw, WD star), the sampleWDMass step: params_draws [D, 9]
    -> fields [D, S]."""
    return _blocks(lambda p, g: _one_block_wd(model, p, g), params_draws,
                   gen, draw_chunk)
