"""White-dwarf branch of the likelihood (port of base_tpu.model.wd):
precursor-mass marginalisation through IFMR -> cooling -> atmosphere.

For each WD the likelihood integrates over the unknown ZAMS (precursor)
mass on a fixed grid of K nodes, chaining

  zams mass -> precursor lifetime (inverting the isochrone grid's AGB-tip
  mass against age) -> cooling age = cluster age - lifetime -> WD mass
  (IFMR, possibly with sampled coefficients) -> (Teff, radius) from the
  cooling grid -> log g -> DA/DB atmosphere mags -> Gaussian band loglik.

Every chain evaluates the whole [C, K] node chain at once against grids
shared by the chains.  The precursor-mass integral is segment-exact: the
DA and DB branches form one concatenated segment table of 2 (K - 1) rows
with the mixture weights and the normaliser folded into its log weights,
so it runs through the same marginal as the MS path (kernels 3 and 4 on a
CUDA model).  WD stars reuse the MSStars container.
"""
from __future__ import annotations

import math

import torch

from base_tpu_torch import constants as C
from base_tpu_torch.grids.isochrone import IsochroneGrid
from base_tpu_torch.grids.wd_atmosphere import WdAtmosphereGrid, wd_mags
from base_tpu_torch.grids.wd_cooling import WdCoolingGrid, wd_teff_radius
from base_tpu_torch.model import ifmr as ifmr_mod
from base_tpu_torch.model import likelihood as lk
from base_tpu_torch.model import priors
from base_tpu_torch.model.stardata import MSStars
from base_tpu_torch.ops import interp as iops
from base_tpu_torch.ops.special import NEG_INF, masked_logsumexp

WDStars = MSStars  # same per-star observation layout

# log10(g_sun) for M in Msun, R in Rsun: g = G M / R^2 [cgs]
LOG_G_SUN = 4.4383


def wd_prec_logage(grid: IsochroneGrid, feh: torch.Tensor, y: torch.Tensor,
                   zams_mass: torch.Tensor) -> torch.Tensor:
    """Precursor MS+RGB lifetime log10(age/yr) of stars of `zams_mass`
    ([K] or [C, K]) in each chain's cluster (feh, y [C]) -> [C, K].

    Inverts the AGB-tip-mass-vs-age curve of the isochrone grid at the
    chain's (FeH, Y): tip(age) decreases with age, so the inverse is a 1-D
    interpolation on the negated curve [C, A], a per-chain axis whose
    values carry the gradient in FeH and Y.  Queries outside the grid's
    age span clamp to its ends."""
    corners, weights, _ = iops.gather_corners((grid.feh, grid.y), (feh, y))
    tip = iops.blend(corners, weights, grid.agb_tip)          # [C, A]
    return iops.interp1d(-tip, grid.age, -zams_mass)


def cooling_log_age(prec: torch.Tensor, age: torch.Tensor) -> torch.Tensor:
    """log10(10^age - 10^prec) in a stable form, with the lifetime held at
    least 1e-4 dex below the age (`age` broadcasts against `prec`)."""
    delta = (prec - age).clamp(-30.0, -1e-4)
    return age + torch.log10(1.0 - 10.0 ** delta)


def wd_photometry(cooling: WdCoolingGrid, atm: WdAtmosphereGrid,
                  carbonicity: torch.Tensor, m_wd: torch.Tensor,
                  log_cool: torch.Tensor):
    """Absolute DA and DB mags of WDs of mass m_wd at cooling age log_cool:
    (mags_da, mags_db [..., B], logg, inside), where inside holds the
    cooling and both atmosphere hulls."""
    lt, lr, in_cool = wd_teff_radius(cooling, carbonicity, m_wd, log_cool)
    logg = LOG_G_SUN + torch.log10(m_wd.clamp_min(1e-3)) - 2.0 * lr
    mags_da, in_a = wd_mags(atm, lt, logg, 0)
    mags_db, in_b = wd_mags(atm, lt, logg, 1)
    return mags_da, mags_db, logg, in_cool & in_a & in_b


def wd_model_mags(
    iso_grid: IsochroneGrid,
    cooling: WdCoolingGrid,
    atm: WdAtmosphereGrid,
    params: torch.Tensor,    # [C, 9]
    mz_grid: torch.Tensor,   # [K] precursor ZAMS mass nodes
    ifmr_kind: str,
):
    """Absolute DA/DB magnitudes and validity of each precursor-mass node:
    (mags [C, 2, K, B], logg [C, K], valid [C, K])."""
    age = params[:, C.Param.AGE, None]
    feh = params[:, C.Param.FEH]
    y = params[:, C.Param.YYY]
    carb = params[:, C.Param.CARBONICITY, None]

    prec = wd_prec_logage(iso_grid, feh, y, mz_grid)           # [C, K]
    log_cool = cooling_log_age(prec, age)
    has_cooled = prec < age - 1e-4
    m_wd = ifmr_mod.ifmr_mass(ifmr_kind, mz_grid, params).expand_as(prec)
    mags_da, mags_db, logg, inside = wd_photometry(cooling, atm, carb, m_wd,
                                                   log_cool)
    mags = torch.stack([mags_da, mags_db], dim=1)              # [C, 2, K, B]
    valid = (has_cooled & inside & (m_wd > 0.05)
             & (mz_grid < C.MAX_WD_PRECURSOR_MASS))
    return mags, logg, valid


def _type_log_weights(p_db: float) -> tuple[float, float]:
    """log of the DA and DB mixture weights, each clipped to [1e-6, 1]."""
    return (math.log(min(max(1.0 - p_db, 1e-6), 1.0)),
            math.log(min(max(p_db, 1e-6), 1.0)))


def wd_segment_table(
    mags: torch.Tensor,        # [C, 2, K, B] absolute model mags (DA, DB)
    valid: torch.Tensor,       # [C, K]
    mz_grid: torch.Tensor,     # [K]
    modulus: torch.Tensor,     # [C]
    absorption: torch.Tensor,  # [C]
    abs_coefs: torch.Tensor,   # [B]
    p_db: float = 0.1,
) -> lk.SegmentTable:
    """Segment table over the precursor-mass chain, [C, 2 (K - 1), B]:
    the DA segments, then the DB segments, with the mixture weights and
    the mass-prior normaliser -log Z folded into logw (so the caller
    subtracts no normaliser).  Within a segment the apparent magnitudes
    run linearly from node k to k + 1, so the precursor-mass integral is
    the closed-form Gaussian segment integral: a nodal sum would alias,
    since a WD's likelihood width in precursor mass (~0.003-0.03 Msun) is
    far below any affordable node spacing.  The shared DA/DB validity
    mask makes one normaliser serve both branches."""
    Cn, _, _, B = mags.shape
    dist = modulus[:, None] + absorption[:, None] * abs_coefs   # [C, B]
    app = mags + dist[:, None, None, :]                        # [C, 2, K, B]
    m_mid = 0.5 * (mz_grid[1:] + mz_grid[:-1])
    dm = mz_grid[1:] - mz_grid[:-1]
    logw_m = priors.log_imf(m_mid) + torch.log(dm.clamp_min(1e-30))
    seg_valid = valid[:, 1:] & valid[:, :-1]                   # [C, K-1]
    log_z = masked_logsumexp(logw_m.expand_as(seg_valid), seg_valid, dim=-1)
    wa, wb = _type_log_weights(p_db)
    logw = torch.cat([logw_m + wa - log_z[:, None],
                      logw_m + wb - log_z[:, None]], dim=1)
    return lk.SegmentTable(
        lo=app[:, :, :-1].reshape(Cn, -1, B),
        hi=app[:, :, 1:].reshape(Cn, -1, B),
        logw=logw,
        mask=torch.cat([seg_valid, seg_valid], dim=1),
    )


def wd_star_log_marginals(
    stars: WDStars,
    mags: torch.Tensor,
    valid: torch.Tensor,
    mz_grid: torch.Tensor,
    modulus: torch.Tensor,
    absorption: torch.Tensor,
    abs_coefs: torch.Tensor,
    p_db: float = 0.1,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Per-WD log marginal cluster likelihood of every chain [C, S]:
    segment-exact precursor-mass integral, DA/DB mixture, through the MS
    path's marginal (kernels 3 and 4 when `use_pallas`)."""
    table = wd_segment_table(mags, valid, mz_grid, modulus, absorption,
                             abs_coefs, p_db)
    out = lk.ms_log_marginals(stars, table, use_pallas)
    return out.clamp_min(NEG_INF)


def wd_total_loglik(
    stars: WDStars,
    mags: torch.Tensor,
    valid: torch.Tensor,
    mz_grid: torch.Tensor,
    modulus: torch.Tensor,
    absorption: torch.Tensor,
    abs_coefs: torch.Tensor,
    p_db: float = 0.1,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Field-mixture total over the WD stars [C] (the MS path's mixture)."""
    log_clust = wd_star_log_marginals(stars, mags, valid, mz_grid, modulus,
                                      absorption, abs_coefs, p_db,
                                      use_pallas)
    return lk.field_mixture_total(stars, log_clust)
