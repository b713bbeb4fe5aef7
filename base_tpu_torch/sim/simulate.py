"""Forward cluster simulation (port of base_tpu.sim.simulate).

Draw ZAMS masses from the truncated lognormal IMF, assign binaries, look
every star up on the same isochrone the sampler uses and emit noiseless
photometry.  With WD grids, stars heavier than the AGB tip evolve through
IFMR -> WD cooling -> atmosphere (DA or DB per `percent_db`), through the
same chain as the likelihood's WD branch.  Draws come from an explicit
`torch.Generator`; they follow base_tpu's distributions, not its random
bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from base_tpu_torch import constants as C
from base_tpu_torch.grids import filters as filt
from base_tpu_torch.grids.isochrone import IsochroneGrid, derive_isochrone
from base_tpu_torch.model import ifmr as ifmr_mod
from base_tpu_torch.model import wd as wd_mod
from base_tpu_torch.model.likelihood import companion_lit_weight
from base_tpu_torch.ops.table import LN10_04


class SimCatalog(NamedTuple):
    mags: torch.Tensor        # [S, B] noiseless apparent magnitudes
    mass1: torch.Tensor       # [S] primary ZAMS mass
    mass_ratio: torch.Tensor  # [S] secondary/primary (0 = single)
    is_binary: torch.Tensor   # [S] bool
    stage: torch.Tensor       # [S] int32 StarStatus (MSRG or WD)
    is_db: torch.Tensor       # [S] bool (meaningful only where stage == WD)


def sample_imf_masses(gen: torch.Generator, n: int, lo: float,
                      hi: float) -> torch.Tensor:
    """Truncated-lognormal IMF draws, log10 M ~ N(mu, sig) on [lo, hi], by
    inverse CDF (in float64, so the truncation tails stay exact)."""
    zlo = (math.log10(lo) - C.IMF_LOG_MEAN) / C.IMF_LOG_SIGMA
    zhi = (math.log10(hi) - C.IMF_LOG_MEAN) / C.IMF_LOG_SIGMA
    dev = gen.device
    cdf = torch.special.ndtr(
        torch.tensor([zlo, zhi], dtype=torch.float64, device=dev))
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
    z = torch.special.ndtri(cdf[0] + u * (cdf[1] - cdf[0]))
    z = z.clamp(zlo, zhi)
    return (10.0 ** (C.IMF_LOG_MEAN + C.IMF_LOG_SIGMA * z)).float()


def field_cmd_box(ref_mags: torch.Tensor, spread: float = 3.0):
    """The per-band uniform-field CMD box, the cluster's span +/- spread:
    (lo [B], hi [B]).  Pass `hi - lo` as make_ms_stars(field_mag_range=)
    so that the likelihood's field density is normalised over the box the
    field stars occupy."""
    return ref_mags.amin(0) - spread, ref_mags.amax(0) + spread


def simulate_field_stars(gen: torch.Generator, n: int,
                         ref_mags: torch.Tensor,
                         spread: float = 3.0) -> torch.Tensor:
    """Field-star photometry [n, B]: uniform draws in the CMD box spanning
    the cluster's magnitude range (+/- spread) per band."""
    lo, hi = field_cmd_box(ref_mags, spread)
    u = torch.rand((n, ref_mags.shape[1]), generator=gen, device=gen.device)
    return lo + u.to(ref_mags.device) * (hi - lo)


def _distance(grid: IsochroneGrid, params: torch.Tensor) -> torch.Tensor:
    """[B] distance modulus + per-band extinction of the truth `params`."""
    coefs = torch.as_tensor(filt.absorption_coefs(grid.bands),
                            device=grid.device)
    return params[C.Param.MOD] + params[C.Param.ABS] * coefs


def wd_apparent_mags(grid: IsochroneGrid, params: torch.Tensor,
                     zams_mass: torch.Tensor, is_db: torch.Tensor,
                     wd_cooling, wd_atm, ifmr_kind: str) -> torch.Tensor:
    """Noiseless apparent mags [S, B] of stars of ZAMS mass [S] evolved to
    WDs in the cluster at truth `params` [9]: precursor lifetime ->
    cooling age, IFMR -> WD mass, cooling grid -> (Teff, R) -> log g, and
    the DB atmosphere where `is_db`, else the DA one."""
    p = params.to(grid.device)
    prec = wd_mod.wd_prec_logage(grid, p[None, C.Param.FEH],
                                 p[None, C.Param.YYY], zams_mass[None])[0]
    log_cool = wd_mod.cooling_log_age(prec, p[C.Param.AGE])
    m_wd = ifmr_mod.ifmr_mass(ifmr_kind, zams_mass, p)
    mda, mdb, _, _ = wd_mod.wd_photometry(
        wd_cooling, wd_atm, p[C.Param.CARBONICITY], m_wd, log_cool)
    return torch.where(is_db[:, None], mdb, mda) + _distance(grid, p)


def simulate_cluster(
    grid: IsochroneGrid,
    params: torch.Tensor,
    n_stars: int,
    gen: torch.Generator,
    percent_binary: float = 0.3,
    min_mass: float = 0.2,
    wd_cooling=None,
    wd_atm=None,
    ifmr_kind: str = "weidemann",
    percent_db: float = 0.1,
    max_mass: float | None = None,
) -> SimCatalog:
    """Simulate a single-population cluster at truth `params` [9].

    Without WD grids, masses truncate below the AGB tip (MS/RGB only).
    With them, the IMF extends to MAX_WD_PRECURSOR_MASS and stars heavier
    than the AGB tip come out as WDs (stage WD, companions dropped)."""
    p = params.to(grid.device)
    age, y, feh = p[C.Param.AGE], p[C.Param.YYY], p[C.Param.FEH]

    iso = derive_isochrone(grid, feh[None], y[None], age[None])
    with_wds = wd_cooling is not None and wd_atm is not None
    if max_mass is None and with_wds:
        max_mass = float(C.MAX_WD_PRECURSOR_MASS)
    elif max_mass is None:
        hull_max = torch.where(iso.valid > 0.5, iso.mass,
                               torch.zeros_like(iso.mass)).max()
        max_mass = float(hull_max) * 0.999
    dev = gen.device
    m1 = sample_imf_masses(gen, n_stars, min_mass, max_mass)
    is_binary = torch.rand(n_stars, generator=gen, device=dev) < percent_binary
    q = torch.where(is_binary, torch.rand(n_stars, generator=gen, device=dev),
                    torch.zeros(n_stars, device=dev))
    m1, q, is_binary = (m1.to(grid.device), q.to(grid.device),
                        is_binary.to(grid.device))

    dist = _distance(grid, p)                                 # [B]
    # PRIMARY: piecewise-LINEAR lookup, the curve the segment-exact
    # marginal integrates over.
    app1 = iso.mags_at_mass(m1[None], smooth=False)[0] + dist  # [S, B]
    m2 = q * m1
    # SECONDARY: the fitted density's companion model -- smoothstep lookup
    # and the soft min-mass ramp.
    app2 = iso.mags_at_mass(m2[None], smooth=True)[0] + dist
    lit = companion_lit_weight(m2, iso.min_mass)[:, None]
    f = torch.exp(-LN10_04 * app1) + lit * torch.exp(-LN10_04 * app2)
    mags = -(1.0 / LN10_04) * torch.log(f)
    stage = torch.full((n_stars,), int(C.StarStatus.MSRG), dtype=torch.int32,
                       device=grid.device)
    no_db = torch.zeros(n_stars, dtype=torch.bool, device=grid.device)
    if not with_wds:
        return SimCatalog(mags=mags, mass1=m1, mass_ratio=q,
                          is_binary=is_binary, stage=stage, is_db=no_db)

    is_wd = m1 > iso.agb_tip
    draw_db = torch.rand(n_stars, generator=gen, device=dev) < percent_db
    is_db = draw_db.to(grid.device) & is_wd
    wd_app = wd_apparent_mags(grid, p, m1, is_db, wd_cooling, wd_atm,
                              ifmr_kind)
    return SimCatalog(
        mags=torch.where(is_wd[:, None], wd_app, mags),
        mass1=m1,
        mass_ratio=torch.where(is_wd, torch.zeros_like(q), q),
        is_binary=is_binary & ~is_wd,
        stage=torch.where(is_wd, int(C.StarStatus.WD), stage),
        is_db=is_db,
    )
