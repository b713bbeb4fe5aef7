"""Forward cluster simulation, MS/RGB branch (port of
base_tpu.sim.simulate).

Draw ZAMS masses from the truncated lognormal IMF, assign binaries, look
every star up on the same isochrone the sampler uses and emit noiseless
photometry.  Draws come from an explicit `torch.Generator`; they follow
base_tpu's distributions, not its random bits.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from base_tpu_torch import constants as C
from base_tpu_torch.grids import filters as filt
from base_tpu_torch.grids.isochrone import IsochroneGrid, derive_isochrone
from base_tpu_torch.model.likelihood import companion_lit_weight
from base_tpu_torch.ops.table import LN10_04


class SimCatalog(NamedTuple):
    mags: torch.Tensor        # [S, B] noiseless apparent magnitudes
    mass1: torch.Tensor       # [S] primary ZAMS mass
    mass_ratio: torch.Tensor  # [S] secondary/primary (0 = single)
    is_binary: torch.Tensor   # [S] bool
    stage: torch.Tensor       # [S] int32 StarStatus (MSRG)


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


def simulate_cluster(
    grid: IsochroneGrid,
    params: torch.Tensor,
    n_stars: int,
    gen: torch.Generator,
    percent_binary: float = 0.3,
    min_mass: float = 0.2,
    max_mass: float | None = None,
) -> SimCatalog:
    """Simulate a single-population MS/RGB cluster at truth `params` [9].
    Masses truncate below the AGB tip (the WD branch is not ported)."""
    p = params.to(grid.device)
    age, y, feh = p[C.Param.AGE], p[C.Param.YYY], p[C.Param.FEH]
    mod, av = p[C.Param.MOD], p[C.Param.ABS]

    iso = derive_isochrone(grid, feh[None], y[None], age[None])
    if max_mass is None:
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

    coefs = torch.as_tensor(filt.absorption_coefs(grid.bands),
                            device=grid.device)
    dist = mod + av * coefs                                   # [B]
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
    return SimCatalog(mags=mags, mass1=m1, mass_ratio=q,
                      is_binary=is_binary, stage=stage)
