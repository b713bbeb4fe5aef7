"""White-dwarf model atmospheres (port of base_tpu.grids.wd_atmosphere):
(log Teff, log g) -> magnitudes, DA (hydrogen) and DB (helium) tables.

Both atmosphere types live in one [2, T, G, B] dense table; `wd_mags`
bilinearly interpolates one type's plane at broadcastable queries (the
likelihood blends DA and DB as a smooth mixture).  `synthetic_bergeron`
builds the same toy tables as base_tpu, in numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from base_tpu_torch import constants as C
from base_tpu_torch.grids import filters as filt
from base_tpu_torch.ops import interp as iops


@dataclasses.dataclass(frozen=True)
class WdAtmosphereGrid:
    log_teff: torch.Tensor  # [T]
    log_g: torch.Tensor     # [G]
    mags: torch.Tensor      # [2, T, G, B] absolute mags; 0 = DA, 1 = DB
    bands: tuple[str, ...] = ()
    name: str = ""


def wd_mags(grid: WdAtmosphereGrid, log_teff: torch.Tensor,
            log_g: torch.Tensor, wd_type: int):
    """Absolute magnitudes of one atmosphere type at the queries: (query
    shape + [B], inside)."""
    return iops.multilinear((grid.log_teff, grid.log_g), grid.mags[wd_type],
                            (log_teff, log_g))


def select_atm_bands(grid: WdAtmosphereGrid, band_idx,
                     bands) -> WdAtmosphereGrid:
    """Restrict the atmosphere table to a band subset (the WD side of the
    filter-set intersection)."""
    idx = torch.as_tensor(np.asarray(band_idx), device=grid.mags.device)
    return dataclasses.replace(grid, mags=grid.mags[..., idx],
                               bands=tuple(bands))


def synthetic_bergeron(bands=filt.DEFAULT_BANDS, n_teff: int = 30,
                       n_logg: int = 12, *,
                       device: torch.device | str) -> WdAtmosphereGrid:
    """Smooth toy atmospheres with Bergeron-table structure.

    M_bol from (Teff, R(logg)) with R via g = G M / R^2 at a nominal
    0.6 Msun; band mags = M_bol + BC-like color terms; DB slightly
    bluer at fixed Teff (helium opacity toy).
    """
    log_teff = np.linspace(3.45, 4.45, n_teff, dtype=np.float32)
    log_g = np.linspace(7.0, 9.0, n_logg, dtype=np.float32)
    T, G = np.meshgrid(log_teff, log_g, indexing="ij")
    # log10(G * 0.6 Msun in cgs) = log10(6.674e-8 * 0.6 * 1.989e33)
    log_gm = np.log10(6.674e-8 * 0.6 * 1.989e33)
    logR_cm = 0.5 * (log_gm - G)            # cm
    logR = logR_cm - np.log10(6.957e10)     # Rsun
    log_teff_sun = 3.7615
    logL = 2.0 * logR + 4.0 * (T - log_teff_sun)
    mbol = C.MBOL_SUN - 2.5 * logL
    lam = filt.wavelengths(bands).astype(np.float64)
    k = 2.2 * (551.0 / lam - 1.0)
    theta = 5040.0 / 10.0**T
    theta_sun = 5040.0 / 10.0**log_teff_sun
    base = mbol[..., None] + k[None, None, :] * (theta[..., None] - theta_sun)
    da = base
    db = base - 0.06 * (551.0 / lam - 1.0)[None, None, :]  # toy He blanketing
    mags = np.stack([da, db], axis=0).astype(np.float32)
    return WdAtmosphereGrid(
        log_teff=torch.as_tensor(log_teff, device=device),
        log_g=torch.as_tensor(log_g, device=device),
        mags=torch.as_tensor(mags, device=device),
        bands=tuple(bands),
        name="synthetic-bergeron",
    )
