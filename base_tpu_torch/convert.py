"""Carry the reference's state across: build the port's objects from
base_tpu's arrays handed in as numpy (call `np.asarray` on each JAX leaf
first).  Imports no JAX."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from base_tpu_torch.grids.isochrone import IsochroneGrid
from base_tpu_torch.grids.wd_atmosphere import WdAtmosphereGrid
from base_tpu_torch.grids.wd_cooling import WdCoolingGrid
from base_tpu_torch.model.multipop import MultiPopModel
from base_tpu_torch.model.posterior import ClusterModel, SinglePopModel
from base_tpu_torch.model.priors import ClusterPriors
from base_tpu_torch.model.stardata import MSStars


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def grid_from_numpy(feh, y, age, mass, mags, valid, agb_tip,
                    bands: Sequence[str], *, device: torch.device | str,
                    name: str = "") -> IsochroneGrid:
    """IsochroneGrid from the fields of a base_tpu IsochroneGrid."""
    return IsochroneGrid(
        feh=_t(feh, device), y=_t(y, device), age=_t(age, device),
        mass=_t(mass, device), mags=_t(mags, device),
        valid=_t(valid, device), agb_tip=_t(agb_tip, device),
        bands=tuple(bands), name=name,
    )


def stars_from_numpy(obs_over_var, inv_var, c0, log_norm, log_cm,
                     log_1m_cm, field_logdens, star_mask, obs_mags,
                     obs_sigma, *, device: torch.device | str) -> MSStars:
    """MSStars from the fields of a base_tpu MSStars."""
    return MSStars(
        obs_over_var=_t(obs_over_var, device), inv_var=_t(inv_var, device),
        c0=_t(c0, device), log_norm=_t(log_norm, device),
        log_cm=_t(log_cm, device), log_1m_cm=_t(log_1m_cm, device),
        field_logdens=_t(field_logdens, device),
        star_mask=_t(star_mask, device), obs_mags=_t(obs_mags, device),
        obs_sigma=_t(obs_sigma, device),
    )


def wd_cooling_from_numpy(carb, mass, log_age, log_teff, log_radius, *,
                          device: torch.device | str,
                          name: str = "") -> WdCoolingGrid:
    """WdCoolingGrid from the fields of a base_tpu WdCoolingGrid."""
    return WdCoolingGrid(
        carb=_t(carb, device), mass=_t(mass, device),
        log_age=_t(log_age, device), log_teff=_t(log_teff, device),
        log_radius=_t(log_radius, device), name=name,
    )


def wd_atm_from_numpy(log_teff, log_g, mags, bands: Sequence[str] = (), *,
                      device: torch.device | str,
                      name: str = "") -> WdAtmosphereGrid:
    """WdAtmosphereGrid from the fields of a base_tpu WdAtmosphereGrid."""
    return WdAtmosphereGrid(
        log_teff=_t(log_teff, device), log_g=_t(log_g, device),
        mags=_t(mags, device), bands=tuple(bands), name=name,
    )


def model_from_numpy(grid: Mapping, stars: Mapping, prior_mean, prior_sigma,
                     q_grid, abs_coefs, binaries: bool = True,
                     uniform_q: bool = False, use_pallas: bool = True,
                     upsample: int = 1, wd_cooling: Mapping | None = None,
                     wd_atm: Mapping | None = None,
                     wd_stars: Mapping | None = None, mz_grid=None,
                     ifmr_kind: str = "linear", p_db: float = 0.1, *,
                     device: torch.device | str,
                     cls: type = SinglePopModel) -> ClusterModel:
    """SinglePopModel (or another ClusterModel `cls`) from a base_tpu
    model's pieces: `grid`, `stars` and, for a WD branch, `wd_cooling`,
    `wd_atm` and `wd_stars` map field names to arrays (plus the grids'
    `bands` and `name`), and `mz_grid` is base_tpu's precursor-mass
    grid."""
    wd = {}
    if wd_stars is not None:
        wd = dict(
            wd_cooling=wd_cooling_from_numpy(**wd_cooling, device=device),
            wd_atm=wd_atm_from_numpy(**wd_atm, device=device),
            wd_stars=stars_from_numpy(**wd_stars, device=device),
            mz_grid=_t(mz_grid, device),
        )
    return cls(
        grid=grid_from_numpy(**grid, device=device),
        stars=stars_from_numpy(**stars, device=device),
        priors=ClusterPriors(mean=_t(prior_mean, device),
                             sigma=_t(prior_sigma, device)),
        q_grid=_t(q_grid, device),
        abs_coefs=_t(abs_coefs, device),
        ifmr_kind=ifmr_kind,
        p_db=p_db,
        binaries=binaries,
        uniform_q=uniform_q,
        use_pallas=use_pallas,
        upsample=upsample,
        **wd,
    )


def multipop_model_from_numpy(*args, device: torch.device | str,
                              **kwargs) -> MultiPopModel:
    """MultiPopModel from a base_tpu MultiPopModel's pieces (priors over
    the 12-vector), as model_from_numpy."""
    return model_from_numpy(*args, device=device, cls=MultiPopModel,
                            **kwargs)
