"""Carry the reference's state across: build the port's objects from
base_tpu's arrays handed in as numpy (call `np.asarray` on each JAX leaf
first).  Imports no JAX."""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from base_tpu_torch.grids.isochrone import IsochroneGrid
from base_tpu_torch.model.posterior import SinglePopModel
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


def model_from_numpy(grid: Mapping, stars: Mapping, prior_mean, prior_sigma,
                     q_grid, abs_coefs, binaries: bool = True,
                     uniform_q: bool = False, use_pallas: bool = True,
                     upsample: int = 1, *,
                     device: torch.device | str) -> SinglePopModel:
    """SinglePopModel (MS-only) from a base_tpu SinglePopModel's pieces:
    `grid` and `stars` map field names to arrays (plus `bands` and
    optionally `name` for the grid)."""
    return SinglePopModel(
        grid=grid_from_numpy(**grid, device=device),
        stars=stars_from_numpy(**stars, device=device),
        priors=ClusterPriors(mean=_t(prior_mean, device),
                             sigma=_t(prior_sigma, device)),
        q_grid=_t(q_grid, device),
        abs_coefs=_t(abs_coefs, device),
        binaries=binaries,
        uniform_q=uniform_q,
        use_pallas=use_pallas,
        upsample=upsample,
    )
