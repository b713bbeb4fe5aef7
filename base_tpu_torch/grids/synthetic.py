"""Procedural synthetic model grids (port of base_tpu.grids.synthetic).

The toy stellar physics is numpy and matches base_tpu's function for
function, so both packages build the same grid from the same axes; only
the packing lands in torch tensors on an explicit device.

Toy stellar physics (all smooth in mass/FeH/Y/age):
  log10 t_MS(M)  = 10.05 - 2.9 log10 M + 0.05 FeH - 0.8 (Y - 0.27)
  turnoff mass   : t_MS(M_TO) = age;   AGB tip = 1.12 M_TO
  log10 L        = 4.0 log10 M + RGB boost above the turnoff
  log10 Teff     = 3.762 + 0.42 log10 M - RGB cooling - 0.02 FeH
                   + 0.10 (Y - 0.27)
  band mags      = M_bol + k_band (5040/Teff - 5040/5772)
                   + 0.05 FeH (551/lambda_band - 1)
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from base_tpu_torch.grids import filters as filt
from base_tpu_torch.grids.isochrone import IsochroneGrid, pack_ragged

THETA_SUN = 5040.0 / 5772.0


def _softplus(x):
    return np.logaddexp(0.0, x)


def ms_lifetime_logage(mass, feh, y):
    """log10 main-sequence lifetime [yr] of a star of ZAMS `mass`."""
    return 10.05 - 2.9 * np.log10(mass) + 0.05 * feh - 0.8 * (y - 0.27)


def turnoff_mass(logage, feh, y):
    """Invert ms_lifetime_logage for the turnoff mass at `logage`."""
    return 10.0 ** ((10.05 + 0.05 * feh - 0.8 * (y - 0.27) - logage) / 2.9)


def star_mags(mass, logage, feh, y, bands: Sequence[str]) -> np.ndarray:
    """Absolute magnitudes of a cluster star of ZAMS `mass` (any shape);
    returns mass.shape + (B,).  Valid up to the AGB tip."""
    mass = np.asarray(mass, np.float64)
    m_to = turnoff_mass(logage, feh, y)
    x = mass / m_to
    rgb = _softplus((x - 1.0) / 0.04) * 0.04  # 0 on MS, grows past turnoff
    logL = 4.0 * np.log10(mass) + 2.5 * np.tanh(rgb) + 0.5 * (y - 0.27)
    logTe = (
        3.762
        + 0.42 * np.log10(mass)
        - 0.35 * np.tanh(rgb * 1.4)
        - 0.02 * feh
        + 0.10 * (y - 0.27)
    )
    mbol = 4.75 - 2.5 * logL
    theta = 5040.0 / 10.0 ** logTe
    lam = filt.wavelengths(bands).astype(np.float64)
    k = 2.2 * (551.0 / lam - 1.0)
    blank = 0.05 * feh * (551.0 / lam - 1.0)
    return (mbol[..., None] + k * (theta[..., None] - THETA_SUN) + blank).astype(
        np.float32
    )


def make_isochrone(
    logage, feh, y, n_eep: int, bands: Sequence[str], m_lo: float = 0.15
):
    """One toy isochrone: (mass[e], mags[e, B]) with EEPs denser near tip."""
    m_tip = 1.12 * turnoff_mass(logage, feh, y)
    s = np.linspace(0.0, 1.0, n_eep)
    mass = m_tip - (m_tip - m_lo) * (1.0 - s) ** 1.5
    mags = star_mags(mass, logage, feh, y, bands)
    return mass.astype(np.float32), mags


def make_grid(
    feh_axis=None,
    y_axis=None,
    age_axis=None,
    n_eep: int = 80,
    bands: Sequence[str] = filt.DEFAULT_BANDS,
    ragged: bool = True,
    name: str = "synthetic-girardi",
    *,
    device: torch.device | str,
) -> IsochroneGrid:
    """Full synthetic model family packed into an IsochroneGrid on
    `device`.  `ragged=True` drops a few tip EEPs per cell (varying with
    the indices) to exercise the validity masks as real grids do."""
    feh_axis = (
        np.asarray(feh_axis, np.float32)
        if feh_axis is not None
        else np.linspace(-2.0, 0.4, 5, dtype=np.float32)
    )
    y_axis = (
        np.asarray(y_axis, np.float32)
        if y_axis is not None
        else np.linspace(0.22, 0.33, 4, dtype=np.float32)
    )
    age_axis = (
        np.asarray(age_axis, np.float32)
        if age_axis is not None
        else np.linspace(8.4, 10.2, 10, dtype=np.float32)
    )
    isochrones = {}
    for fi, feh in enumerate(feh_axis):
        for yi, y in enumerate(y_axis):
            for ai, age in enumerate(age_axis):
                drop = (ai * 3 + fi * 2 + yi) % 4 if ragged else 0
                n = n_eep - drop
                m, mg = make_isochrone(float(age), float(feh), float(y), n, bands)
                isochrones[(fi, yi, ai)] = (m, mg)
    return pack_ragged(feh_axis, y_axis, age_axis, isochrones, bands,
                       device=device, name=name)
