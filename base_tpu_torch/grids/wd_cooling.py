"""White-dwarf cooling-model grids (port of base_tpu.grids.wd_cooling):
(carbonicity, WD mass, log cooling age) -> (log Teff, log radius).

Every cooling family is one dense rectangular table on (x = carbonicity,
m = WD mass, a = log10 cooling age) axes with trilinear interpolation;
families without a carbonicity dependence carry a length-1 carbonicity
axis and interpolate bilinearly.  The queries carry the chain axis ([C, K]
against tables shared by the chains); `synthetic_wd_cooling` builds the
same smooth Mestel-like family as base_tpu, in numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from base_tpu_torch.ops import interp as iops


@dataclasses.dataclass(frozen=True)
class WdCoolingGrid:
    carb: torch.Tensor        # [X] carbonicity axis (len 1 if family has none)
    mass: torch.Tensor        # [M] WD mass axis, Msun
    log_age: torch.Tensor     # [A] log10 cooling age [yr]
    log_teff: torch.Tensor    # [X, M, A]
    log_radius: torch.Tensor  # [X, M, A] log10(R / Rsun)
    name: str = ""


def wd_teff_radius(grid: WdCoolingGrid, carbonicity: torch.Tensor,
                   wd_mass: torch.Tensor, log_cool_age: torch.Tensor):
    """Trilinear (log Teff, log R, in_bounds) at broadcastable queries
    (e.g. carbonicity [C, 1] against masses and ages [C, K]).  On a
    length-1 carbonicity axis the carbonicity is not interpolated (any
    value takes that plane) and does not enter the hull flag."""
    if grid.carb.shape[0] == 1:
        axes = (grid.mass, grid.log_age)
        point = (wd_mass, log_cool_age)
        teff, radius = grid.log_teff[0], grid.log_radius[0]
    else:
        axes = (grid.carb, grid.mass, grid.log_age)
        point = (carbonicity, wd_mass, log_cool_age)
        teff, radius = grid.log_teff, grid.log_radius
    corners, weights, inside = iops.gather_corners(axes, point)
    return (iops.blend(corners, weights, teff),
            iops.blend(corners, weights, radius), inside)


def synthetic_wd_cooling(
    n_mass: int = 12,
    n_age: int = 40,
    with_carbonicity: bool = True,
    name: str = "synthetic-montgomery",
    *,
    device: torch.device | str,
) -> WdCoolingGrid:
    """Smooth toy cooling physics (Mestel-law shape):

      log L/Lsun = -0.2 - 1.4 (log t_cool - 6) / 2.5 + 0.4 (M - 0.6)
      log R/Rsun = -1.93 - 0.4 (M - 0.6) (+ tiny age contraction)
      log Teff   = (log L - 2 log R) / 4 + log Teff_sun
      carbonicity x shifts the cooling rate: + 0.03 (x - 0.5) in log L.
    """
    carb = (
        np.linspace(0.0, 1.0, 5, dtype=np.float32)
        if with_carbonicity
        else np.array([0.5], np.float32)
    )
    mass = np.linspace(0.4, 1.2, n_mass, dtype=np.float32)
    log_age = np.linspace(5.0, 10.2, n_age, dtype=np.float32)
    X, M, A = np.meshgrid(carb, mass, log_age, indexing="ij")
    logL = (-0.2 - 1.4 * (A - 6.0) / 2.5 + 0.4 * (M - 0.6)
            + 0.03 * (X - 0.5) * (A - 6.0))
    logR = -1.93 - 0.4 * (M - 0.6) - 0.002 * (A - 6.0)
    log_teff_sun = 3.7615
    logTe = 0.25 * (logL - 2.0 * logR) + log_teff_sun
    return pack(carb, mass, log_age, logTe, logR, name=name, device=device)


def pack(carb_axis, mass_axis, log_age_axis, log_teff, log_radius,
         name: str = "", *, device: torch.device | str) -> WdCoolingGrid:
    """Pack cooling tables already rectangularised on a common log-age
    axis (re-grid ragged tracks host-side first) as float32 on `device`."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return WdCoolingGrid(carb=t(carb_axis), mass=t(mass_axis),
                         log_age=t(log_age_axis), log_teff=t(log_teff),
                         log_radius=t(log_radius), name=name)
