"""Model-grid loading: the Model-bundle factory (port of
base_tpu.grids.load).

Settings names an MS/RGB family, a WD cooling family, a WD atmosphere
model and an IFMR [upstream: base9/Model.cpp makeModel(Settings) —
SURVEY.md C4]; this module materialises the grids of each on a device.
Families load from `<modelDirectory>/<family>.npz` (the packed container
that base_tpu writes: the same files load here unchanged) or, without
one, from the procedural synthetic family with base_tpu's per-family
axis spans.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from base_tpu_torch.grids import synthetic
from base_tpu_torch.grids import wd_atmosphere as wda
from base_tpu_torch.grids import wd_cooling as wdc
from base_tpu_torch.grids.isochrone import IsochroneGrid
from base_tpu_torch.io.settings import Settings

MS_FAMILIES = ("girardi", "dsed", "yale", "synthetic")
WD_FAMILIES = ("wood", "montgomery", "althaus", "renedo", "synthetic")
# Procedural fallback: per-family axis spans (linspace arguments) differ
# slightly so the families are distinguishable in tests.
SYNTHETIC_SPANS = {
    "girardi": dict(feh=(-2.0, 0.4, 5), y=(0.23, 0.32, 4), age=(8.4, 10.2, 10)),
    "dsed": dict(feh=(-2.2, 0.5, 6), y=(0.24, 0.33, 4), age=(8.6, 10.15, 9)),
    "yale": dict(feh=(-1.8, 0.3, 5), y=(0.22, 0.34, 5), age=(8.5, 10.1, 9)),
    "synthetic": dict(feh=(-2.0, 0.4, 5), y=(0.22, 0.33, 4), age=(8.4, 10.2, 10)),
}


# The arrays of a packed isochrone container, beside its `bands`.
_PACKED = ("feh", "y", "age", "mass", "mags", "valid", "agb_tip")


class ModelBundle(NamedTuple):
    """One resolved model set (the reference `Model` struct analog)."""

    ms: IsochroneGrid
    wd_cooling: wdc.WdCoolingGrid
    wd_atm: wda.WdAtmosphereGrid
    ifmr_kind: str


def _npz_path(model_dir: str, family: str) -> str | None:
    if not model_dir:
        return None
    p = os.path.join(model_dir, f"{family}.npz")
    return p if os.path.exists(p) else None


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def load_ms_grid(settings: Settings, *,
                 device: torch.device | str) -> IsochroneGrid:
    family = settings.models.msRgbModel.lower()
    if family not in MS_FAMILIES:
        raise ValueError(f"unknown msRgbModel {family}; one of {MS_FAMILIES}")
    path = _npz_path(settings.files.modelDirectory, family)
    if path:
        return load_packed_isochrones(path, name=family, device=device)
    spans = SYNTHETIC_SPANS[family]
    return synthetic.make_grid(
        feh_axis=np.linspace(*spans["feh"]),
        y_axis=np.linspace(*spans["y"]),
        age_axis=np.linspace(*spans["age"]),
        bands=tuple(settings.models.bands),
        name=f"synthetic-{family}",
        device=device,
    )


def load_packed_isochrones(path: str, name: str = "", *,
                           device: torch.device | str) -> IsochroneGrid:
    """Load a packed .npz isochrone container (base_tpu's on-disk format)."""
    z = np.load(path, allow_pickle=False)
    return IsochroneGrid(
        **{k: _t(z[k], device) for k in _PACKED},
        bands=tuple(str(b) for b in z["bands"]),
        name=name or str(path),
    )


def save_packed_isochrones(path: str, grid: IsochroneGrid) -> None:
    """Write a packed .npz isochrone container (base_tpu's on-disk format:
    the arrays of `_PACKED` and `bands`)."""
    np.savez_compressed(
        path,
        **{k: getattr(grid, k).detach().cpu().numpy() for k in _PACKED},
        bands=np.asarray(grid.bands),
    )


def load_wd_cooling(settings: Settings, *,
                    device: torch.device | str) -> wdc.WdCoolingGrid:
    family = settings.models.wdModel.lower()
    if family not in WD_FAMILIES:
        raise ValueError(f"unknown wdModel {family}; one of {WD_FAMILIES}")
    path = _npz_path(settings.files.modelDirectory, f"wd_{family}")
    if path:
        z = np.load(path)
        return wdc.pack(
            z["carb"], z["mass"], z["log_age"], z["log_teff"],
            z["log_radius"], name=family, device=device,
        )
    # Montgomery is the carbonicity-resolved family [SURVEY.md C6].
    return wdc.synthetic_wd_cooling(
        with_carbonicity=(family in ("montgomery", "synthetic")),
        name=f"synthetic-{family}",
        device=device,
    )


def load_wd_atmosphere(settings: Settings, *,
                       device: torch.device | str) -> wda.WdAtmosphereGrid:
    path = _npz_path(settings.files.modelDirectory, "bergeron")
    if path:
        z = np.load(path, allow_pickle=False)
        return wda.WdAtmosphereGrid(
            log_teff=_t(z["log_teff"], device),
            log_g=_t(z["log_g"], device),
            mags=_t(z["mags"], device),
            bands=tuple(str(b) for b in z["bands"]),
            name="bergeron",
        )
    return wda.synthetic_bergeron(bands=tuple(settings.models.bands),
                                  device=device)


def make_model(settings: Settings, *,
               device: torch.device | str) -> ModelBundle:
    """Resolve every model family from Settings (makeModel analog)."""
    return ModelBundle(
        ms=load_ms_grid(settings, device=device),
        wd_cooling=load_wd_cooling(settings, device=device),
        wd_atm=load_wd_atmosphere(settings, device=device),
        ifmr_kind=settings.models.ifmr,
    )
