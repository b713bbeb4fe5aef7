"""Photometric filter sets and extinction coefficients.

The port's own copy of base_tpu.grids.filters (the reference's filter
tables), so that base_tpu_torch imports nothing of the JAX package.  Each
band's extinction is A_X = (A_X / A_V) * A_V with the coefficient below;
tests/test_torch_imports.py holds the table equal to base_tpu's.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

# name -> (effective wavelength [nm], A_X / A_V)
FILTERS: dict[str, tuple[float, float]] = {
    # Johnson-Cousins UBVRIJHK
    "U": (365.0, 1.531),
    "B": (445.0, 1.324),
    "V": (551.0, 1.000),
    "R": (658.0, 0.748),
    "I": (806.0, 0.482),
    "J": (1220.0, 0.282),
    "H": (1630.0, 0.175),
    "K": (2190.0, 0.112),
    # SDSS ugriz
    "u": (354.3, 1.579),
    "g": (477.0, 1.161),
    "r": (622.2, 0.843),
    "i": (763.2, 0.639),
    "z": (905.0, 0.453),
    # 2MASS (aliases of JHK with slightly different curves)
    "J_2M": (1235.0, 0.282),
    "H_2M": (1662.0, 0.175),
    "Ks_2M": (2159.0, 0.112),
    # HST ACS/WFC
    "F435W": (432.0, 1.339),
    "F475W": (474.0, 1.212),
    "F555W": (536.0, 1.053),
    "F606W": (592.0, 0.939),
    "F625W": (632.0, 0.875),
    "F775W": (769.0, 0.648),
    "F814W": (806.0, 0.599),
    # HST WFPC2 / UVIS-era names used in cluster photometry
    "F336W": (334.0, 1.649),
    "F439W": (431.0, 1.342),
    "F547M": (548.0, 1.022),
    # Gaia DR-style broad bands
    "G": (622.0, 0.861),
    "G_BP": (511.0, 1.083),
    "G_RP": (777.0, 0.634),
}

DEFAULT_BANDS = ("U", "B", "V", "R", "I", "J", "H", "K")


def wavelengths(bands: Sequence[str]) -> np.ndarray:
    return np.array([FILTERS[b][0] for b in bands], dtype=np.float32)


def absorption_coefs(bands: Sequence[str]) -> np.ndarray:
    """A_X / A_V for each band."""
    return np.array([FILTERS[b][1] for b in bands], dtype=np.float32)
