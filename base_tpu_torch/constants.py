"""Parameter indexing, star status codes and the IMF constants the port uses.

The port's own copy of the parts of base_tpu.constants it needs (the
reference's constants layer, base9/constants.hpp), so that base_tpu_torch
imports nothing of the JAX package.  Same enum order and values, so chain
output columns and config files line up with base_tpu and the reference;
tests/test_torch_imports.py holds them equal.
"""
from __future__ import annotations

import enum

NPARAMS = 9


class Param(enum.IntEnum):
    """Indices into the 9-element cluster parameter vector."""

    AGE = 0          # log10(age / yr)
    YYY = 1          # helium mass fraction Y
    FEH = 2          # metallicity [Fe/H]
    MOD = 3          # distance modulus (m - M)_V
    ABS = 4          # absorption A_V
    CARBONICITY = 5  # WD C/O core mass fraction
    IFMR_INTERCEPT = 6
    IFMR_SLOPE = 7
    IFMR_QUADCOEF = 8


PARAM_NAMES = (
    "logAge",
    "Y",
    "FeH",
    "modulus",
    "absorption",
    "carbonicity",
    "ifmrIntercept",
    "ifmrSlope",
    "ifmrQuadCoef",
)


class StarStatus(enum.IntEnum):
    """Per-star evolutionary status codes from the .phot file: MSRG = main
    sequence / red giant, WD = white dwarf, NSBH = neutron star / black
    hole, BD = brown dwarf, DNE = does not exist."""

    MSRG = 1
    WD = 3
    NSBH = 4
    BD = 5
    DNE = 9


class WdType(enum.IntEnum):
    """White-dwarf atmosphere type (hydrogen DA vs helium DB)."""

    DA = 0
    DB = 1


# Zero-point conversion mag <-> flux:  f = 10^(-0.4 m)
MAG_FLUX_COEF = -0.4

# log10(e), used to convert natural-log densities to mag-space.
LOG10_E = 0.43429448190325176

# Solar bolometric magnitude (toy WD atmospheres, grids/wd_atmosphere.py).
MBOL_SUN = 4.75

# Reference epsilon guarding divisions in interpolation weights.
EPS = 1e-12

# Lognormal IMF prior on primary mass: log10(M/Msun) ~ N(mean, sigma^2).
IMF_LOG_MEAN = -1.02
IMF_LOG_SIGMA = 0.677

# Minimum stellar mass considered anywhere (Msun).
MIN_MASS = 0.1
# Maximum ZAMS mass of a WD precursor (above this: NS/BH, zero likelihood).
MAX_WD_PRECURSOR_MASS = 8.0
