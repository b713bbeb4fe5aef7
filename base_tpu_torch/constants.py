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


class StarStatus(enum.IntEnum):
    """Per-star evolutionary status codes from the .phot file: MSRG = main
    sequence / red giant, WD = white dwarf, NSBH = neutron star / black
    hole, BD = brown dwarf, DNE = does not exist."""

    MSRG = 1
    WD = 3
    NSBH = 4
    BD = 5
    DNE = 9


# Lognormal IMF prior on primary mass: log10(M/Msun) ~ N(mean, sigma^2).
IMF_LOG_MEAN = -1.02
IMF_LOG_SIGMA = 0.677
