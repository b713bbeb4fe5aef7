"""Initial-final mass relations, ZAMS mass -> WD mass (port of
base_tpu.model.ifmr).

Fixed published relations plus the tunable linear/quadratic whose
coefficients are cluster parameters 7-9, centred on a 3 Msun pivot so the
intercept is the WD mass of a 3 Msun progenitor:
  Weidemann 2000:          m_wd = 0.109 m + 0.394
  Williams+ 2009:          m_wd = 0.339 + 0.129 m
  Salaris+ 2009 linear:    m_wd = 0.466 + 0.084 m
  Salaris+ 2009 piecewise: m < 4: 0.331 + 0.134 m;  m >= 4: 0.679 + 0.047 m
  linear:    m_wd = b0 + b1 (m - 3)
  quadratic: m_wd = b0 + b1 (m - 3) + b2 (m - 3)^2
Closed form, differentiable in both the mass and the coefficients.
"""
from __future__ import annotations

import torch

from base_tpu_torch import constants as C

IFMR_PIVOT = 3.0

FIXED_IFMRS = ("weidemann", "williams", "salaris_lin", "salaris_pw")
TUNABLE_IFMRS = ("linear", "quadratic")


def ifmr_mass(kind: str, zams_mass: torch.Tensor,
              params: torch.Tensor) -> torch.Tensor:
    """WD mass of progenitors `zams_mass` under relation `kind`.

    `params` is [9] or [C, 9]; only the IFMR slots are read (and only for
    the tunable kinds), each broadcast against the last axis of
    `zams_mass` ([K] or [C, K] -> [C, K] for chains)."""
    m = zams_mass
    if kind == "weidemann":
        return 0.394 + 0.109 * m
    if kind == "williams":
        return 0.339 + 0.129 * m
    if kind == "salaris_lin":
        return 0.466 + 0.084 * m
    if kind == "salaris_pw":
        return torch.where(m < 4.0, 0.331 + 0.134 * m, 0.679 + 0.047 * m)
    b0 = params[..., C.Param.IFMR_INTERCEPT, None]
    b1 = params[..., C.Param.IFMR_SLOPE, None]
    d = m - IFMR_PIVOT
    if kind == "linear":
        return b0 + b1 * d
    if kind == "quadratic":
        b2 = params[..., C.Param.IFMR_QUADCOEF, None]
        return b0 + b1 * d + b2 * d * d
    raise ValueError(f"unknown IFMR kind: {kind}")


def default_ifmr_start() -> tuple[float, float, float]:
    """Tunable-IFMR starting coefficients (Weidemann's at the pivot)."""
    return (0.394 + 0.109 * IFMR_PIVOT, 0.109, 0.0)
