"""Bijective reparameterizations for gradient-based samplers (port of
base_tpu.utils.transforms): an affine sigmoid onto (lo, hi) per bounded
parameter, the identity for unbounded ones."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _sigmoid(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.tanh(0.5 * z) + 1.0)


class IntervalTransform(NamedTuple):
    """`bounded` is a {0,1} float mask selecting the sigmoid path, so the
    whole parameter vector takes one code path.  All methods act on the
    last axis and broadcast over leading (chain) axes."""

    lo: torch.Tensor       # [P]
    hi: torch.Tensor       # [P]
    bounded: torch.Tensor  # [P] float mask

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """Unconstrained z -> physical x."""
        s = _sigmoid(z).clamp(1e-7, 1.0 - 1e-7)
        x_b = self.lo + (self.hi - self.lo) * s
        return self.bounded * x_b + (1.0 - self.bounded) * z

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Physical x -> unconstrained z."""
        span = torch.where(self.bounded > 0, self.hi - self.lo,
                           torch.ones_like(self.hi))
        u = ((x - self.lo) / span).clamp(1e-7, 1.0 - 1e-7)
        z_b = torch.log(u) - torch.log1p(-u)
        return self.bounded * z_b + (1.0 - self.bounded) * x

    def log_det_jacobian(self, z: torch.Tensor) -> torch.Tensor:
        """sum_p log |dx_p/dz_p| at unconstrained z [..., P] -> [...]."""
        s = _sigmoid(z).clamp(1e-7, 1.0 - 1e-7)
        ld = torch.log(self.hi - self.lo + 1e-30) + torch.log(s) \
            + torch.log1p(-s)
        return (self.bounded * ld).sum(-1)


def make_interval_transform(lo, hi, *,
                            device: torch.device | str) -> IntervalTransform:
    """Build a transform from per-parameter (lo, hi); +-inf marks an
    unbounded side."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    bounded = (np.isfinite(lo) & np.isfinite(hi)).astype(np.float32)
    # Replace infinities so arithmetic on the unused path stays finite.
    lo = np.where(np.isfinite(lo), lo, 0.0).astype(np.float32)
    hi = np.where(np.isfinite(hi), hi, 1.0).astype(np.float32)
    return IntervalTransform(
        lo=torch.as_tensor(lo, device=device),
        hi=torch.as_tensor(hi, device=device),
        bounded=torch.as_tensor(bounded, device=device),
    )
