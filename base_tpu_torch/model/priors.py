"""Prior densities (port of base_tpu.model.priors): Gaussian cluster-
parameter priors and the lognormal IMF on primary mass."""
from __future__ import annotations

import dataclasses
import math

import torch

from base_tpu_torch import constants as C

LN10 = 2.302585092994046


@dataclasses.dataclass(frozen=True)
class ClusterPriors:
    """Per-parameter Gaussian priors.  sigma <= 0 means flat (improper)."""

    mean: torch.Tensor   # [NPARAMS]
    sigma: torch.Tensor  # [NPARAMS]

    def log_prior(self, params: torch.Tensor) -> torch.Tensor:
        """params [..., NPARAMS] -> [...]."""
        use = self.sigma > 0
        sig = torch.where(use, self.sigma, torch.ones_like(self.sigma))
        z = (params - self.mean) / sig
        terms = -0.5 * z * z - torch.log(sig) - 0.9189385332046727
        return torch.where(use, terms, torch.zeros_like(terms)).sum(-1)


def log_imf(mass: torch.Tensor) -> torch.Tensor:
    """Lognormal IMF density in mass: log10 M ~ N(mean, sigma^2), so
    p(M) includes the Jacobian 1/(M ln10)."""
    m = mass.clamp_min(1e-6)
    z = (torch.log10(m) - C.IMF_LOG_MEAN) / C.IMF_LOG_SIGMA
    return (
        -0.5 * z * z
        - math.log(C.IMF_LOG_SIGMA)
        - 0.9189385332046727
        - torch.log(m * LN10)
    )
