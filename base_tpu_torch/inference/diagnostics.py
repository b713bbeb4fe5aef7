"""Convergence diagnostics: split R-hat and ESS (port of
base_tpu.inference.diagnostics) over [N, C, P] sample stacks.

Split-R-hat and rank-normalization-free multi-chain ESS per Vehtari,
Gelman et al. 2021, with Geyer's initial-positive-sequence truncation of
the autocorrelation sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class ChainStats(NamedTuple):
    mean: torch.Tensor  # [C, P] per-chain mean
    var: torch.Tensor   # [C, P] per-chain (ddof=1) variance
    n: float            # draws per chain


def chain_stats(samples: torch.Tensor) -> ChainStats:
    """samples [N, C, P] -> per-chain sufficient statistics."""
    return ChainStats(mean=samples.mean(0),
                      var=samples.var(0, correction=1),
                      n=float(samples.shape[0]))


def rhat_from_stats(stats: ChainStats) -> torch.Tensor:
    """Gelman-Rubin potential-scale-reduction from per-chain stats. [P]"""
    n = stats.n
    w = stats.var.mean(0)                                  # within
    b = n * stats.mean.var(0, correction=1)                # between
    var_plus = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_plus / w.clamp_min(1e-30))


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split-R-hat over samples [N, C, P] (N truncated to even). [P]"""
    n = samples.shape[0] - (samples.shape[0] % 2)
    half = n // 2
    split = torch.cat([samples[:half], samples[half:n]], dim=1)
    return rhat_from_stats(chain_stats(split))


def _autocov(x: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance of x [N, ...] along axis 0 via FFT."""
    n = x.shape[0]
    xc = x - x.mean(0, keepdim=True)
    # Zero-pad to 2n for linear (non-circular) correlation.
    f = torch.fft.rfft(xc, n=2 * n, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=0)[:n]
    return acov / n


def ess(samples: torch.Tensor) -> torch.Tensor:
    """Effective sample size per parameter, pooled across chains. [P]

    Multi-chain rho_t from W, B and the per-chain autocovariances, summed
    in Geyer pairs while they stay positive, under a monotone envelope.
    """
    n, c, p = samples.shape
    acov = _autocov(samples).mean(1)                       # [N, P]
    w = samples.var(0, correction=1).mean(0)               # [P]
    if c > 1:
        b_over_n = samples.mean(0).var(0, correction=1)
    else:
        b_over_n = torch.zeros(p, device=samples.device)
    var_plus = (n - 1.0) / n * w + b_over_n
    rho = 1.0 - (w - acov) / var_plus.clamp_min(1e-30)     # [N, P]

    n_pairs = n // 2
    pairs = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]    # [n_pairs, P]
    # Keep pair k while every earlier pair (from k = 1) is positive.
    keep = torch.cumprod((pairs > 0.0).float(), dim=0)
    keep[0] = 1.0
    inf = torch.full_like(pairs, float("inf"))
    mono = torch.cummin(torch.where(keep > 0, pairs, inf), dim=0).values
    contrib = torch.where(keep > 0, mono.clamp_min(0.0),
                          torch.zeros_like(mono))
    tau = -1.0 + 2.0 * contrib.sum(0)                      # rho_0 twice
    tau = tau.clamp_min(1.0 / n)
    return (n * c) / tau


def summarize(samples: torch.Tensor, param_names=None) -> dict:
    """Host-side convenience: dict of mean/sd/rhat/ess numpy arrays [P]
    of samples [N, C, P]."""
    out = dict(
        mean=samples.mean((0, 1)).cpu().numpy(),
        sd=samples.std((0, 1), correction=0).cpu().numpy(),
        rhat=split_rhat(samples).cpu().numpy(),
        ess=ess(samples).cpu().numpy(),
    )
    if param_names is not None:
        out["names"] = list(param_names)
    return out
