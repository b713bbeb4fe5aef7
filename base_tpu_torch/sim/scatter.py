"""Photometric noise model (port of base_tpu.sim.scatter): magnitude-
dependent Gaussian uncertainties and detection cutoffs, with sigma < 0
marking an unobserved band as in the .phot convention.  Noise comes from
an explicit `torch.Generator`."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ScatteredCatalog(NamedTuple):
    mags: torch.Tensor    # [S, B] noisy apparent magnitudes
    sigmas: torch.Tensor  # [S, B]; <= 0 where unobserved


def sigma_model(mags: torch.Tensor, limit_mag=22.0,
                sigma_floor: float = 0.01) -> torch.Tensor:
    """sigma(m) = sigma_floor + exp(1.09 (m - limit)); `limit_mag` may be
    per band [B]."""
    return sigma_floor + torch.exp(1.09 * (mags - limit_mag))


def scatter_cluster(
    mags: torch.Tensor,
    gen: torch.Generator,
    limit_mag=22.0,
    bright_limit: float = -10.0,
    faint_limit: float = 30.0,
    sigma_floor: float = 0.01,
    relevant_filt: int | None = None,
    censor: bool = True,
) -> ScatteredCatalog:
    """Add noise and apply cutoffs.  A band is unobserved when its noisy
    magnitude exceeds its limit by > 1 mag; with `relevant_filt` the
    bright/faint limits cut on that band and blank the whole star, else
    band-wise.  censor=False keeps every band observed."""
    sig = sigma_model(mags, limit_mag, sigma_floor)
    noise = torch.randn(mags.shape, generator=gen, device=gen.device)
    noisy = mags + sig * noise.to(mags.device)
    if not censor:
        return ScatteredCatalog(mags=noisy, sigmas=sig)
    limit = torch.as_tensor(limit_mag, dtype=mags.dtype, device=mags.device)
    detected = noisy < (limit + 1.0)
    if relevant_filt is None:
        in_cut = (noisy > bright_limit) & (noisy < faint_limit)
    else:
        rf = noisy[:, relevant_filt]
        in_cut = ((rf > bright_limit) & (rf < faint_limit))[:, None]
    observed = detected & in_cut
    return ScatteredCatalog(
        mags=torch.where(observed, noisy, torch.full_like(noisy, 99.0)),
        sigmas=torch.where(observed, sig, torch.full_like(sig, -9.0)),
    )
