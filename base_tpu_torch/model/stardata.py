"""Per-star observation containers (port of base_tpu.model.stardata).

Struct-of-arrays over S stars; unobserved bands (sigma <= 0) carry
1/s^2 = 0.  The photometry is data shared by every chain: no chain axis.
Star sets (`stack_ms_stars`) put a leading [G] axis on every field: G data
sets of equal padded S, as base_tpu stacks them to `vmap` over data sets;
the density then scores chain c on set c // (C // G).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

LOG_SQRT_2PI = 0.9189385332046727


@dataclasses.dataclass(frozen=True)
class MSStars:
    """Main-sequence/RGB stars, padded to a static S.

    obs_over_var [S, B] : o_b / s_b^2            (0 where unobserved)
    inv_var      [S, B] : 1 / s_b^2              (0 where unobserved)
    c0           [S]    : sum_b o_b^2 / s_b^2
    log_norm     [S]    : sum_obs_b (-log s_b - log sqrt(2 pi))
    log_cm       [S]    : log of cluster-membership prior weight
    log_1m_cm    [S]    : log(1 - membership prior)
    field_logdens[S]    : log uniform CMD density for the field component
    star_mask    [S]    : 1.0 for real stars, 0.0 for padding
    obs_mags     [S, B] : raw magnitudes
    obs_sigma    [S, B] : raw uncertainties (<=0 means unobserved)
    """

    obs_over_var: torch.Tensor
    inv_var: torch.Tensor
    c0: torch.Tensor
    log_norm: torch.Tensor
    log_cm: torch.Tensor
    log_1m_cm: torch.Tensor
    field_logdens: torch.Tensor
    star_mask: torch.Tensor
    obs_mags: torch.Tensor
    obs_sigma: torch.Tensor

    @property
    def n_stars(self) -> int:
        return self.obs_mags.shape[-2]

    @property
    def n_bands(self) -> int:
        return self.obs_mags.shape[-1]

    @property
    def stacked(self) -> bool:
        """True for star sets: every field has a leading [G] axis."""
        return self.obs_mags.ndim == 3

    @property
    def n_sets(self) -> int:
        """G, the star sets (1 for one set)."""
        return self.obs_mags.shape[0] if self.stacked else 1


def stack_ms_stars(sets: Sequence[MSStars]) -> MSStars:
    """G one-set containers of equal padded S (and B) as star sets: every
    field stacked on a new leading [G] axis."""
    if not sets or any(st.stacked for st in sets):
        raise ValueError("stack_ms_stars takes one or more one-set MSStars")
    shapes = {tuple(st.obs_mags.shape) for st in sets}
    if len(shapes) != 1:
        raise ValueError(f"star sets must share the padded [S, B]: got "
                         f"{sorted(shapes)}")
    return MSStars(**{f.name: torch.stack([getattr(st, f.name)
                                           for st in sets])
                      for f in dataclasses.fields(MSStars)})


def require_one_set(stars: MSStars | None, what: str) -> None:
    """Raise if `stars` are star sets: `what` takes one set."""
    if stars is not None and stars.stacked:
        raise ValueError(f"{what} takes one star set, got {stars.n_sets} "
                         f"stacked sets (star sets run only through the "
                         f"single-population MS density)")


def make_ms_stars(
    mags: np.ndarray,
    sigmas: np.ndarray,
    cm_prior: np.ndarray | float = 0.999,
    field_mag_range: np.ndarray | float = 20.0,
    pad_to: int | None = None,
    sigma_model: float = 0.0,
    *,
    device: torch.device | str,
) -> MSStars:
    """Build the MS-star container from raw photometry (host side).

    The field component is a uniform density over a CMD box of side
    `field_mag_range` mag in each observed band (scalar or [B]).
    sigma_model is a model-discretization floor added in quadrature to the
    observational uncertainties.  Pad rows carry log_cm = log_1m_cm = -1
    and obs_sigma = -9, as in base_tpu.
    """
    mags = np.asarray(mags, np.float32)
    sigmas = np.asarray(sigmas, np.float32)
    S, B = mags.shape
    cm = np.broadcast_to(np.asarray(cm_prior, np.float32), (S,)).copy()
    cm = np.clip(cm, 1e-6, 1.0 - 1e-6)

    observed = sigmas > 0
    sig_eff = np.sqrt(np.maximum(sigmas, 1e-12) ** 2 + sigma_model**2)
    sigmas_eff = np.where(observed, sig_eff, sigmas)
    inv_var = np.where(observed, 1.0 / sigmas_eff**2, 0.0)
    obs_over_var = np.where(observed, mags * inv_var, 0.0)
    c0 = (np.where(observed, mags**2 * inv_var, 0.0)).sum(-1)
    log_norm = np.where(
        observed, -np.log(np.maximum(sigmas_eff, 1e-12)) - LOG_SQRT_2PI, 0.0
    ).sum(-1)
    rng = np.broadcast_to(np.asarray(field_mag_range, np.float32), (B,))
    field_logdens = -np.where(observed, np.log(rng)[None, :], 0.0).sum(-1)

    if pad_to is None:
        pad_to = S
    P = max(pad_to - S, 0)

    def pad(x, val=0.0):
        w = [(0, P)] + [(0, 0)] * (x.ndim - 1)
        x = np.pad(x, w, constant_values=val)
        return torch.as_tensor(x.astype(np.float32), device=device)

    return MSStars(
        obs_over_var=pad(obs_over_var),
        inv_var=pad(inv_var),
        c0=pad(c0),
        log_norm=pad(log_norm),
        log_cm=pad(np.log(cm), val=-1.0),
        log_1m_cm=pad(np.log1p(-cm), val=-1.0),
        field_logdens=pad(field_logdens),
        star_mask=pad(np.ones(S, np.float32)),
        obs_mags=pad(mags),
        obs_sigma=pad(sigmas, val=-9.0),
    )
