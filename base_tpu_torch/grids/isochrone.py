"""Device-resident isochrone grids and EEP-aligned interpolation.

Port of base_tpu.grids.isochrone.  Every isochrone of the model family is
padded to a common EEP count E with a validity mask, so the family is five
dense tensors.  `derive_isochrone` blends the 2x2x2 (FeH, Y, logAge) corner
cell, EEP by EEP, for a whole batch of chains at once: the queries are [C]
and every field of the resulting `Isochrone` carries a leading chain axis.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from base_tpu_torch.ops import interp as iops

# Mass value assigned to padded (invalid) EEP slots; must exceed any real
# stellar mass and increase with slot index to keep lookups monotone.
PAD_MASS_BASE = 1.0e4


@dataclasses.dataclass(frozen=True)
class IsochroneGrid:
    """Packed MS/RGB model family.

    Axes: feh [F], y [Y], age [A] (monotone increasing, log10 yr for age).
    mass  [F, Y, A, E]    initial (ZAMS) mass at each EEP, Msun
    mags  [F, Y, A, E, B] absolute magnitudes per band
    valid [F, Y, A, E]    1.0 where the EEP exists for this isochrone
    agb_tip [F, Y, A]     mass at the AGB tip (upper end of the isochrone)
    """

    feh: torch.Tensor
    y: torch.Tensor
    age: torch.Tensor
    mass: torch.Tensor
    mags: torch.Tensor
    valid: torch.Tensor
    agb_tip: torch.Tensor
    bands: tuple[str, ...] = ()
    name: str = ""

    @property
    def n_eep(self) -> int:
        return self.mass.shape[-1]

    @property
    def n_bands(self) -> int:
        return self.mags.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.mass.device

    @functools.cached_property
    def corner_pack(self) -> torch.Tensor:
        """[F, Y, A, D] every payload derive_isochrone blends with one
        corner weight, built once per grid: mass [E], valid (the
        renormaliser) [E], agb_tip [1] and valid * mags [E * B]."""
        return torch.cat([self.mass, self.valid, self.agb_tip[..., None],
                          (self.valid[..., None] * self.mags).flatten(3)],
                         -1)


@dataclasses.dataclass(frozen=True)
class Isochrone:
    """Interpolated isochrones, one per chain, at (FeH, Y, logAge) [C].

    mass_sorted pads invalid EEPs with huge increasing masses so the 1-D
    mass -> mags lookup (secondaries, simulation) stays monotone.
    """

    mass: torch.Tensor         # [C, E]
    mags: torch.Tensor         # [C, E, B] absolute magnitudes
    valid: torch.Tensor        # [C, E] {0., 1.}
    agb_tip: torch.Tensor      # [C]
    in_bounds: torch.Tensor    # [C] bool
    mass_sorted: torch.Tensor  # [C, E] mass with pad slots pushed high
    min_mass: torch.Tensor     # [C] smallest valid mass on the isochrone

    def mags_at_mass(self, m: torch.Tensor, smooth: bool = True):
        """Absolute mags at ZAMS masses m [C, Q] -> [C, Q, B].

        smooth=True (smoothstep weights) is the likelihood's secondary
        lookup: C^1 in the parameters, so HMC sees no gradient kinks at
        node crossings.  The simulator passes smooth=False to draw single
        stars from exactly the piecewise-linear curve the segment-exact
        marginal integrates over.
        """
        return iops.interp1d_dense(self.mass_sorted, self.mags, m,
                                   smooth=smooth)


def _mass_sorted(mass: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """mass [C, E] with invalid slots replaced by huge increasing values."""
    e_idx = torch.arange(mass.shape[-1], dtype=mass.dtype,
                         device=mass.device)
    return torch.where(valid > 0.5, mass, PAD_MASS_BASE + e_idx)


def _window(axis: torch.Tensor, q: torch.Tensor):
    """(nodes [C, 3], hat weights [C, 3]) of the nodes idx - 1, idx, idx + 1
    around each query q [C], idx the lower node of its bracket: the nodes
    clamped into the axis, the weight 0 at a node off it.  Each weight is
    picked from hat_weight_matrix's row by a one-hot sum (one non-zero
    term, so exact), and its gradient flows back to it elementwise."""
    w = iops.hat_weight_matrix(axis, q[:, None])[:, 0]             # [C, n]
    n = axis.shape[0]
    idx = (iops.locate(axis, q).idx[:, None]
           + torch.arange(-1, 2, device=axis.device))              # [C, 3]
    pick = idx[:, :, None] == torch.arange(n, device=axis.device)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    wk = torch.where(pick, w[:, None, :], zero).sum(-1)
    return idx.clamp(0, n - 1), wk


def _corner_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the corner axis 1 of t [C, K, ...] in corner order, one
    elementwise add a corner, so that a row's sum is the same in any
    batch."""
    terms = t.unbind(1)
    out = terms[0]
    for term in terms[1:]:
        out = out + term
    return out


def derive_isochrone(grid: IsochroneGrid, feh: torch.Tensor,
                     y: torch.Tensor, age: torch.Tensor) -> Isochrone:
    """EEP-aligned 2x2x2 interpolation over (FeH, Y, logAge), queries [C].

    Per axis the boundary-clamped lerp weights are the hat basis at the
    query: non-zero only on the two bracketing nodes, so the blend is
    exactly the corner blend.  torch's clamp passes the gradient at its
    ends, so at an exact node hit the node below the bracket carries a
    derivative too; the blend therefore runs over the 3 x 3 x 3 window of
    nodes around the query, which holds every weight and every derivative
    of the dense hat-basis blend.  Its 27 corners are gathered and summed
    in a fixed order by elementwise operations: no library product, whose
    summation order can follow the number of chains, so each chain's row
    is the same in any batch.  A padded corner does not drag a valid EEP's
    magnitudes: mags are blended with weight w * valid and renormalised.
    """
    C = feh.shape[0]
    E = grid.n_eep
    fi, wf = _window(grid.feh, feh)
    yi, wy = _window(grid.y, y)
    ai, wa = _window(grid.age, age)
    inside = (
        (feh >= grid.feh[0]) & (feh <= grid.feh[-1])
        & (y >= grid.y[0]) & (y <= grid.y[-1])
        & (age >= grid.age[0]) & (age <= grid.age[-1])
    )
    w27 = (wf[:, :, None, None] * wy[:, None, :, None]
           * wa[:, None, None, :]).reshape(C, 27)
    at = grid.corner_pack[fi[:, :, None, None], yi[:, None, :, None],
                          ai[:, None, None, :]].reshape(C, 27, -1)
    blend = _corner_sum(w27[:, :, None] * at)              # [C, D]
    mass, wv = blend[:, :E], blend[:, E:2 * E]
    agb_tip = blend[:, 2 * E]
    mags_num = blend[:, 2 * E + 1:].reshape(C, E, -1)
    mags = mags_num / wv.clamp_min(1e-12)[..., None]
    # An EEP is valid only when EVERY corner of the bracketing cell is,
    # including zero-weight corners at exact node hits: the window's
    # corners 1 and 2 on each axis.
    cell = at.reshape(C, 3, 3, 3, -1)[:, 1:, 1:, 1:, E:2 * E]
    valid = 1.0 - torch.amax((1.0 - cell).reshape(C, 8, E), dim=1)

    mass_sorted = _mass_sorted(mass, valid)
    min_mass = torch.amin(
        torch.where(valid > 0.5, mass, torch.full_like(mass, PAD_MASS_BASE)),
        dim=-1,
    )
    return Isochrone(
        mass=mass, mags=mags, valid=valid, agb_tip=agb_tip,
        in_bounds=inside, mass_sorted=mass_sorted, min_mass=min_mass,
    )


def select_grid_bands(grid: IsochroneGrid, band_idx,
                      bands) -> IsochroneGrid:
    """Restrict the grid to a band subset (the grid side of the dynamic
    filter-set intersection: the .phot header ∩ the grid's bands)."""
    idx = torch.as_tensor(np.asarray(band_idx), device=grid.device)
    return dataclasses.replace(grid, mags=grid.mags[..., idx],
                               bands=tuple(bands))


def upsample_isochrone(iso: Isochrone, factor: int) -> Isochrone:
    """Insert `factor - 1` linearly-interpolated nodes per EEP segment.

    The model magnitudes are piecewise-linear in mass, so upsampling is
    exact: it only refines the mass-marginalization quadrature.
    """
    if factor <= 1:
        return iso
    C, E = iso.mass.shape
    t = torch.arange(factor, dtype=iso.mass.dtype,
                     device=iso.mass.device) / factor          # [R]

    def lerp(a):  # [C, E, ...] -> [C, (E-1)*R + 1, ...]
        lo = a[:, :-1].unsqueeze(2)
        hi = a[:, 1:].unsqueeze(2)
        tt = t.reshape((1, 1, factor) + (1,) * (a.ndim - 2))
        seg = lo * (1.0 - tt) + hi * tt                      # [C, E-1, R, ...]
        seg = seg.reshape((C, -1) + a.shape[2:])
        return torch.cat([seg, a[:, -1:]], dim=1)

    mass = lerp(iso.mass)
    mags = lerp(iso.mags)
    # A sub-node is valid only if both parent EEPs are (r > 0) or the left
    # parent is (r == 0).
    v_lo = iso.valid[:, :-1]
    both = torch.minimum(v_lo, iso.valid[:, 1:])
    seg_v = torch.cat(
        [v_lo[:, :, None], both[:, :, None].expand(C, E - 1, factor - 1)],
        dim=2,
    ).reshape(C, -1)
    valid = torch.cat([seg_v, iso.valid[:, -1:]], dim=1)
    return Isochrone(
        mass=mass, mags=mags, valid=valid, agb_tip=iso.agb_tip,
        in_bounds=iso.in_bounds, mass_sorted=_mass_sorted(mass, valid),
        min_mass=iso.min_mass,
    )


def pack_ragged(
    feh_axis: np.ndarray,
    y_axis: np.ndarray,
    age_axis: np.ndarray,
    isochrones: dict,
    bands: Sequence[str],
    *,
    device: torch.device | str,
    name: str = "",
) -> IsochroneGrid:
    """Pack a ragged {(fi, yi, ai): (mass[e], mags[e, B])} dict into dense
    tensors with validity masks on `device`.  Host-side, done once."""
    F, Y, A = len(feh_axis), len(y_axis), len(age_axis)
    E = max(v[0].shape[0] for v in isochrones.values())
    B = len(bands)
    mass = np.zeros((F, Y, A, E), np.float32)
    mags = np.zeros((F, Y, A, E, B), np.float32)
    valid = np.zeros((F, Y, A, E), np.float32)
    agb_tip = np.zeros((F, Y, A), np.float32)
    for (fi, yi, ai), (m, mg) in isochrones.items():
        n = m.shape[0]
        order = np.argsort(m, kind="stable")
        m, mg = m[order], mg[order]
        mass[fi, yi, ai, :n] = m
        mags[fi, yi, ai, :n] = mg
        valid[fi, yi, ai, :n] = 1.0
        agb_tip[fi, yi, ai] = m[-1]
        # Pad slots are masked at use sites; their values are irrelevant.
        mass[fi, yi, ai, n:] = m[-1]
        mags[fi, yi, ai, n:] = mg[-1]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return IsochroneGrid(
        feh=t(feh_axis), y=t(y_axis), age=t(age_axis), mass=t(mass),
        mags=t(mags), valid=t(valid), agb_tip=t(agb_tip),
        bands=tuple(bands), name=name,
    )
