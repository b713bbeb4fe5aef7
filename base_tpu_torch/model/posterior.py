"""Posterior assembly (port of base_tpu.model.posterior).

`log_post(model, params [C, P]) -> [C]`: bounds check -> cluster prior ->
isochrone derive -> per-star marginal likelihoods (MS stars, and WD stars
when the model has a WD branch) -> field mixture, for a batch of chains at
once.  Samplers differentiate it with
`torch.autograd.grad(lp.sum(), z)`, valid because the chains are
independent.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from base_tpu_torch import constants as C
from base_tpu_torch.grids import filters as filt
from base_tpu_torch.grids.isochrone import (
    IsochroneGrid,
    derive_isochrone,
    upsample_isochrone,
)
from base_tpu_torch.grids.wd_atmosphere import WdAtmosphereGrid
from base_tpu_torch.grids.wd_cooling import WdCoolingGrid
from base_tpu_torch.model import likelihood as lk
from base_tpu_torch.model import wd as wd_mod
from base_tpu_torch.model.priors import ClusterPriors
from base_tpu_torch.model.stardata import MSStars
from base_tpu_torch.ops.special import NEG_INF
from base_tpu_torch.utils.transforms import (
    IntervalTransform,
    make_interval_transform,
)


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """Everything static for one run, single- or multi-population.

    The WD branch is optional: with `wd_stars` None the density is
    MS-only; with the WD fields set, log_post adds the precursor-mass
    marginalised WD likelihood (model.wd).  `use_pallas` means "use the
    kernels": the fused table build (with binaries) and the fused marginal
    (MS and WD), which launch the CUDA kernels on a CUDA model and run
    their plain versions on a CPU model.  A CUDA model requires it.  `upsample` inserts (upsample - 1) exact piecewise-linear
    nodes per EEP segment before marginalizing."""

    grid: IsochroneGrid
    stars: MSStars
    priors: ClusterPriors
    q_grid: torch.Tensor      # [Q] mass-ratio quadrature nodes
    abs_coefs: torch.Tensor   # [B] A_band / A_V
    wd_cooling: WdCoolingGrid | None = None
    wd_atm: WdAtmosphereGrid | None = None
    wd_stars: MSStars | None = None
    mz_grid: torch.Tensor | None = None   # [K] precursor-mass nodes
    ifmr_kind: str = "linear"
    p_db: float = 0.1
    binaries: bool = True
    uniform_q: bool = False
    use_pallas: bool = True
    upsample: int = 1

    def __post_init__(self):
        if self.grid.device.type == "cuda" and not self.use_pallas:
            raise ValueError("a CUDA model runs through the kernels: "
                             "use_pallas=False is for CPU tensors only")


@dataclasses.dataclass(frozen=True)
class SinglePopModel(ClusterModel):
    """One population: priors over the 9-parameter cluster vector."""


def make_model(
    cls: type,
    grid: IsochroneGrid,
    stars: MSStars,
    prior_mean: np.ndarray,
    prior_sigma: np.ndarray,
    n_q: int = 16,
    binaries: bool = True,
    uniform_q: bool = False,
    wd_cooling: WdCoolingGrid | None = None,
    wd_atm: WdAtmosphereGrid | None = None,
    wd_stars: MSStars | None = None,
    n_mz: int = 96,
    ifmr_kind: str = "linear",
    p_db: float = 0.1,
    use_pallas: bool = True,
    upsample: int = 1,
    *,
    device: torch.device | str,
) -> ClusterModel:
    """A model of class `cls` (a ClusterModel) with base_tpu's q and
    precursor-mass grids and the grid's extinction coefficients."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mz_grid = None
    if wd_stars is not None:
        if wd_cooling is None or wd_atm is None:
            raise ValueError("wd_stars requires wd_cooling and wd_atm grids")
        mz_grid = t(np.linspace(0.8, C.MAX_WD_PRECURSOR_MASS, n_mz,
                                dtype=np.float32))
    return cls(
        grid=grid,
        stars=stars,
        priors=ClusterPriors(mean=t(prior_mean), sigma=t(prior_sigma)),
        q_grid=t(np.linspace(0.0, 1.0, n_q, dtype=np.float32)),
        abs_coefs=t(filt.absorption_coefs(grid.bands)),
        wd_cooling=wd_cooling,
        wd_atm=wd_atm,
        wd_stars=wd_stars,
        mz_grid=mz_grid,
        ifmr_kind=ifmr_kind,
        p_db=p_db,
        binaries=binaries,
        uniform_q=uniform_q,
        use_pallas=use_pallas,
        upsample=upsample,
    )


def make_single_pop_model(*args, device: torch.device | str,
                          **kwargs) -> SinglePopModel:
    """make_model's arguments, for one population."""
    return make_model(SinglePopModel, *args, device=device, **kwargs)


def ms_table(model: ClusterModel, params: torch.Tensor):
    """The MS segment table of 9-vectors params [R, 9] and the isochrone
    it was built from: one derive_isochrone, one upsample and one table
    build (the fused one with binaries and use_pallas) for every row."""
    age = params[:, C.Param.AGE]
    y = params[:, C.Param.YYY]
    feh = params[:, C.Param.FEH]
    mod = params[:, C.Param.MOD]
    av = params[:, C.Param.ABS]

    base_iso = derive_isochrone(model.grid, feh, y, age)
    iso = upsample_isochrone(base_iso, model.upsample)
    # The secondary lookup stays on the BASE node set, so upsampling
    # refines the quadrature without changing the continuous model.
    if model.use_pallas and model.binaries:
        table = lk.build_segment_table_fused(
            iso, model.q_grid, mod, av, model.abs_coefs,
            uniform_q=model.uniform_q, sec_iso=base_iso,
        )
    else:
        table = lk.build_segment_table(
            iso, model.q_grid, mod, av, model.abs_coefs,
            binaries=model.binaries, uniform_q=model.uniform_q,
            sec_iso=base_iso,
        )
    return table, iso


def log_lik(model: SinglePopModel, params: torch.Tensor):
    """Total per-star log likelihood [C] and the bounds flag [C]."""
    table, iso = ms_table(model, params)
    ll = lk.ms_total_loglik(model.stars, table, model.use_pallas)
    if model.wd_stars is not None:
        mags, _, valid = wd_mod.wd_model_mags(
            model.grid, model.wd_cooling, model.wd_atm, params,
            model.mz_grid, model.ifmr_kind)
        ll = ll + wd_mod.wd_total_loglik(
            model.wd_stars, mags, valid, model.mz_grid,
            params[:, C.Param.MOD], params[:, C.Param.ABS],
            model.abs_coefs, model.p_db, model.use_pallas)
    return ll, iso.in_bounds


def log_post(model: SinglePopModel, params: torch.Tensor) -> torch.Tensor:
    """Un-normalized log posterior of the 9-parameter cluster vectors
    [C, 9] -> [C].  Out-of-hull (age, Y, FeH) returns NEG_INF; gradient
    samplers avoid the cliff by sampling through `default_transform`."""
    ll, in_bounds = log_lik(model, params)
    lp = model.priors.log_prior(params)
    return torch.where(in_bounds, ll + lp, torch.full_like(lp, NEG_INF))


def free_mask(model: SinglePopModel) -> tuple:
    """Sampled-parameter mask for HMCConfig.free_mask: the five cluster
    parameters, plus carbonicity and the tunable IFMR coefficients with a
    WD branch (the quadratic coefficient only for ifmr_kind 'quadratic');
    density-flat dims are pinned."""
    m = np.zeros(C.NPARAMS, np.float32)
    m[[C.Param.AGE, C.Param.YYY, C.Param.FEH, C.Param.MOD,
       C.Param.ABS]] = 1.0
    if model.wd_stars is not None:
        m[C.Param.CARBONICITY] = 1.0
        if model.ifmr_kind in ("linear", "quadratic"):
            m[C.Param.IFMR_INTERCEPT] = 1.0
            m[C.Param.IFMR_SLOPE] = 1.0
        if model.ifmr_kind == "quadratic":
            m[C.Param.IFMR_QUADCOEF] = 1.0
    return tuple(float(v) for v in m)


def param_bounds(grid: IsochroneGrid, n_params: int, margin: float):
    """(lo, hi) [n_params] of the nine cluster slots: age/Y/FeH on the
    grid extent (shrunk by `margin` of it), A_V in [0, 10], carbonicity in
    [0, 1]; modulus, the IFMR coefficients and any further slot
    unbounded."""
    lo = np.full(n_params, -np.inf, np.float32)
    hi = np.full(n_params, np.inf, np.float32)

    def span(ax):
        a0, a1 = float(ax[0]), float(ax[-1])
        d = (a1 - a0) * margin
        return a0 + d, a1 - d

    lo[C.Param.AGE], hi[C.Param.AGE] = span(grid.age)
    lo[C.Param.YYY], hi[C.Param.YYY] = span(grid.y)
    lo[C.Param.FEH], hi[C.Param.FEH] = span(grid.feh)
    lo[C.Param.ABS], hi[C.Param.ABS] = 0.0, 10.0
    lo[C.Param.CARBONICITY], hi[C.Param.CARBONICITY] = 0.0, 1.0
    return lo, hi


def default_transform(model: SinglePopModel,
                      margin: float = 1e-3) -> IntervalTransform:
    """Unconstrained-space bijection with bounds from the grid hull
    (param_bounds)."""
    lo, hi = param_bounds(model.grid, C.NPARAMS, margin)
    return make_interval_transform(lo, hi, device=model.grid.device)


def make_logpost_fn(model: SinglePopModel):
    """The density of 9-vectors, params [C, 9] -> [C]: the reference-parity
    samplers' (MH) target."""

    def f(params: torch.Tensor) -> torch.Tensor:
        return log_post(model, params)

    return f


def make_logpost_z_fn(model: SinglePopModel, transform: IntervalTransform):
    """Unconstrained-space density for HMC: logpost(x(z)) + log|J|, with
    z [C, P] -> [C]."""

    def f(z: torch.Tensor) -> torch.Tensor:
        x = transform.forward(z)
        return log_post(model, x) + transform.log_det_jacobian(z)

    return f
