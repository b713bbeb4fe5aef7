"""Posterior assembly (port of base_tpu.model.posterior, MS-only).

`log_post(model, params [C, P]) -> [C]`: bounds check -> cluster prior ->
isochrone derive -> per-star marginal likelihoods -> field mixture, for a
batch of chains at once.  Samplers differentiate it with
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
from base_tpu_torch.model import likelihood as lk
from base_tpu_torch.model.priors import ClusterPriors
from base_tpu_torch.model.stardata import MSStars
from base_tpu_torch.ops.special import NEG_INF
from base_tpu_torch.utils.transforms import (
    IntervalTransform,
    make_interval_transform,
)


@dataclasses.dataclass(frozen=True)
class SinglePopModel:
    """Everything static for one single-population (MS-only) run.

    `use_pallas` means "use the kernels": the fused table build (with
    binaries) and the fused marginal, which launch the CUDA kernels on a
    CUDA model and run their plain versions on a CPU model.  A CUDA model
    requires it.  `upsample` inserts (upsample - 1) exact piecewise-linear
    nodes per EEP segment before marginalizing."""

    grid: IsochroneGrid
    stars: MSStars
    priors: ClusterPriors
    q_grid: torch.Tensor      # [Q] mass-ratio quadrature nodes
    abs_coefs: torch.Tensor   # [B] A_band / A_V
    binaries: bool = True
    uniform_q: bool = False
    use_pallas: bool = True
    upsample: int = 1

    def __post_init__(self):
        if self.grid.device.type == "cuda" and not self.use_pallas:
            raise ValueError("a CUDA model runs through the kernels: "
                             "use_pallas=False is for CPU tensors only")


def make_single_pop_model(
    grid: IsochroneGrid,
    stars: MSStars,
    prior_mean: np.ndarray,
    prior_sigma: np.ndarray,
    n_q: int = 16,
    binaries: bool = True,
    uniform_q: bool = False,
    use_pallas: bool = True,
    upsample: int = 1,
    *,
    device: torch.device | str,
) -> SinglePopModel:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SinglePopModel(
        grid=grid,
        stars=stars,
        priors=ClusterPriors(mean=t(prior_mean), sigma=t(prior_sigma)),
        q_grid=t(np.linspace(0.0, 1.0, n_q, dtype=np.float32)),
        abs_coefs=t(filt.absorption_coefs(grid.bands)),
        binaries=binaries,
        uniform_q=uniform_q,
        use_pallas=use_pallas,
        upsample=upsample,
    )


def log_lik(model: SinglePopModel, params: torch.Tensor):
    """Total per-star log likelihood [C] and the bounds flag [C]."""
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
    ll = lk.ms_total_loglik(model.stars, table, model.use_pallas)
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
    parameters; the WD-only dims are pinned in an MS-only run."""
    m = np.zeros(C.NPARAMS, np.float32)
    m[[C.Param.AGE, C.Param.YYY, C.Param.FEH, C.Param.MOD,
       C.Param.ABS]] = 1.0
    return tuple(float(v) for v in m)


def default_transform(model: SinglePopModel,
                      margin: float = 1e-3) -> IntervalTransform:
    """Unconstrained-space bijection with bounds from the grid hull.

    age/Y/FeH: grid extent (slightly shrunk); A_V in [0, 10];
    carbonicity in [0, 1]; modulus and IFMR coefficients unbounded.
    """
    g = model.grid
    lo = np.full(C.NPARAMS, -np.inf, np.float32)
    hi = np.full(C.NPARAMS, np.inf, np.float32)

    def span(ax):
        a0, a1 = float(ax[0]), float(ax[-1])
        d = (a1 - a0) * margin
        return a0 + d, a1 - d

    lo[C.Param.AGE], hi[C.Param.AGE] = span(g.age)
    lo[C.Param.YYY], hi[C.Param.YYY] = span(g.y)
    lo[C.Param.FEH], hi[C.Param.FEH] = span(g.feh)
    lo[C.Param.ABS], hi[C.Param.ABS] = 0.0, 10.0
    lo[C.Param.CARBONICITY], hi[C.Param.CARBONICITY] = 0.0, 1.0
    return make_interval_transform(lo, hi, device=g.device)


def make_logpost_z_fn(model: SinglePopModel, transform: IntervalTransform):
    """Unconstrained-space density for HMC: logpost(x(z)) + log|J|, with
    z [C, P] -> [C]."""

    def f(z: torch.Tensor) -> torch.Tensor:
        x = transform.forward(z)
        return log_post(model, x) + transform.log_det_jacobian(z)

    return f
