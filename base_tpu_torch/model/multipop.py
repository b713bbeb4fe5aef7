"""Two-population (helium-spread) cluster model, the multiPopMcmc
equivalent (port of base_tpu.model.multipop), batched over chains.

The parameter vector grows to 12: the nine shared slots (the Y slot
unused) plus Y_A, Y_B and lambda.  Each star's marginal likelihood is the
lambda-weighted mixture of its marginals under the two populations,
taken before the field-star mixture; the population indicator is
marginalised, so the density stays differentiable.

Both populations go through one pass of the density: the chain axis is
doubled, rows :C at Y_A and rows C: at Y_B, so one isochrone derivation,
one table build and one marginal (one launch of each of kernels 1-4 on a
CUDA model) serve both.  Every operation of the pass is per chain row, so
the folded rows equal two single-population passes.  Y_A < Y_B is
enforced by `ordered_transform`, not by the density.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from base_tpu_torch import constants as C
from base_tpu_torch.model import likelihood as lk
from base_tpu_torch.model import wd as wd_mod
from base_tpu_torch.model.posterior import (
    ClusterModel,
    make_model,
    ms_table,
    param_bounds,
)
from base_tpu_torch.model.stardata import require_one_set
from base_tpu_torch.ops.special import NEG_INF
from base_tpu_torch.utils.transforms import (
    IntervalTransform,
    _sigmoid,
    make_interval_transform,
)

NPARAMS_MP = 12
MP_YYA = 9
MP_YYB = 10
MP_LAMBDA = 11

MP_PARAM_NAMES = C.PARAM_NAMES + ("Y_A", "Y_B", "lambda")


@dataclasses.dataclass(frozen=True)
class MultiPopModel(ClusterModel):
    """Two-population model state: priors over the 12-vector.  The WD
    branch is optional, as in SinglePopModel: WD stars evaluate against
    both populations' precursor chains and mix with the same lambda.  It
    takes one star set."""

    def __post_init__(self):
        super().__post_init__()
        require_one_set(self.stars, "the two-population model")


def make_multipop_model(*args, device: torch.device | str,
                        **kwargs) -> MultiPopModel:
    """posterior.make_model's arguments (prior_mean and prior_sigma [12]),
    for two populations."""
    return make_model(MultiPopModel, *args, device=device, **kwargs)


def population_params(params: torch.Tensor) -> torch.Tensor:
    """The folded 9-vectors [2C, 9] of 12-vectors [C, 12]: rows :C with
    the Y slot at Y_A, rows C: at Y_B."""
    p9 = params[:, :C.NPARAMS]
    head, tail = p9[:, :C.Param.YYY], p9[:, C.Param.YYY + 1:]
    return torch.cat([
        torch.cat([head, params[:, MP_YYA, None], tail], dim=1),
        torch.cat([head, params[:, MP_YYB, None], tail], dim=1),
    ])


def population_marginals(model: MultiPopModel, p2: torch.Tensor):
    """Per-star log marginals of the MS stars, each row normalised by its
    own mass prior (each population has its own hull), and the bounds
    flag: ([R, S], [R]) for 9-vectors p2 [R, 9]."""
    table, iso = ms_table(model, p2)
    lm = (lk.ms_log_marginals(model.stars, table, model.use_pallas)
          - lk.mass_prior_log_norm(table)[:, None])
    return lm, iso.in_bounds


def _lambda_mix(lam_c: torch.Tensor, la: torch.Tensor,
                lb: torch.Tensor) -> torch.Tensor:
    """Per-star log of lam exp(la) + (1 - lam) exp(lb); lam_c [C], la and
    lb [C, S]."""
    a = torch.log(lam_c)[:, None] + la
    b = torch.log1p(-lam_c)[:, None] + lb
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def log_lik(model: MultiPopModel, params: torch.Tensor):
    """Total per-star log likelihood [C] and the bounds flag [C] of
    12-vectors [C, 12], with both populations in one pass."""
    Cn = params.shape[0]
    lam = params[:, MP_LAMBDA]
    p2 = population_params(params)
    lm, in_bounds = population_marginals(model, p2)
    lam_c = lam.clamp(1e-6, 1.0 - 1e-6)
    ll = lk.field_mixture_total(model.stars,
                                _lambda_mix(lam_c, lm[:Cn], lm[Cn:]))

    if model.wd_stars is not None:
        # Each population's helium changes the precursor lifetimes; the
        # per-WD marginals mix with the same lambda before the field
        # mixture.
        mags, _, valid = wd_mod.wd_model_mags(
            model.grid, model.wd_cooling, model.wd_atm, p2, model.mz_grid,
            model.ifmr_kind)
        wm = wd_mod.wd_star_log_marginals(
            model.wd_stars, mags, valid, model.mz_grid, p2[:, C.Param.MOD],
            p2[:, C.Param.ABS], model.abs_coefs, model.p_db,
            model.use_pallas)
        ll = ll + lk.field_mixture_total(
            model.wd_stars, _lambda_mix(lam_c, wm[:Cn], wm[Cn:]))

    ok = in_bounds[:Cn] & in_bounds[Cn:] & (lam > 0.0) & (lam < 1.0)
    return ll, ok


def log_post(model: MultiPopModel, params: torch.Tensor) -> torch.Tensor:
    """Un-normalized log posterior of 12-vectors [C, 12] -> [C]."""
    ll, ok = log_lik(model, params)
    lp = model.priors.log_prior(params)
    return torch.where(ok, ll + lp, torch.full_like(lp, NEG_INF))


def make_logpost_fn(model: MultiPopModel):
    def f(params: torch.Tensor) -> torch.Tensor:
        return log_post(model, params)

    return f


def free_mask(model: MultiPopModel) -> tuple:
    """Sampled-parameter mask: the YYY slot is structurally unused, and
    carbonicity and the IFMR slots only matter with a WD branch."""
    m = np.zeros(NPARAMS_MP, np.float32)
    m[[C.Param.AGE, C.Param.FEH, C.Param.MOD, C.Param.ABS]] = 1.0
    m[[MP_YYA, MP_YYB, MP_LAMBDA]] = 1.0
    if model.wd_stars is not None:
        m[C.Param.CARBONICITY] = 1.0
        if model.ifmr_kind in ("linear", "quadratic"):
            m[[C.Param.IFMR_INTERCEPT, C.Param.IFMR_SLOPE]] = 1.0
        if model.ifmr_kind == "quadratic":
            m[C.Param.IFMR_QUADCOEF] = 1.0
    return tuple(float(v) for v in m)


def _mp_bounds(model: MultiPopModel, margin: float):
    """The cluster slots' bounds, Y_A and Y_B each on the Y slot's span
    (the slot itself unused, kept sane) and lambda in [0, 1]."""
    lo, hi = param_bounds(model.grid, NPARAMS_MP, margin)
    lo[[MP_YYA, MP_YYB]] = lo[C.Param.YYY]
    hi[[MP_YYA, MP_YYB]] = hi[C.Param.YYY]
    lo[MP_LAMBDA], hi[MP_LAMBDA] = 0.0, 1.0
    return lo, hi


def default_transform(model: MultiPopModel,
                      margin: float = 1e-3) -> IntervalTransform:
    """12-vector interval transform; Y_A and Y_B each bounded by the
    grid's Y hull (label-symmetric; see ordered_transform for the
    identifiable parameterization)."""
    lo, hi = _mp_bounds(model, margin)
    return make_interval_transform(lo, hi, device=model.grid.device)


def _set_yb(x: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """x with its Y_B slot replaced, out of place."""
    return torch.cat([x[..., :MP_YYB], yb[..., None], x[..., MP_YYB + 1:]],
                     dim=-1)


class OrderedMPTransform(NamedTuple):
    """Interval transform with Y_A < Y_B built into the bijection: Y_B =
    Y_A + (y_hi - Y_A) sigmoid(z_B), so the sampler explores (Y_A, dY > 0)
    and the label-switching mode of the mixture is cut away.

    The Jacobian dx/dz is lower-triangular (Y_B depends on z_A and z_B),
    so its log-determinant is the sum of the diagonal terms: the base
    terms for every slot but Y_B, plus log((y_hi - Y_A) s (1 - s))."""

    base: IntervalTransform   # Y_B slot unbounded (identity)
    y_hi: float

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.base.forward(z)
        ya = x[..., MP_YYA]
        s = _sigmoid(z[..., MP_YYB]).clamp(1e-7, 1.0 - 1e-7)
        return _set_yb(x, ya + (self.y_hi - ya) * s)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        z = self.base.inverse(x)
        ya = x[..., MP_YYA]
        u = (x[..., MP_YYB] - ya) / (self.y_hi - ya).clamp_min(1e-12)
        u = u.clamp(1e-7, 1.0 - 1e-7)
        return _set_yb(z, torch.log(u) - torch.log1p(-u))

    def log_det_jacobian(self, z: torch.Tensor) -> torch.Tensor:
        ld = self.base.log_det_jacobian(z)
        ya = self.base.forward(z)[..., MP_YYA]
        s = _sigmoid(z[..., MP_YYB]).clamp(1e-7, 1.0 - 1e-7)
        return ld + (torch.log((self.y_hi - ya).clamp_min(1e-30))
                     + torch.log(s) + torch.log1p(-s))


def ordered_transform(model: MultiPopModel,
                      margin: float = 1e-3) -> OrderedMPTransform:
    """The identifiable (Y_A, Y_B) parameterization: Y_A on the grid's Y
    hull, Y_B constrained to (Y_A, y_hi)."""
    lo, hi = _mp_bounds(model, margin)
    y_hi = float(hi[MP_YYB])
    lo[MP_YYB], hi[MP_YYB] = -np.inf, np.inf   # handled by the wrapper
    return OrderedMPTransform(
        base=make_interval_transform(lo, hi, device=model.grid.device),
        y_hi=y_hi)


def make_logpost_z_fn(model: MultiPopModel, transform):
    """Unconstrained-space density logpost(x(z)) + log|J|, z [C, 12] ->
    [C]."""

    def f(z: torch.Tensor) -> torch.Tensor:
        x = transform.forward(z)
        return log_post(model, x) + transform.log_det_jacobian(z)

    return f
