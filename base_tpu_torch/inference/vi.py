"""ADVI-style variational inference over the cluster log density (port
of base_tpu.inference.vi).

A Gaussian family in the unconstrained space of the samplers (mean-field
diagonal or full-rank Cholesky), fitted by maximizing the
reparameterized ELBO with Adam (`torch.optim.Adam`, the update of
`optax.adam`).  The density is the chain-batched `logpost_z(z [n_mc, P])
-> [n_mc]`, so one step is one batched density + gradient call.  VI
serves as a warm start for HMC: posterior-shaped initial points and a
dense metric.

The noise comes from an explicit `torch.Generator`, drawn up front as
`[n_steps, n_mc, P]`; `fit_vi` runs the Adam loop on given noise, so that
any source of draws (another framework's included) can drive it.

With `group` (the chain group of a mesh, parallel.run.run_vi_sharded)
every rank draws its own noise, and the ELBO and its gradient are
pmean-ed over the group's ranks before each Adam update, so the
variational parameters stay equal on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from base_tpu_torch.parallel.comm import pmean


@dataclasses.dataclass(frozen=True)
class VIConfig:
    n_steps: int = 1500
    n_mc: int = 16            # MC samples per ELBO gradient
    learning_rate: float = 2e-2
    full_rank: bool = False
    init_log_sd: float = -2.0


class VIResult(NamedTuple):
    mu: torch.Tensor          # [P]
    scale: torch.Tensor       # [P] (mean-field sd) or [P, P] (Cholesky)
    elbo_trace: torch.Tensor  # [n_steps]
    final_elbo: torch.Tensor


def _scale(s: torch.Tensor, full_rank: bool):
    """(scale, log of its diagonal [P]) from the free parameter: the
    log sd [P], or a [P, P] matrix whose strict lower triangle and
    softplus-positive diagonal form the Cholesky factor."""
    if full_rank:
        diag = F.softplus(torch.diagonal(s)) + 1e-6
        return torch.tril(s, -1) + torch.diag(diag), torch.log(diag)
    return torch.exp(s), s


def fit_vi(
    logpost_z: Callable[[torch.Tensor], torch.Tensor],
    init_mu: torch.Tensor,
    noise: torch.Tensor,
    cfg: VIConfig = VIConfig(),
    group=None,
) -> VIResult:
    """The Adam loop on given standard-normal noise [n_steps, n_mc, P],
    one step per leading row; gradient and ELBO pooled over `group`."""
    P = init_mu.shape[0]
    dev = init_mu.device
    mu = init_mu.detach().clone().requires_grad_(True)
    if cfg.full_rank:
        s0 = torch.diag(torch.full((P,), cfg.init_log_sd, device=dev))
    else:
        s0 = torch.full((P,), cfg.init_log_sd, device=dev)
    s = s0.requires_grad_(True)
    opt = torch.optim.Adam([mu, s], lr=cfg.learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    half_const = 0.5 * P * (1.0 + math.log(2.0 * math.pi))

    def step(eps: torch.Tensor) -> torch.Tensor:
        scale, log_diag = _scale(s, cfg.full_rank)
        if cfg.full_rank:
            z = mu[None, :] + eps @ scale.T
        else:
            z = mu[None, :] + eps * scale[None, :]
        elbo = logpost_z(z).mean() + log_diag.sum() + half_const
        opt.zero_grad()
        (-elbo).backward()
        if group is not None:
            for p in (mu, s):
                p.grad = pmean(p.grad, group)
        opt.step()
        return pmean(elbo.detach(), group)

    with torch.enable_grad():
        elbo_trace = torch.stack([step(eps) for eps in noise])
    with torch.no_grad():
        scale = _scale(s, cfg.full_rank)[0]
    return VIResult(mu=mu.detach(), scale=scale, elbo_trace=elbo_trace,
                    final_elbo=elbo_trace[-50:].mean())


def _noise(gen: torch.Generator, init_mu: torch.Tensor,
           cfg: VIConfig) -> torch.Tensor:
    return torch.randn((cfg.n_steps, cfg.n_mc, init_mu.shape[0]),
                       generator=gen, device=init_mu.device)


def run_vi(
    logpost_z: Callable[[torch.Tensor], torch.Tensor],
    init_mu: torch.Tensor,
    gen: torch.Generator,
    cfg: VIConfig = VIConfig(),
) -> VIResult:
    """Fit the Gaussian family from `init_mu` [P] with noise drawn from
    `gen` (on init_mu's device)."""
    return fit_vi(logpost_z, init_mu, _noise(gen, init_mu, cfg), cfg)


def run_vi_chunked(
    logpost_z: Callable[[torch.Tensor], torch.Tensor],
    init_mu: torch.Tensor,
    gen: torch.Generator,
    cfg: VIConfig = VIConfig(),
    chunk_steps: int = 200,
) -> VIResult:
    """base_tpu's chunked run_vi: on the GPU no limit on one execution
    forces chunks (see inference.driver), so `chunk_steps` is unused and
    this is run_vi."""
    return run_vi(logpost_z, init_mu, gen, cfg)


def posterior_covariance(res: VIResult) -> torch.Tensor:
    """Sigma of the fitted family: a warm-start HMC metric (inv_mass =
    posterior covariance)."""
    if res.scale.ndim == 2:
        return res.scale @ res.scale.T
    return torch.diag(res.scale * res.scale)


def sample_posterior(res: VIResult, gen: torch.Generator,
                     n: int) -> torch.Tensor:
    """n draws [n, P] from the fitted family (unconstrained space)."""
    eps = torch.randn((n, res.mu.shape[0]), generator=gen,
                      device=res.mu.device)
    if res.scale.ndim == 2:
        return res.mu[None, :] + eps @ res.scale.T
    return res.mu[None, :] + eps * res.scale[None, :]


WARM_START_CFG = VIConfig(n_steps=600, n_mc=8, full_rank=True,
                          learning_rate=2e-2, init_log_sd=-4.0)


def warm_start_draws(res: VIResult, z0: torch.Tensor, gen: torch.Generator,
                     n_chains: int, free_mask=None):
    """(init_z [n_chains, P], inv_mass0 [P, P]) of a fitted family: its
    draws from `gen` and its covariance, pinned dims (free_mask 0) at
    z0's value with a unit diagonal."""
    cov = posterior_covariance(res)
    draws = sample_posterior(res, gen, n_chains)
    if free_mask is not None:
        m = torch.as_tensor(free_mask, dtype=torch.float32, device=z0.device)
        cov = cov * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)
        draws = torch.where(m[None, :] > 0, draws, z0[None, :])
    return draws, cov


def vi_warm_start(
    logpost_z: Callable[[torch.Tensor], torch.Tensor],
    z0: torch.Tensor,
    gen: torch.Generator,
    n_chains: int,
    free_mask=None,
    cfg: VIConfig | None = None,
    chunk_steps: int = 100,
):
    """Full-rank-VI warm start for HMC: returns (init_z [n_chains, P],
    inv_mass0 [P, P], VIResult).

    VI lands the chains in the typical set and its covariance seeds the
    dense metric (driver runner `inv_mass0`).  Pinned dims (free_mask 0)
    keep z0's value in the draws and a unit diagonal in the metric, as
    hmc._window_update projects them.  The chains' draws follow the VI
    noise in `gen`'s stream."""
    res = run_vi_chunked(logpost_z, z0, gen, cfg or WARM_START_CFG,
                         chunk_steps)
    return (*warm_start_draws(res, z0, gen, n_chains, free_mask), res)
