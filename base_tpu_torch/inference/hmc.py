"""HMC with dual-averaging step size and cross-chain mass adaptation
(port of base_tpu.inference.hmc).

The chain axis is written out: every state tensor has a leading axis C and
one call of the density evaluates all chains, `[C, P] -> [C]`.  The
leapfrog is a Python loop over `l_max` steps on that batch, and gradients
come from `torch.autograd.grad(lp.sum(), z)`, valid because the chains are
independent.  Warmup runs in windows: per-chain Nesterov dual averaging
toward the target acceptance, and between windows a (dense or diagonal)
mass matrix re-estimated from the samples POOLED over chains.  Randomness
comes from one explicit `torch.Generator` whose stream the functions
consume in a fixed order, so the chunked runner and `run_hmc` agree bit
for bit under one seed.

- `group`: when the chains are sharded over ranks (parallel.run), the
  chain group of the mesh (base_tpu's `axis_name`).  The warmup's pooled
  moments and the frozen step size are then reduced over it
  (parallel.comm), so every chain shard adapts the same metric and step
  size; with group None nothing is reduced across ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from base_tpu_torch.ops.special import NEG_INF
from base_tpu_torch.parallel.comm import pmean, psum


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    n_warmup: int = 500
    n_samples: int = 1000
    thin: int = 1
    l_max: int = 24              # max leapfrog steps per trajectory
    target_accept: float = 0.8
    init_step: float = 0.05
    n_windows: int = 4           # mass-matrix re-estimation points
    # Trajectory randomization (breaks periodic-orbit resonances):
    #   "length": n_steps ~ U(0.5, 1) * l_max (all l_max steps computed,
    #             each chain keeps its state at its own n_steps);
    #   "step":   all l_max steps used, eps scaled by U(0.8, 1.2) per
    #             trajectory;
    #   "none":   fixed length and step.
    jitter_mode: str = "length"  # length | step | none
    dense_mass: bool = False     # full [P,P] mass matrix (pooled covariance)
    # Pinned parameters: 1.0 = sampled, 0.0 = frozen.
    free_mask: tuple | None = None

    def __post_init__(self):
        if self.jitter_mode not in ("length", "step", "none"):
            raise ValueError(
                f"jitter_mode must be 'length', 'step' or 'none' "
                f"(got {self.jitter_mode!r})"
            )

    def mask_array(self, P: int, device) -> torch.Tensor:
        if self.free_mask is None:
            return torch.ones(P, device=device)
        return torch.as_tensor(self.free_mask, dtype=torch.float32,
                               device=device)


class DAState(NamedTuple):
    """Nesterov dual-averaging state for log step size, one per chain."""

    log_eps: torch.Tensor      # [C]
    log_eps_avg: torch.Tensor  # [C]
    h_avg: torch.Tensor        # [C]
    mu: torch.Tensor           # [C]
    count: torch.Tensor        # [C]


def da_init(eps0: float, C: int, device) -> DAState:
    le = torch.full((C,), math.log(eps0), device=device)
    return DAState(
        log_eps=le,
        log_eps_avg=le.clone(),
        h_avg=torch.zeros(C, device=device),
        mu=math.log(10.0) + le,
        count=torch.zeros(C, device=device),
    )


def da_update(s: DAState, accept_prob: torch.Tensor,
              target: float) -> DAState:
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = s.count + 1.0
    h_avg = (1.0 - 1.0 / (count + t0)) * s.h_avg + (
        target - accept_prob
    ) / (count + t0)
    log_eps = s.mu - torch.sqrt(count) / gamma * h_avg
    w = count ** (-kappa)
    log_eps_avg = w * log_eps + (1.0 - w) * s.log_eps_avg
    return DAState(log_eps, log_eps_avg, h_avg, s.mu, count)


# --- Mass-matrix helpers ------------------------------------------------------
# `inv_mass` is the estimated posterior covariance Sigma = M^{-1}, shared by
# all chains: a [P] vector (diagonal metric) or a [P, P] matrix (dense).


def _mass_matvec(inv_mass: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sigma @ p for every chain's momentum p [C, P]."""
    if inv_mass.ndim == 1:
        return inv_mass * p
    return p @ inv_mass.T


def _kinetic(inv_mass: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """K(p) = 0.5 p^T Sigma p, per chain [C]."""
    return 0.5 * (p * _mass_matvec(inv_mass, p)).sum(-1)


def _metric_chol(inv_mass: torch.Tensor) -> torch.Tensor:
    """sqrt(Sigma) (diag) or cholesky(Sigma) (dense), computed once per
    metric and passed into the transitions."""
    if inv_mass.ndim == 1:
        return torch.sqrt(inv_mass)
    return torch.linalg.cholesky(inv_mass)


def _sample_momentum(gen: torch.Generator, chol: torch.Tensor, C: int,
                     P: int) -> torch.Tensor:
    """p ~ N(0, M) per chain [C, P], M = Sigma^{-1}, chol = factor(Sigma).
    Dense: Sigma = L L^T, so p = L^{-T} xi has Var(p) = M."""
    xi = torch.randn(C, P, generator=gen, device=chol.device)
    if chol.ndim == 1:
        return xi / chol
    return torch.linalg.solve_triangular(chol.T, xi.T, upper=True).T


class HMCChainState(NamedTuple):
    z: torch.Tensor        # [C, P] unconstrained position
    logpost: torch.Tensor  # [C]
    grad: torch.Tensor     # [C, P] cached gradient at z
    da: DAState


def value_and_grad(logpost_fn: Callable) -> Callable:
    """z [C, P] -> (logpost [C], d logpost / dz [C, P]), both detached."""

    def vg(z: torch.Tensor):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            lp = logpost_fn(zz)
            (g,) = torch.autograd.grad(lp.sum(), zz)
        return lp.detach(), g

    return vg


def _leapfrog(vgrad, z, p, grad, eps, inv_mass, n_steps, l_max, mask):
    """l_max leapfrog steps on every chain; returns each chain's state
    after its own n_steps [C] (<= l_max), or after l_max steps when
    n_steps is None.  Pinned dims (mask 0) get zero gradient, so with zero
    momentum they never move."""
    grad = grad * mask
    e = eps[:, None]
    for i in range(l_max):
        p_half = p + 0.5 * e * grad
        z = z + e * _mass_matvec(inv_mass, p_half)
        lp, grad = vgrad(z)
        grad = grad * mask
        p = p_half + 0.5 * e * grad
        if i == 0 or n_steps is None:
            out = (z, p, lp, grad)
        else:
            sel = (n_steps == i + 1)
            out = (
                torch.where(sel[:, None], z, out[0]),
                torch.where(sel[:, None], p, out[1]),
                torch.where(sel, lp, out[2]),
                torch.where(sel[:, None], grad, out[3]),
            )
    return out


def hmc_transition(
    vgrad: Callable,
    state: HMCChainState,
    eps: torch.Tensor,
    inv_mass: torch.Tensor,
    cfg: HMCConfig,
    gen: torch.Generator,
    chol: torch.Tensor | None = None,
) -> tuple[HMCChainState, torch.Tensor]:
    """One HMC proposal + MH correction for every chain; eps is [C] or a
    scalar.  Returns (state, accept_prob [C]).  Draws, in order: momenta
    [C, P], the jitter [C] (unless mode "none"), the accept uniforms [C]."""
    C, P = state.z.shape
    dev = state.z.device
    mask = cfg.mask_array(P, dev)
    if chol is None:
        chol = _metric_chol(inv_mass)
    eps = torch.broadcast_to(torch.as_tensor(eps, device=dev), (C,))
    p0 = _sample_momentum(gen, chol, C, P) * mask
    n_steps = None  # every chain runs all l_max steps
    if cfg.jitter_mode == "length":
        u = 0.5 + 0.5 * torch.rand(C, generator=gen, device=dev)
        n_steps = torch.ceil(u * cfg.l_max).to(torch.int32)
    elif cfg.jitter_mode == "step":
        eps = eps * (0.8 + 0.4 * torch.rand(C, generator=gen, device=dev))
    z1, p1, lp1, g1 = _leapfrog(vgrad, state.z, p0, state.grad, eps,
                                inv_mass, n_steps, cfg.l_max, mask)
    ke0 = _kinetic(inv_mass, p0)
    ke1 = _kinetic(inv_mass, p1)
    log_ratio = (lp1 - ke1) - (state.logpost - ke0)
    log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio,
                            torch.full_like(log_ratio, -math.inf))
    accept_prob = torch.exp(log_ratio.clamp(max=0.0)).clamp(max=1.0)
    u_acc = torch.rand(C, generator=gen, device=dev)
    accept = (torch.log(u_acc) < log_ratio) & (lp1 > NEG_INF / 2)
    new = HMCChainState(
        z=torch.where(accept[:, None], z1, state.z),
        logpost=torch.where(accept, lp1, state.logpost),
        grad=torch.where(accept[:, None], g1, state.grad),
        da=state.da,
    )
    return new, accept_prob


def _count(flat: torch.Tensor, group) -> float:
    """The number of rows of flat [n, P] over the group's ranks."""
    n = float(flat.shape[0])
    if group is None:
        return n
    return float(psum(flat.new_tensor(n), group))


def _pooled_mean_var(zs: torch.Tensor, group=None):
    """Mean/variance of zs [..., P] pooled over all leading axes and, with
    a group, over its ranks (sums psum-ed)."""
    flat = zs.reshape(-1, zs.shape[-1])
    n = _count(flat, group)
    mean = psum(flat.sum(0), group) / n
    var = psum((flat * flat).sum(0), group) / n - mean * mean
    return mean, var.clamp_min(0.0)


def _pooled_cov(zs: torch.Tensor, group=None) -> torch.Tensor:
    """Full covariance of zs [..., P] pooled over all leading axes and,
    with a group, over its ranks.

    Centered two-pass form (the one-pass E[xx^T] - mu mu^T cancels
    catastrophically in float32 for parameters with large mean and small
    posterior sd): the mean is pooled first (one [P] psum), then the
    second moment of the centered samples (one [P, P] psum); with
    Stan-style shrinkage toward a scaled identity."""
    P = zs.shape[-1]
    flat = zs.reshape(-1, P)
    n = _count(flat, group)
    mean = psum(flat.sum(0), group) / n
    c = flat - mean[None, :]
    cov = psum(c.T @ c, group) / n
    cov = 0.5 * (cov + cov.T)
    scale = torch.trace(cov) / P
    w = n / (n + 5.0)
    reg = (1e-3 * (5.0 / (n + 5.0)) + 1e-7) * scale.clamp_min(1e-12)
    return w * cov + reg * torch.eye(P, device=zs.device)


def init_chains(logpost_fn: Callable, init_z: torch.Tensor,
                cfg: HMCConfig) -> HMCChainState:
    """Initial state of every chain (leading axis C)."""
    C, _ = init_z.shape
    lp0, g0 = value_and_grad(logpost_fn)(init_z)
    return HMCChainState(z=init_z, logpost=lp0, grad=g0,
                         da=da_init(cfg.init_step, C, init_z.device))


def _window_update(states, inv_mass, zs, w: int, cfg, mask, group=None):
    """Between-window adaptation, shared by HMC and NUTS (`cfg` an
    HMCConfig or a nuts.NUTSConfig: its n_windows and dense_mass).  Every
    window but the last installs the (co)variance estimate pooled over
    the chains (and the group's ranks) as the metric (pinned dims get a
    unit diagonal and no cross terms) and restarts dual averaging at each
    chain's current eps; the last keeps its metric, and its DA average
    becomes the frozen step size."""
    if w >= cfg.n_windows - 1:
        return states, inv_mass
    if cfg.dense_mass:
        est = _pooled_cov(zs, group)
        est = est * (mask[:, None] * mask[None, :]) + torch.diag(1.0 - mask)
    else:
        _, var = _pooled_mean_var(zs, group)
        est = (var + 1e-6) * mask + (1.0 - mask)
    da = states.da
    fresh = DAState(
        log_eps=da.log_eps,
        log_eps_avg=da.log_eps,
        h_avg=torch.zeros_like(da.h_avg),
        mu=math.log(10.0) + da.log_eps,
        count=torch.zeros_like(da.count),
    )
    return states._replace(da=fresh), est


def make_warmup_window(logpost_fn: Callable, cfg: HMCConfig,
                       group=None) -> Callable:
    """One warmup window `(states, inv_mass, w, gen) -> (states,
    inv_mass)`.  Looping it over w = 0..n_windows-1 is warmup(); finish
    with `freeze_step_size(states, group)` for the sampling eps."""
    vgrad = value_and_grad(logpost_fn)

    def window_fn(states, inv_mass, w: int, gen: torch.Generator):
        P = states.z.shape[-1]
        mask = cfg.mask_array(P, states.z.device)
        seg_len = max(cfg.n_warmup // cfg.n_windows, 1)
        chol = _metric_chol(inv_mass)
        zs = []
        for _ in range(seg_len):
            eps = torch.exp(states.da.log_eps)
            states, ap = hmc_transition(vgrad, states, eps, inv_mass, cfg,
                                        gen, chol=chol)
            states = states._replace(
                da=da_update(states.da, ap, cfg.target_accept))
            zs.append(states.z)
        zs = torch.stack(zs, dim=1)                      # [C, seg_len, P]
        return _window_update(states, inv_mass, zs, w, cfg, mask, group)

    return window_fn


def freeze_step_size(states: HMCChainState, group=None) -> torch.Tensor:
    """Frozen sampling eps = cross-chain mean of the terminal window's DA
    average, in log space (with a group, the pmean of the ranks' local
    means)."""
    return torch.exp(pmean(states.da.log_eps_avg.mean(), group))


def initial_metric(cfg: HMCConfig, P: int, device) -> torch.Tensor:
    return (torch.eye(P, device=device) if cfg.dense_mass
            else torch.ones(P, device=device))


def warmup(logpost_fn: Callable, states: HMCChainState, cfg: HMCConfig,
           gen: torch.Generator, inv_mass0: torch.Tensor | None = None,
           group=None):
    """Windowed warmup.  Returns (states, inv_mass, eps)."""
    P = states.z.shape[-1]
    inv_mass = (initial_metric(cfg, P, states.z.device)
                if inv_mass0 is None else inv_mass0)
    window_fn = make_warmup_window(logpost_fn, cfg, group)
    for w in range(cfg.n_windows):
        states, inv_mass = window_fn(states, inv_mass, w, gen)
    return states, inv_mass, freeze_step_size(states, group)


def sample_chunk(logpost_fn: Callable, states: HMCChainState,
                 inv_mass: torch.Tensor, eps: torch.Tensor, n_record: int,
                 cfg: HMCConfig, gen: torch.Generator):
    """Record `n_record` thinned samples from every chain.
    Returns (states, zs [C, n, P], lps [C, n], accept [C, n])."""
    vgrad = value_and_grad(logpost_fn)
    chol = _metric_chol(inv_mass)
    zs, lps, aps = [], [], []
    for _ in range(n_record):
        ap_sum = 0.0
        for _ in range(cfg.thin):
            states, ap = hmc_transition(vgrad, states, eps, inv_mass, cfg,
                                        gen, chol=chol)
            ap_sum = ap_sum + ap
        zs.append(states.z)
        lps.append(states.logpost)
        aps.append(ap_sum / cfg.thin)
    return (states, torch.stack(zs, 1), torch.stack(lps, 1),
            torch.stack(aps, 1))


def run_hmc(logpost_fn: Callable, init_z: torch.Tensor, gen: torch.Generator,
            cfg: HMCConfig = HMCConfig(), group=None):
    """Warmup + sampling.  Returns (samples [n_rec, C, P] in
    unconstrained space, info dict).  With a group, init_z is this rank's
    chains and the warmup pools over the group's ranks; the outputs stay
    this rank's (parallel.run assembles them)."""
    states = init_chains(logpost_fn, init_z, cfg)
    states, inv_mass, eps_final = warmup(logpost_fn, states, cfg, gen,
                                         group=group)
    states, zs, lps, aps = sample_chunk(
        logpost_fn, states, inv_mass, eps_final,
        cfg.n_samples // cfg.thin, cfg, gen,
    )
    info = dict(
        accept_prob=aps.mean(),
        step_size=eps_final,
        inv_mass=inv_mass,
        logposts=lps.transpose(0, 1),
        final_states=states,
    )
    return zs.transpose(0, 1), info
