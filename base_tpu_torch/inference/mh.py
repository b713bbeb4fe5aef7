"""Adaptive Metropolis-Hastings, the reference-parity sampler (port of
base_tpu.inference.mh).

The reference's three-stage scheme:

  stage 1  independent per-parameter Gaussian proposals, step scales
           tuned multiplicatively against the acceptance rate;
  stage 2  fixed independent proposals, samples collected for an
           empirical covariance -> Cholesky factor;
  stage 3  correlated proposals theta' = theta + s L z (s = 2.38/sqrt(d)).

base_tpu writes it for one chain and maps it over chains; here every
state tensor has a leading chain axis C and each step is one batched
density call, `[C, P] -> [C]`, under `torch.no_grad()` (on a CUDA model
the marginal and table kernels launch without their backwards).  Every
chain tunes its own steps and factors its own stage-2 covariance.  Fixed
parameters (step scale 0) never move and are excluded from the
covariance.  Randomness comes from one `torch.Generator`, consumed per
step in a fixed order: the proposal normals [C, P], then the accept
uniforms [C].
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from base_tpu_torch.ops.special import NEG_INF


class MHState(NamedTuple):
    position: torch.Tensor  # [C, P]
    logpost: torch.Tensor   # [C]


@dataclasses.dataclass(frozen=True)
class MHConfig:
    n_stage1: int = 1000
    n_stage2: int = 1000
    n_main: int = 5000
    thin: int = 1
    adapt_every: int = 50
    target_accept: float = 0.25
    stage3_scale: float | None = None  # default 2.38/sqrt(n_free)


def _mh_step(logpost_fn: Callable, state: MHState, delta: torch.Tensor,
             u: torch.Tensor) -> tuple[MHState, torch.Tensor]:
    """One Metropolis step of every chain with a precomputed proposal
    offset `delta` [C, P] and accept uniforms `u` [C]."""
    prop = state.position + delta
    lp_prop = logpost_fn(prop)
    accept = (torch.log(u) < lp_prop - state.logpost) & (
        lp_prop > NEG_INF / 2)
    new = MHState(
        position=torch.where(accept[:, None], prop, state.position),
        logpost=torch.where(accept, lp_prop, state.logpost),
    )
    return new, accept


def _draw_step(logpost_fn, state, offset, gen):
    """Draw z [C, P] and u [C], take one step with delta = offset(z)."""
    C, P = state.position.shape
    dev = state.position.device
    z = torch.randn((C, P), generator=gen, device=dev)
    u = torch.rand(C, generator=gen, device=dev)
    return _mh_step(logpost_fn, state, offset(z), u)


@torch.no_grad()
def run_adaptive_mh(
    logpost_fn: Callable,
    init_position: torch.Tensor,
    gen: torch.Generator,
    step_init: torch.Tensor,
    cfg: MHConfig = MHConfig(),
    logpost_burnin_fn: Callable | None = None,
):
    """The three stages for chains starting at `init_position` [C, P].
    `step_init` [P]: initial per-parameter scales; 0 pins a parameter.

    Returns (samples [n_main // thin, C, P], info), info with per-chain
    `accept_rate` [C], `stage1_rates` [n_blocks, C], `stage2_accept` [C],
    `step` [C, P], `chol` [C, P, P], `logposts` [n_main // thin, C] and
    `final_state`.

    `logpost_burnin_fn`, when given, is the density of stages 1-2 (the
    reference's useDuringBurnIn star subset); stage 3 always targets the
    full density, with a fresh evaluation at the hand-off.
    """
    C, P = init_position.shape
    dev = init_position.device
    step_init = torch.as_tensor(step_init, dtype=torch.float32, device=dev)
    free = (step_init > 0).float()
    n_free = free.sum().clamp_min(1.0)
    burn_fn = logpost_burnin_fn or logpost_fn
    state = MHState(position=init_position, logpost=burn_fn(init_position))

    # ---- stage 1: multiplicative step tuning -------------------------------
    step = step_init.expand(C, P).clone()
    s1_rates = []
    for _ in range(max(cfg.n_stage1 // cfg.adapt_every, 1)):
        acc_n = torch.zeros(C, device=dev)
        for _ in range(cfg.adapt_every):
            state, acc = _draw_step(burn_fn, state,
                                    lambda z: step * free * z, gen)
            acc_n = acc_n + acc
        rate = acc_n / cfg.adapt_every
        # Multiplicative tuning toward the target acceptance rate.
        step = step * torch.exp(1.5 * (rate - cfg.target_accept))[:, None]
        s1_rates.append(rate)

    # ---- stage 2: fixed proposals, collect covariance ----------------------
    s2_pos, s2_acc = [], []
    for _ in range(cfg.n_stage2):
        state, acc = _draw_step(burn_fn, state, lambda z: step * free * z,
                                gen)
        s2_pos.append(state.position)
        s2_acc.append(acc)
    s2_pos = torch.stack(s2_pos, 1)                      # [C, n2, P]
    centered = (s2_pos - s2_pos.mean(1, keepdim=True)) * free
    cov = centered.transpose(1, 2) @ centered / max(cfg.n_stage2 - 1, 1)
    # Pinned params get a unit diagonal so the factor exists; their
    # proposal contribution is masked out anyway.
    cov = cov + torch.diag(1.0 - free) + 1e-8 * torch.eye(P, device=dev)
    chol = torch.linalg.cholesky(cov)                    # [C, P, P]

    # Hand-off: re-evaluate the chain positions under the full density.
    state = state._replace(logpost=logpost_fn(state.position))

    scale = (2.38 / torch.sqrt(n_free) if cfg.stage3_scale is None
             else cfg.stage3_scale)

    # ---- stage 3: correlated proposals, record samples ---------------------
    def correlated(z):
        return scale * (chol @ z[:, :, None])[:, :, 0] * free

    samples, logposts, acc_counts = [], [], []
    for _ in range(cfg.n_main // cfg.thin):
        acc_n = torch.zeros(C, device=dev)
        for _ in range(cfg.thin):
            state, acc = _draw_step(logpost_fn, state, correlated, gen)
            acc_n = acc_n + acc
        samples.append(state.position)
        logposts.append(state.logpost)
        acc_counts.append(acc_n)
    info = dict(
        accept_rate=torch.stack(acc_counts).sum(0) / cfg.n_main,
        stage1_rates=torch.stack(s1_rates),
        stage2_accept=torch.stack(s2_acc).float().mean(0),
        step=step,
        chol=chol,
        logposts=torch.stack(logposts),
        final_state=state,
    )
    return torch.stack(samples), info
