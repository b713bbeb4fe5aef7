"""Adaptive tempered SMC with systematic resampling (port of
base_tpu.inference.smc).

Algorithm (Del Moral et al. 2006 style):
  bridge      log pi_beta = (1-beta) log q0 + beta log target
  beta ladder chosen adaptively: each stage takes the largest step that
              keeps the incremental effective sample size above
              `ess_target` (fixed-iteration bisection)
  resample    systematic, every stage
  move        n_move random-walk MH steps targeting pi_beta, proposal
              sd = per-dimension particle sd * sqrt(scale 2.38^2 / d)

R independent replicates run folded into the particle axis: particles are
[R * N, P], each move calls the density once for all R * N rows, and every
per-replicate statistic (the ESS bisection, beta, resampling, the move
covariance, the move-scale autotune, the log-evidence) is reduced over a
view [R, N, ...].  Those reductions are fixed-order pairwise sums built
from elementwise operations (`_rowsum`, `_rowcumsum`), and each replicate
draws from its own `torch.Generator`, so that a replicate's arithmetic
does not depend on the others: one replicate of a folded run equals a run
of that replicate alone, bit for bit, for a density that evaluates each
row independently.

After the stage in which a replicate reaches beta = 1 its later stages are
no-ops (masked), as base_tpu's `lax.scan` over `max_stages` makes them;
the loops here stop once every replicate is done, which changes no
result.  A move carries each particle's log target and log q0 along, so a
stage calls the density n_move times and never again at the resampled or
moved points.  Density calls run under `torch.no_grad()`.

Sharded (parallel.run.run_smc_sharded): with `group` the chain group of a
mesh, each rank holds N particles of every replicate and the statistics
pool over the group's ranks (base_tpu's `axis_name`): the ESS and the
evidence increment through pmax / psum, the move moments through psum,
the move acceptance through pmean; resampling all-gathers the weights and
particles, takes every shard's uniform from the group's first rank, and
each rank keeps its slice of the global ancestry.

Returns particles ~ target, plus the log normalizing-constant estimate
(log evidence).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from base_tpu_torch.ops.special import NEG_INF
from base_tpu_torch.parallel.comm import all_gather, pmax, pmean, psum
from base_tpu_torch.parallel.comm import rank as group_rank


@dataclasses.dataclass(frozen=True)
class SMCConfig:
    n_particles: int = 1024     # per replicate
    max_stages: int = 24
    n_move: int = 3
    ess_target: float = 0.6     # fraction of N
    n_bisect: int = 26
    move_scale: float = 1.0     # initial multiplier on 2.38^2/d
    # Move-kernel autotuning: after each stage the proposal scale is
    # nudged log-multiplicatively toward `target_move_accept`.
    adapt_move: bool = True
    target_move_accept: float = 0.3
    move_adapt_rate: float = 1.0   # d log(scale) per unit accept error


class SMCState(NamedTuple):
    z: torch.Tensor               # [R * N, P] particles
    log_target: torch.Tensor      # [R * N] log target density at z
    log_q0: torch.Tensor          # [R * N] log reference density at z
    beta: torch.Tensor            # [R] in [0, 1]
    log_evidence: torch.Tensor    # [R]
    log_move_scale: torch.Tensor  # [R] adapted log move multiplier


def _rowsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over `dim` as a fixed pairwise tree of elementwise adds (zero
    padded to a power of two): every slice's sum is the same float32
    operations whatever the other dimensions hold."""
    dim = dim % x.ndim
    n = x.shape[dim]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        pad = [0, 0] * (x.ndim - 1 - dim) + [0, p - n]
        x = F.pad(x, pad)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def _rowcumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis by doubling steps of
    elementwise adds (the same for every row, whatever the others hold)."""
    k = 1
    while k < x.shape[-1]:
        x = torch.cat([x[..., :k], x[..., k:] + x[..., :-k]], dim=-1)
        k *= 2
    return x


def _ess_fraction(log_w: torch.Tensor, n_total, group=None):
    """Effective sample size fraction of normalized weights exp(log_w)
    over the last axis ([..., N] -> [...]), and over the group's ranks."""
    m = pmax(log_w.amax(-1, keepdim=True), group)
    w = torch.exp(log_w - m)
    s1 = psum(_rowsum(w), group)
    s2 = psum(_rowsum(w * w), group)
    return (s1 * s1) / s2.clamp_min(1e-38) / n_total


def _systematic_resample(u: torch.Tensor, log_w: torch.Tensor,
                         z: torch.Tensor, group=None):
    """Systematic resampling of each replicate: log_w [R, N], particles z
    [R, N, P] and one uniform u [R] in [0, 1) per replicate, drawn by the
    caller.  Returns (resampled particles [R, N, P], ancestors [R, N]).
    With a group (u equal on its ranks), the weights and particles of its
    ranks are gathered into [R, G * N] in rank order, and each rank keeps
    its slice of the global ancestry: ancestors index the gathered
    particles."""
    n_local = log_w.shape[-1]
    log_w = all_gather(log_w, group, dim=1)
    z = all_gather(z, group, dim=1)
    N = log_w.shape[-1]
    w = torch.exp(log_w - log_w.amax(-1, keepdim=True))
    w = w / _rowsum(w)[:, None]
    cum = _rowcumsum(w)
    pts = (u / N)[:, None] + torch.arange(N, dtype=w.dtype,
                                          device=w.device) / N
    anc = torch.searchsorted(cum.contiguous(), pts.contiguous())
    anc = anc.clamp(0, N - 1)
    if group is not None:
        anc = anc[:, group_rank(group) * n_local:][:, :n_local]
    return torch.gather(z, 1, anc[..., None].expand(-1, -1, z.shape[-1])), anc


def _draw_per_replicate(gens, fn) -> torch.Tensor:
    """fn(gen) for each replicate's generator, stacked: [R, ...]."""
    return torch.stack([fn(g) for g in gens])


@torch.no_grad()
def _smc_init(log_target, sample_q0, log_q0, gens, cfg: SMCConfig,
              group=None):
    """The initial state of len(gens) replicates, each with N particles
    from its own generator: sample_q0(gen, N) -> [N, P].  Returns (state,
    n_total), n_total the particles per replicate (over the group's
    ranks)."""
    z = torch.cat([sample_q0(g, cfg.n_particles) for g in gens])
    R = len(gens)
    dev = z.device
    state = SMCState(
        z=z, log_target=log_target(z), log_q0=log_q0(z),
        beta=torch.zeros(R, device=dev),
        log_evidence=torch.zeros(R, device=dev),
        log_move_scale=torch.full((R,), math.log(cfg.move_scale),
                                  device=dev),
    )
    n_total = float(cfg.n_particles)
    if group is not None:
        n_total = float(psum(z.new_tensor(n_total), group))
    return state, n_total


def _make_smc_stage(log_target, log_q0, cfg: SMCConfig, group,
                    n_total: float, d: int):
    """One SMC stage of every replicate as `stage(state, gens) -> (state,
    (beta_new [R], move accept [R], active [R]))`, shared by run_smc,
    run_smc_replicated and the chunked runner, pooled over `group`'s
    ranks.  Draws, per replicate in order of replicates: the resampling
    uniform (with a group, the one of its first rank is used); then per
    move the proposal normals [N, P] and the accept uniforms [N]."""

    @torch.no_grad()
    def stage(state: SMCState, gens):
        R = state.beta.shape[0]
        N = state.z.shape[0] // R
        P = state.z.shape[-1]
        beta = state.beta
        done = beta >= 1.0
        # log weight increment for moving beta -> beta': (b'-b)(lt - lq)
        delta_l = (state.log_target - state.log_q0).view(R, N)
        delta_l = torch.where(torch.isfinite(delta_l), delta_l,
                              torch.full_like(delta_l, NEG_INF))

        def ess_at(b_new):
            return _ess_fraction((b_new - beta)[:, None] * delta_l, n_total,
                                 group)

        # Bisection for the largest step keeping ESS >= target.
        full = ess_at(torch.ones_like(beta)) >= cfg.ess_target
        lo, hi = beta, torch.ones_like(beta)
        for _ in range(cfg.n_bisect):
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= cfg.ess_target
            lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
        beta_new = torch.where(full, torch.ones_like(beta),
                               torch.maximum(lo, beta + 1e-6))
        beta_new = torch.where(done, beta, beta_new.clamp(max=1.0))

        log_w = (beta_new - beta)[:, None] * delta_l
        m = pmax(log_w.amax(-1), group)
        lsum = torch.log(psum(_rowsum(torch.exp(log_w - m[:, None])), group))
        log_ev_inc = m + lsum - math.log(n_total)

        u = _draw_per_replicate(
            gens, lambda g: torch.rand((), generator=g, device=beta.device))
        if group is not None:
            u = all_gather(u[None], group)[0]
        z, anc = _systematic_resample(u, log_w, state.z.view(R, N, P), group)
        lt = torch.gather(all_gather(state.log_target.view(R, N), group, 1),
                          1, anc)
        lq = torch.gather(all_gather(state.log_q0.view(R, N), group, 1),
                          1, anc)

        # Per-replicate particle variance for the move proposal (diagonal).
        mean = psum(_rowsum(z, 1), group) / n_total
        var = (psum(_rowsum(z * z, 1), group) / n_total
               - mean * mean).clamp_min(1e-10)
        scale = torch.exp(state.log_move_scale)
        prop_sd = torch.sqrt(var) * torch.sqrt(scale * 2.38**2 / d)[:, None]

        bn = beta_new[:, None]
        lb = (1.0 - bn) * lq + bn * lt
        acc_sum = torch.zeros_like(beta)
        for _ in range(cfg.n_move):
            eps = _draw_per_replicate(
                gens, lambda g: torch.randn((N, P), generator=g,
                                            device=z.device))
            logu = torch.log(_draw_per_replicate(
                gens, lambda g: torch.rand(N, generator=g,
                                           device=z.device)))
            prop = z + prop_sd[:, None, :] * eps
            flat = prop.view(R * N, P)
            lt_p = log_target(flat).view(R, N)
            lq_p = log_q0(flat).view(R, N)
            lb_p = (1.0 - bn) * lq_p + bn * lt_p
            acc = (logu < lb_p - lb) & (lb_p > NEG_INF / 2)
            z = torch.where(acc[..., None], prop, z)
            lb = torch.where(acc, lb_p, lb)
            lt = torch.where(acc, lt_p, lt)
            lq = torch.where(acc, lq_p, lq)
            acc_sum = acc_sum + _rowsum(acc.to(z.dtype)) / N
        stage_acc = pmean(acc_sum / cfg.n_move, group)

        # Autotune the move scale toward the target acceptance.
        lms = state.log_move_scale
        if cfg.adapt_move:
            upd = lms + cfg.move_adapt_rate * (stage_acc
                                               - cfg.target_move_accept)
            lms = torch.where(done, lms, upd.clamp(-6.0, 3.0))

        keep = done.repeat_interleave(N)
        new = SMCState(
            z=torch.where(keep[:, None], state.z, z.view(R * N, P)),
            log_target=torch.where(keep, state.log_target, lt.view(-1)),
            log_q0=torch.where(keep, state.log_q0, lq.view(-1)),
            beta=beta_new,
            log_evidence=state.log_evidence + torch.where(
                done, torch.zeros_like(log_ev_inc), log_ev_inc),
            log_move_scale=lms,
        )
        return new, (beta_new, stage_acc, ~done)

    return stage


def replicate_generators(gen: torch.Generator,
                         n_rep: int) -> list[torch.Generator]:
    """n_rep generators on gen's device, seeded from gen's stream: one per
    replicate of run_smc_replicated and make_smc_chunked_runner."""
    seeds = torch.randint(0, 2**62, (n_rep,), generator=gen,
                          device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s)
            for s in seeds]


def _run_stages(log_target, sample_q0, log_q0, gens, cfg: SMCConfig,
                group=None):
    """Init and stages until every replicate has reached beta = 1 (or
    max_stages): one density call, then n_move a stage.  Returns (state,
    betas, accs, actives), each of the last three [stages run, R].  The
    betas are equal on a group's ranks, so they stop together."""
    state, n_total = _smc_init(log_target, sample_q0, log_q0, gens, cfg,
                               group)
    stage = _make_smc_stage(log_target, log_q0, cfg, group, n_total,
                            state.z.shape[-1])
    betas, accs, actives = [], [], []
    for _ in range(cfg.max_stages):
        state, (b, a, act) = stage(state, gens)
        betas.append(b)
        accs.append(a)
        actives.append(act)
        if bool((state.beta >= 1.0).all()):
            break
    return state, torch.stack(betas), torch.stack(accs), torch.stack(actives)


def _replicate_accept(accs, actives):
    """Each replicate's move acceptance over its active stages [R]."""
    act = actives.to(accs.dtype)
    return (accs * act).sum(0) / act.sum(0).clamp_min(1.0)


def _padded_betas(betas, max_stages: int):
    """[R, max_stages]: the stages run, then the final beta repeated, as
    base_tpu's scan reports its no-op stages."""
    pad = betas[-1:].expand(max_stages - betas.shape[0], -1)
    return torch.cat([betas, pad]).T


def run_smc(
    log_target: Callable[[torch.Tensor], torch.Tensor],
    sample_q0: Callable[[torch.Generator, int], torch.Tensor],
    log_q0: Callable[[torch.Tensor], torch.Tensor],
    gen: torch.Generator,
    cfg: SMCConfig = SMCConfig(),
    group=None,
):
    """Run adaptive tempered SMC.  log_target and log_q0 map particles
    [n, P] -> [n]; sample_q0(gen, n) -> [n, P].

    Returns (particles [N, P], info dict with log_evidence, n_stages,
    final beta, acceptance, betas [max_stages], move_scale); with a group,
    this rank's particles and the pooled statistics."""
    state, betas, accs, actives = _run_stages(log_target, sample_q0, log_q0,
                                              [gen], cfg, group)
    return state.z, _single_info(state, betas, accs, actives, cfg.max_stages)


def _single_info(state, betas, accs, actives, max_stages: int) -> dict:
    """run_smc's info of a run of one replicate."""
    return dict(
        log_evidence=state.log_evidence[0],
        beta=state.beta[0],
        n_stages=actives.sum(),
        accept=_replicate_accept(accs, actives)[0],
        betas=_padded_betas(betas, max_stages)[0],
        move_scale=torch.exp(state.log_move_scale[0]),
    )


def _replicated_info(state, betas, accs, actives, n_rep: int) -> dict:
    les = state.log_evidence
    return dict(
        log_evidence=les.mean(),
        log_evidence_se=les.std(correction=0) / math.sqrt(n_rep),
        log_evidences=les,
        beta=state.beta.min(),
        n_stages=actives.sum(0).max(),
        accept=_replicate_accept(accs, actives).mean(),
        move_scale=torch.exp(state.log_move_scale).mean(),
    )


def run_smc_replicated(
    log_target: Callable[[torch.Tensor], torch.Tensor],
    sample_q0: Callable[[torch.Generator, int], torch.Tensor],
    log_q0: Callable[[torch.Tensor], torch.Tensor],
    gen: torch.Generator,
    cfg: SMCConfig = SMCConfig(),
    n_rep: int = 4,
):
    """n_rep independent SMC runs folded into one particle axis (one
    density call per move for all n_rep * N particles), each with its own
    generator from `replicate_generators(gen, n_rep)`: particles
    pool across replicates, and the log-evidence estimate gains a
    repeat-run standard error.

    Returns (particles [n_rep * N, P], info) where info adds
    `log_evidence_se` (std over replicates / sqrt(n_rep)) and
    `log_evidences` [n_rep]; scalar fields are replicate means (beta the
    least, n_stages the most), `betas` [n_rep, max_stages]."""
    gens = replicate_generators(gen, n_rep)
    state, betas, accs, actives = _run_stages(log_target, sample_q0, log_q0,
                                              gens, cfg)
    info = _replicated_info(state, betas, accs, actives, n_rep)
    info["betas"] = _padded_betas(betas, cfg.max_stages)
    return state.z, info


def make_smc_chunked_runner(
    log_target: Callable[[torch.Tensor], torch.Tensor],
    sample_q0: Callable[[torch.Generator, int], torch.Tensor],
    log_q0: Callable[[torch.Tensor], torch.Tensor],
    cfg: SMCConfig = SMCConfig(),
    n_rep: int = 4,
):
    """Stage-by-stage replicated SMC: all replicates advance together, one
    stage at a time, and the loop stops as soon as every replicate reaches
    beta = 1 (exact: later stages are no-ops).  The same stage function
    and generators as run_smc_replicated, whose results it equals bit for
    bit.

    Returns runner(gen) -> (particles [n_rep * N, P], info) with
    run_smc_replicated's info as Python floats, plus `betas` [stages run,
    n_rep]."""

    def runner(gen: torch.Generator):
        gens = replicate_generators(gen, n_rep)
        state, betas, accs, actives = _run_stages(
            log_target, sample_q0, log_q0, gens, cfg)
        info = {k: (v if k == "log_evidences" else v.item())
                for k, v in _replicated_info(state, betas, accs, actives,
                                             n_rep).items()}
        info["betas"] = betas
        return state.z, info

    return runner
