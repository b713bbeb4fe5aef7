"""No-U-Turn Sampler: iterative multinomial NUTS over a batch of chains
(port of base_tpu.inference.nuts).

base_tpu builds one chain's tree with `lax.while_loop`s and vmaps chains,
so they advance in lockstep to the slowest tree.  Here the lockstep is
written out: every state tensor has a leading chain axis C, depth and leaf
counters are shared, and every leapfrog leaf is one evaluation of the
density on all C chains (one call, or one per block of `chain_chunk`
rows: hmc.value_and_grad).  Each chain carries two masks, "tree done"
and "still active in this subtree"; a chain that is done keeps its state
(its density is still evaluated, so the launch shapes stay fixed).

- Sub-U-turn checks use a checkpoint stack [C, max_depth, P]: leaf s is
  stored at slot j whenever s % 2^j == 0 (it opens a 2^j block), and leaf
  i is checked against slot j whenever (i+1) % 2^j == 0 (it closes that
  block): the complete-balanced-subtree criterion with max_depth slots.
- Progressive multinomial sampling within a subtree, and Stan's biased
  progressive sampling across subtrees (accept the subtree's proposal with
  probability min(1, W_new / W_old)).
- Randomness comes from one explicit `torch.Generator`, consumed in a fixed
  order per transition: momenta [C, P]; per doubling the directions [C],
  one selection uniform [C] per leaf, then the subtree-acceptance uniforms
  [C].  So the chunked runner and `run_nuts` agree bit for bit under one
  seed.

Dual averaging and windowed mass adaptation reuse inference.hmc's
machinery; run_nuts mirrors run_hmc's interface, `group` included (the
chain group of a mesh: the warmup's moments and the frozen step size pool
over its ranks).  Every rank of a star group evaluates the same chains, so
its U-turn and divergence decisions, and with them its density calls, are
those of the other ranks of the group (parallel.run).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from base_tpu_torch.inference.hmc import (
    DAState,
    _kinetic,
    _mass_matvec,
    _metric_chol,
    _sample_momentum,
    _window_update,
    da_init,
    da_update,
    freeze_step_size,
    initial_metric,
    value_and_grad,
)
from base_tpu_torch.ops.special import NEG_INF


@dataclasses.dataclass(frozen=True)
class NUTSConfig:
    n_warmup: int = 500
    n_samples: int = 1000
    thin: int = 1
    max_depth: int = 8
    target_accept: float = 0.8
    init_step: float = 0.05
    n_windows: int = 4
    max_delta_energy: float = 1000.0
    # Same semantics as HMCConfig: full [P,P] metric from the pooled
    # cross-chain covariance, and pinned density-flat dims.
    dense_mass: bool = False
    free_mask: tuple | None = None
    # Max chains in one density call (same memory-bounding semantics as
    # HMCConfig.chain_chunk: blocks of rows run one after another, peak
    # memory is one block's).
    chain_chunk: int | None = None

    def mask_array(self, P: int, device) -> torch.Tensor:
        if self.free_mask is None:
            return torch.ones(P, device=device)
        return torch.as_tensor(self.free_mask, dtype=torch.float32,
                               device=device)


class _Point(NamedTuple):
    z: torch.Tensor      # [C, P]
    p: torch.Tensor      # [C, P]
    grad: torch.Tensor   # [C, P]
    lp: torch.Tensor     # [C]


class NUTSChainState(NamedTuple):
    z: torch.Tensor        # [C, P]
    logpost: torch.Tensor  # [C]
    grad: torch.Tensor     # [C, P]
    da: DAState


def _select(cond: torch.Tensor, a: NamedTuple, b: NamedTuple):
    """Per chain: a where cond [C], else b (field by field; fields [C]
    or [C, P])."""
    c2 = cond[:, None]
    return type(a)(*(torch.where(c2 if x.ndim == 2 else cond, x, y)
                     for x, y in zip(a, b)))


def _uturn(z_a, p_a, z_b, p_b, inv_mass) -> torch.Tensor:
    """U-turn [C] between ordered endpoints a (left) and b (right)."""
    dz = z_b - z_a
    return (((dz * _mass_matvec(inv_mass, p_a)).sum(-1) < 0.0)
            | ((dz * _mass_matvec(inv_mass, p_b)).sum(-1) < 0.0))


def _leapfrog_one(vgrad, pt: _Point, eps, inv_mass, direction,
                  mask=None) -> _Point:
    """One leapfrog step of every chain; eps and direction are [C]."""
    e = (eps * direction)[:, None]
    p_half = pt.p + 0.5 * e * pt.grad
    z_new = pt.z + e * _mass_matvec(inv_mass, p_half)
    lp, g = vgrad(z_new)
    if mask is not None:
        g = g * mask
    p_new = p_half + 0.5 * e * g
    return _Point(z=z_new, p=p_new, grad=g, lp=lp)


def _checkpoint_turn(s: int, ck_z, ck_v, z, v, direction):
    """The checkpoint stack at leaf s (0-based, shared by the chains) of a
    subtree: store the leaf's position z and velocity v = Sigma p in every
    slot j - 1 whose 2^j block leaf s opens (ck_z, ck_v [C, D, P], updated
    in place), and return [C] whether a block that leaf s closes makes a
    U-turn.  With the endpoints ordered along the integration direction d
    [C] (+-1), _uturn(a, b) is dz.v_a < 0 or dz.v_b < 0 for dz = z_b - z_a;
    with dz = z - z_ck that is d (dz.v_ck) < 0 or d (dz.v) < 0."""
    turning = None
    for j in range(1, ck_z.shape[1] + 1):
        if s % (1 << j) == 0:
            ck_z[:, j - 1] = z
            ck_v[:, j - 1] = v
        if (s + 1) % (1 << j) == 0:
            dz = z - ck_z[:, j - 1]
            tj = (((direction * (dz * ck_v[:, j - 1]).sum(-1)) < 0.0)
                  | ((direction * (dz * v).sum(-1)) < 0.0))
            turning = tj if turning is None else turning | tj
    if turning is None:
        return torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    return turning


class _Subtree(NamedTuple):
    pt: _Point           # frontier after the subtree's last leaf
    prop: _Point         # the subtree's multinomial proposal (p unused)
    logw: torch.Tensor   # [C] log weight of the subtree
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_acc: torch.Tensor
    n_leaves: torch.Tensor  # [C] leaves taken


def _build_subtree(vgrad, frontier: _Point, direction, n_leaves: int,
                   active, h0, eps, inv_mass, mask, cfg: NUTSConfig,
                   gen: torch.Generator) -> _Subtree:
    """Up to n_leaves leapfrog steps from `frontier` for the chains in
    `active` [C]; a chain stops at a U-turn or a divergence, and the leaf
    loop ends once no chain is live.  Every chain is integrated at every
    leaf; only the live ones count their leaves and accept statistics.  A
    chain that is not live is inactive or turned or diverged, so the
    caller uses no other field of its subtree: those advance unmasked."""
    C, P = frontier.z.shape
    dev = frontier.z.device
    D = cfg.max_depth
    ck_z = torch.zeros(C, D, P, device=dev)
    ck_v = torch.zeros(C, D, P, device=dev)
    pt, prop = frontier, frontier
    logw = torch.full((C,), -torch.inf, device=dev)
    turning = torch.zeros(C, dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    sum_acc = torch.zeros(C, device=dev)
    n = torch.zeros(C, dtype=torch.int32, device=dev)
    for s in range(n_leaves):
        live = active & ~turning & ~diverging
        if not bool(live.any()):
            break
        u_sel = torch.rand(C, generator=gen, device=dev)
        pt = _leapfrog_one(vgrad, pt, eps, inv_mass, direction, mask=mask)
        v = _mass_matvec(inv_mass, pt.p)
        h = (0.5 * (pt.p * v).sum(-1)) - pt.lp
        h = torch.where(torch.isfinite(h), h, torch.full_like(h, torch.inf))
        dh = h - h0
        w = -dh              # log weight relative to the start energy
        logw_new = torch.logaddexp(logw, w)
        # Progressive multinomial sampling within the subtree.
        prop = _select(torch.log(u_sel) < w - logw_new, pt, prop)
        logw = logw_new
        turning = turning | _checkpoint_turn(s, ck_z, ck_v, pt.z, v,
                                             direction)
        diverging = diverging | (dh > cfg.max_delta_energy)
        acc = torch.exp((-dh).clamp(max=0.0)).clamp(max=1.0)
        sum_acc = sum_acc + torch.where(live, acc, 0.0)
        n = n + live.to(torch.int32)
    return _Subtree(pt, prop, logw, turning, diverging, sum_acc, n)


def nuts_transition(
    vgrad: Callable,
    state: NUTSChainState,
    eps: torch.Tensor,
    inv_mass: torch.Tensor,
    cfg: NUTSConfig,
    gen: torch.Generator,
    chol: torch.Tensor | None = None,
):
    """One NUTS update of every chain; eps is [C] or a scalar.  Returns
    (state, accept_stat [C], n_leapfrog [C]).

    `chol` is the precomputed factor of inv_mass (hmc._metric_chol)."""
    C, P = state.z.shape
    dev = state.z.device
    mask = cfg.mask_array(P, dev)
    if chol is None:
        chol = _metric_chol(inv_mass)
    eps = torch.broadcast_to(torch.as_tensor(eps, device=dev), (C,))
    p0 = _sample_momentum(gen, chol, C, P) * mask
    h0 = -state.logpost + _kinetic(inv_mass, p0)      # energy at start
    left = right = _Point(z=state.z, p=p0, grad=state.grad * mask,
                          lp=state.logpost)
    # The proposal; logw: log multinomial weight of the whole tree,
    # relative to exp(-h0); sum_acc / n_lf: the mean accept statistic for
    # dual averaging.
    prop = _Point(z=state.z, p=p0, grad=state.grad, lp=state.logpost)
    logw = torch.zeros(C, device=dev)
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    sum_acc = torch.zeros(C, device=dev)
    n_lf = torch.zeros(C, dtype=torch.int32, device=dev)
    for depth in range(cfg.max_depth):
        active = ~done
        if not bool(active.any()):
            break
        fwd = torch.rand(C, generator=gen, device=dev) < 0.5
        direction = torch.where(fwd, 1.0, -1.0)
        frontier = _select(fwd, right, left)
        sub = _build_subtree(vgrad, frontier, direction, 1 << depth, active,
                             h0, eps, inv_mass, mask, cfg, gen)
        bad = sub.turning | sub.diverging
        u_acc = torch.rand(C, generator=gen, device=dev)
        take = active & ~bad & (torch.log(u_acc) < sub.logw - logw)
        prop = _select(take, sub.prop, prop)
        logw = torch.where(active & ~bad, torch.logaddexp(logw, sub.logw),
                           logw)
        left = _select(active & ~bad & ~fwd, sub.pt, left)
        right = _select(active & ~bad & fwd, sub.pt, right)
        turning_total = _uturn(left.z, left.p, right.z, right.p, inv_mass)
        done = done | (active & (bad | turning_total))
        sum_acc = torch.where(active, sum_acc + sub.sum_acc, sum_acc)
        n_lf = torch.where(active, n_lf + sub.n_leaves, n_lf)
    accept_stat = sum_acc / n_lf.to(sum_acc.dtype).clamp_min(1.0)
    ok = prop.lp > NEG_INF / 2
    new_state = NUTSChainState(
        z=torch.where(ok[:, None], prop.z, state.z),
        logpost=torch.where(ok, prop.lp, state.logpost),
        grad=torch.where(ok[:, None], prop.grad, state.grad),
        da=state.da,
    )
    return new_state, accept_stat, n_lf


def init_nuts_chains(logpost_fn: Callable, init_z: torch.Tensor,
                     cfg: NUTSConfig) -> NUTSChainState:
    """Initial state of every chain (leading axis C)."""
    C, _ = init_z.shape
    lp0, g0 = value_and_grad(logpost_fn, cfg.chain_chunk)(init_z)
    return NUTSChainState(z=init_z, logpost=lp0, grad=g0,
                          da=da_init(cfg.init_step, C, init_z.device))


def make_nuts_warmup_window(
    logpost_fn: Callable,
    cfg: NUTSConfig,
    group=None,
) -> Callable:
    """One warmup window `(states, inv_mass, w, gen) -> (states,
    inv_mass)`, the NUTS analog of hmc.make_warmup_window (same schedule,
    shared _window_update, pooled over `group`'s ranks)."""
    vgrad = value_and_grad(logpost_fn, cfg.chain_chunk)
    seg_len = max(cfg.n_warmup // cfg.n_windows, 1)

    def window_fn(states, inv_mass, w: int, gen: torch.Generator):
        P = states.z.shape[-1]
        mask = cfg.mask_array(P, states.z.device)
        chol = _metric_chol(inv_mass)

        zs = []
        for _ in range(seg_len):
            eps = torch.exp(states.da.log_eps)
            states, acc, _ = nuts_transition(vgrad, states, eps, inv_mass,
                                             cfg, gen, chol=chol)
            states = states._replace(
                da=da_update(states.da, acc, cfg.target_accept))
            zs.append(states.z)
        zs = torch.stack(zs, dim=1)                       # [C, seg_len, P]
        return _window_update(states, inv_mass, zs, w, cfg, mask, group)

    return window_fn


def nuts_sample_chunk(
    logpost_fn: Callable,
    states: NUTSChainState,
    inv_mass: torch.Tensor,
    eps: torch.Tensor,
    n_record: int,
    cfg: NUTSConfig,
    gen: torch.Generator,
):
    """Record `n_record` thinned draws from every chain.  Returns
    (states, zs [C, n, P], lps [C, n], accs [C, n], nlfs [C, n]): each
    draw's accept statistic is the mean over its `thin` transitions and
    its leapfrog count the sum."""
    vgrad = value_and_grad(logpost_fn, cfg.chain_chunk)
    chol = _metric_chol(inv_mass)

    zs, lps, accs, nlfs = [], [], [], []
    for _ in range(n_record):
        acc_sum, nlf_sum = 0.0, 0
        for _ in range(cfg.thin):
            states, acc, nlf = nuts_transition(vgrad, states, eps, inv_mass,
                                               cfg, gen, chol=chol)
            acc_sum, nlf_sum = acc_sum + acc, nlf_sum + nlf
        zs.append(states.z)
        lps.append(states.logpost)
        accs.append(acc_sum / cfg.thin)
        nlfs.append(nlf_sum)
    return (states, torch.stack(zs, 1), torch.stack(lps, 1),
            torch.stack(accs, 1), torch.stack(nlfs, 1))


def run_nuts(
    logpost_fn: Callable,
    init_z: torch.Tensor,     # [C, P]
    gen: torch.Generator,
    cfg: NUTSConfig = NUTSConfig(),
    group=None,
):
    """Warmup (dual averaging + pooled mass windows) + sampling, NUTS
    kernel.  Same interface and contract as hmc.run_hmc: (samples
    [n_rec, C, P], info), this rank's chains under a group."""
    P = init_z.shape[-1]
    states = init_nuts_chains(logpost_fn, init_z, cfg)
    window_fn = make_nuts_warmup_window(logpost_fn, cfg, group)
    inv_mass = initial_metric(cfg, P, init_z.device)
    for w in range(cfg.n_windows):
        states, inv_mass = window_fn(states, inv_mass, w, gen)
    eps_final = freeze_step_size(states, group)
    states, zs, lps, accs, nlfs = nuts_sample_chunk(
        logpost_fn, states, inv_mass, eps_final, cfg.n_samples // cfg.thin,
        cfg, gen)
    # Means over [n, C] laid out as the chunked runner's, so that the two
    # agree bit for bit.
    info = dict(
        accept_prob=accs.T.contiguous().mean(),
        step_size=eps_final,
        inv_mass=inv_mass,
        logposts=lps.transpose(0, 1),
        mean_leapfrogs=nlfs.T.float().contiguous().mean(),
        final_states=states,
    )
    return zs.transpose(0, 1), info


def make_nuts_chunked_runner(
    logpost_fn: Callable,
    cfg: NUTSConfig,
    chunk_draws: int = 128,
) -> Callable:
    """Chunked NUTS (the analog of make_hmc_chunked_runner): warmup
    window by window, then sampling in chunks of recorded draws.  Returns
    `run(init_z, gen, n_samples=None) -> (samples [n_rec, C, P], info)`,
    bit-identical to run_nuts under one generator seed.  As in the HMC
    runner, an uneven last chunk still runs in full: samples and info
    cover the first n_rec draws, `final_states` and the generator sit past
    run_nuts's by the over-run."""
    window_fn = make_nuts_warmup_window(logpost_fn, cfg)
    chunk = max(min(chunk_draws, cfg.n_samples // cfg.thin), 1)

    def run(init_z: torch.Tensor, gen: torch.Generator,
            n_samples: int | None = None):
        P = init_z.shape[-1]
        inv_mass = initial_metric(cfg, P, init_z.device)
        states = init_nuts_chains(logpost_fn, init_z, cfg)
        for w in range(cfg.n_windows):
            states, inv_mass = window_fn(states, inv_mass, w, gen)
        eps = freeze_step_size(states)

        n_rec = (cfg.n_samples if n_samples is None else n_samples) // cfg.thin
        n_chunks = (n_rec + chunk - 1) // chunk
        zs_all, lps_all, acc_all, nlf_all = [], [], [], []
        for _ in range(n_chunks):
            states, zs, lps, accs, nlfs = nuts_sample_chunk(
                logpost_fn, states, inv_mass, eps, chunk, cfg, gen)
            zs_all.append(zs.transpose(0, 1))
            lps_all.append(lps.transpose(0, 1))
            acc_all.append(accs.transpose(0, 1))          # [n, C]
            nlf_all.append(nlfs.transpose(0, 1).float())
        info = dict(
            # Weighted by recorded draws, as the HMC runner.
            accept_prob=torch.cat(acc_all)[:n_rec].mean(),
            step_size=eps,
            inv_mass=inv_mass,
            logposts=torch.cat(lps_all)[:n_rec],
            mean_leapfrogs=torch.cat(nlf_all)[:n_rec].mean(),
            final_states=states,
        )
        return torch.cat(zs_all)[:n_rec], info

    return run
