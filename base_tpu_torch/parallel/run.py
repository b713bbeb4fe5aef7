"""Sharded posterior evaluation and sampler drivers over torch.distributed
(port of base_tpu.parallel.run).

base_tpu's scale-out layer runs the one-device density, unchanged, as a
program sharded over a (chains x stars) device mesh with shard_map.  Here
the mesh is one of ranks (parallel.mesh), one process each:

  - stars are split over the star group: every rank holds its slice of
    the padded MS and WD stars on its device (`shard_stars`), evaluates
    its stars' marginal likelihoods (kernels 1-4 on a CUDA model), and
    the total rides one all-reduce of a [C] vector over the star group;
  - chains are split over the chain group: every rank runs its block of
    chains with its chain shard's generator (`Mesh.chain_generator`), and
    the warmup pools across the group inside the samplers (their `group`
    argument);
  - every runner assembles its outputs on every rank, in base_tpu's
    shapes ([n_rec, C_total, P]; particles [N_total, P]).

The density is the full single- or two-population density (WD branch and
kernels included: `_model_log_lik`), on the rank's local stars.

The gradient of the star sum.  base_tpu's shard_map transposes the psum
correctly only with check_vma=True, and base_tpu.utils.vma marks the
sampler carries for it.  Torch has no varying-axes types, so
utils/vma.py has nothing to port: its job, a whole gradient on every
rank, is done by the autograd pair parallel.comm.enter / reduce_sum in
`local_logpost_fn` (enter on the parameters where they enter the
likelihood, reduce_sum on the local log-likelihood sum; the prior and the
log-Jacobian outside both).

Lockstep.  The star shards of one chain block draw from one generator and
get bitwise-equal reduced densities and gradients (one all-reduce gives
every rank the same bytes), so they take the same decisions and make the
same density calls.  With a sampler's `chain_chunk`, every call on a
chain block becomes one call (and one all-reduce) per block of chunk
rows (hmc.value_and_grad); the ranks of a star group hold the same block,
so they make the same number of them.  A rank that diverged would leave
its group one collective short; the groups' finite timeouts turn that
into an error.

`density_calls` and `density_rows` count this rank's calls of the sharded
density and the rows (chains, particles) they evaluated, since the last
`reset_counts()`.  Everything runs on a 1 x 1 mesh (a world of one), which
is how one card runs it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from base_tpu_torch.inference import driver as driver_mod
from base_tpu_torch.inference import hmc as hmc_mod
from base_tpu_torch.inference import mh as mh_mod
from base_tpu_torch.inference import nuts as nuts_mod
from base_tpu_torch.inference import smc as smc_mod
from base_tpu_torch.inference import vi as vi_mod
from base_tpu_torch.model import multipop as mp
from base_tpu_torch.model import posterior as post
from base_tpu_torch.model.stardata import MSStars, require_one_set
from base_tpu_torch.ops.special import NEG_INF
from base_tpu_torch.parallel import comm
from base_tpu_torch.parallel.mesh import (CHAIN_AXIS, STAR_AXIS, Mesh,
                                          pad_to_multiple)

__all__ = ["CHAIN_AXIS", "STAR_AXIS", "shard_stars", "local_logpost_fn",
           "make_sharded_hmc_fns", "run_hmc_sharded",
           "run_hmc_sharded_checkpointed", "run_nuts_sharded",
           "run_smc_sharded", "run_vi_sharded", "vi_warm_start_sharded",
           "run_mh_sharded", "logpost_at"]

density_calls = 0
density_rows = 0


def reset_counts() -> None:
    global density_calls, density_rows
    density_calls = density_rows = 0


def _model_log_lik(model, params):
    """The model family's (ll [C], in_bounds [C]): the local stars'
    log-likelihood sum and the bounds flag, for single- and
    two-population models alike."""
    if isinstance(model, post.SinglePopModel):
        return post.log_lik(model, params)
    if isinstance(model, mp.MultiPopModel):
        return mp.log_lik(model, params)
    raise TypeError(f"no sharded log_lik for {type(model).__name__}")


def _repad_stars(stars: MSStars, pad_to: int) -> MSStars:
    """stars padded to pad_to rows: pad stars carry star_mask 0, log_cm
    and log_1m_cm -1, obs_sigma -9 and zeros elsewhere, as make_ms_stars
    pads, so they add exactly 0 to the value and the gradient."""
    extra = pad_to - stars.n_stars

    def pad(x, val=0.0):
        return torch.cat([x, x.new_full((extra, *x.shape[1:]), val)])

    return MSStars(
        obs_over_var=pad(stars.obs_over_var),
        inv_var=pad(stars.inv_var),
        c0=pad(stars.c0),
        log_norm=pad(stars.log_norm),
        log_cm=pad(stars.log_cm, -1.0),
        log_1m_cm=pad(stars.log_1m_cm, -1.0),
        field_logdens=pad(stars.field_logdens),
        star_mask=pad(stars.star_mask),
        obs_mags=pad(stars.obs_mags),
        obs_sigma=pad(stars.obs_sigma, -9.0),
    )


def _local_stars(stars: MSStars | None, mesh: Mesh) -> MSStars | None:
    """This rank's slice of the stars, padded to a multiple of the star
    shards (a copy: the whole set can be dropped)."""
    if stars is None:
        return None
    require_one_set(stars, "the star-sharded density")
    n = mesh.n_star_shards
    S_pad = pad_to_multiple(stars.n_stars, n)
    if S_pad != stars.n_stars:
        stars = _repad_stars(stars, S_pad)
    k = S_pad // n
    return MSStars(**{f.name: getattr(stars, f.name)[mesh.si * k:
                                                     (mesh.si + 1) * k].clone()
                      for f in dataclasses.fields(MSStars)})


def shard_stars(model, mesh: Mesh):
    """The model with this rank's slice of its MS stars and WD stars (both
    padded to a multiple of the star shards); grids and the other fields
    stay whole.  Any model dataclass with `stars` / `wd_stars` fields
    (single- and two-population)."""
    return dataclasses.replace(model, stars=_local_stars(model.stars, mesh),
                               wd_stars=_local_stars(model.wd_stars, mesh))


def local_logpost_fn(model, stars_local: MSStars, star_group,
                     wd_local: MSStars | None = None) -> Callable:
    """This rank's log posterior, params [C, P] -> [C]: the local stars'
    log likelihood (MS marginal, and the WD branch with wd_local) summed
    over the star group, plus the prior; equal on every rank of the
    group, and so is its gradient (parallel.comm's enter / reduce_sum).
    With star_group None it is the model's own log_post."""
    local = dataclasses.replace(model, stars=stars_local, wd_stars=wd_local)

    def f(params: torch.Tensor) -> torch.Tensor:
        ll, in_bounds = _model_log_lik(local,
                                       comm.enter(params, star_group))
        ll = comm.reduce_sum(ll, star_group)
        lp = local.priors.log_prior(params)
        return torch.where(in_bounds, ll + lp, torch.full_like(lp, NEG_INF))

    return f


def _counted(fn: Callable) -> Callable:
    def f(x: torch.Tensor) -> torch.Tensor:
        global density_calls, density_rows
        density_calls += 1
        density_rows += x.shape[0]
        return fn(x)

    return f


def _logpost(model, mesh: Mesh) -> Callable:
    """The sharded density of constrained params on this rank."""
    local = shard_stars(model, mesh)
    return _counted(local_logpost_fn(local, local.stars, mesh.star_group,
                                     local.wd_stars))


def _logpost_z(model, transform, mesh: Mesh) -> Callable:
    """The sharded density of unconstrained z: logpost(x(z)) + log|J|."""
    local = shard_stars(model, mesh)
    base = local_logpost_fn(local, local.stars, mesh.star_group,
                            local.wd_stars)

    def f(z: torch.Tensor) -> torch.Tensor:
        return base(transform.forward(z)) + transform.log_det_jacobian(z)

    return _counted(f)


@torch.no_grad()
def logpost_at(model, transform, mesh: Mesh, z: torch.Tensor) -> torch.Tensor:
    """The density at every row of the unconstrained z [N, P], on every
    rank: each rank evaluates all rows on its stars."""
    return _logpost_z(model, transform, mesh)(z)


def make_sharded_hmc_fns(
    model,  # SinglePopModel | MultiPopModel
    transform,
    cfg: hmc_mod.HMCConfig,
    mesh: Mesh,
    chunk: int,
    *,
    checkpoint_path: str | None = None,
    on_window: Callable | None = None,
):
    """The counterpart of base_tpu's shard_map'd (warm, step) pair: the
    port's one HMC loop, driver.make_hmc_chunked_runner, on this rank's
    sharded density and chain block.  Returns `run(init_z [C_total, P],
    gen, inv_mass0=None) -> (samples [n_rec, C_total, P], info)`;
    `inv_mass0` warm-starts the warmup metric (e.g. a full-rank-VI
    covariance)."""
    return driver_mod.make_hmc_chunked_runner(
        _logpost_z(model, transform, mesh), cfg, chunk,
        checkpoint_path=checkpoint_path, on_window=on_window, mesh=mesh)


def run_hmc_sharded(model, transform, init_z: torch.Tensor,
                    gen: torch.Generator, cfg: hmc_mod.HMCConfig, mesh: Mesh,
                    inv_mass0: torch.Tensor | None = None):
    """HMC over the mesh, in one chunk.  Returns (z samples [n_rec,
    C_total, P], info) with info's accept_prob, step_size, inv_mass,
    logposts [n_rec, C_total] and final_states equal on every rank."""
    n_rec = cfg.n_samples // cfg.thin
    return make_sharded_hmc_fns(model, transform, cfg, mesh, n_rec)(
        init_z, gen, inv_mass0)


def run_hmc_sharded_checkpointed(
    model, transform, init_z: torch.Tensor, gen: torch.Generator,
    cfg: hmc_mod.HMCConfig, mesh: Mesh,
    dcfg: driver_mod.DriverConfig = driver_mod.DriverConfig(),
):
    """Sharded HMC in dcfg's chunks, with checkpoint/resume and the
    window hook: the whole run saved by rank 0 after every chunk, and a
    resumed run equal to an uninterrupted one bit for bit."""
    n_rec = cfg.n_samples // cfg.thin
    chunk = max(min(dcfg.chunk_size, n_rec), 1)
    return make_sharded_hmc_fns(
        model, transform, cfg, mesh, chunk,
        checkpoint_path=dcfg.checkpoint_path, on_window=dcfg.on_window,
    )(init_z, gen)


def run_nuts_sharded(model, transform, init_z: torch.Tensor,
                     gen: torch.Generator, cfg: nuts_mod.NUTSConfig,
                     mesh: Mesh):
    """NUTS over the mesh, run_hmc_sharded's contract (dual averaging
    and the metric pool over the chain group inside nuts.run_nuts);
    accept_prob and mean_leapfrogs are chain-group means."""
    g = mesh.chain_group
    zs, info = nuts_mod.run_nuts(
        _logpost_z(model, transform, mesh), mesh.chain_block(init_z),
        mesh.chain_generator(gen), cfg, group=g)
    return mesh.gather_chains(zs, 1), dict(
        accept_prob=comm.pmean(info["accept_prob"], g),
        step_size=info["step_size"], inv_mass=info["inv_mass"],
        mean_leapfrogs=comm.pmean(info["mean_leapfrogs"], g),
        logposts=mesh.gather_chains(info["logposts"], 1),
    )


def run_smc_sharded(model, transform, center_z: torch.Tensor,
                    gen: torch.Generator, cfg: smc_mod.SMCConfig, mesh: Mesh,
                    q0_sd: float = 0.5, n_rep: int = 1):
    """Tempered SMC over the mesh from q0 = N(center_z, q0_sd^2): every
    chain shard holds cfg.n_particles particles of each of n_rep
    replicates (folded into its particle axis, as run_smc_replicated),
    drawn from its chain shard's generator (distinct per chain shard,
    equal across star shards), and the stage statistics pool over the
    chain group (smc's `group`).  Returns (particles [n_rep * N_total, P],
    info): run_smc's info for one replicate, run_smc_replicated's for
    several."""
    P = center_z.shape[0]

    def log_q0(z):
        return (-0.5 * ((z - center_z) / q0_sd) ** 2 - math.log(q0_sd)
                - 0.9189385332046727).sum(-1)

    def sample_q0(g, n):
        return center_z[None, :] + q0_sd * torch.randn(
            (n, P), generator=g, device=center_z.device)

    g = mesh.chain_generator(gen)
    gens = [g] if n_rep == 1 else smc_mod.replicate_generators(g, n_rep)
    state, betas, accs, actives = smc_mod._run_stages(
        _logpost_z(model, transform, mesh), sample_q0, log_q0, gens, cfg,
        mesh.chain_group)
    particles = mesh.gather_chains(
        state.z.view(n_rep, cfg.n_particles, P), 1).reshape(-1, P)
    if n_rep == 1:
        return particles, smc_mod._single_info(state, betas, accs, actives,
                                               cfg.max_stages)
    info = smc_mod._replicated_info(state, betas, accs, actives, n_rep)
    info["betas"] = smc_mod._padded_betas(betas, cfg.max_stages)
    return particles, info


def run_vi_sharded(model, transform, z0: torch.Tensor, gen: torch.Generator,
                   cfg: vi_mod.VIConfig, mesh: Mesh,
                   chunk_steps: int = 100) -> vi_mod.VIResult:
    """ADVI over the mesh: stars shard inside the density, and every
    chain shard draws its own cfg.n_mc reparameterised samples a step
    (its chain shard's generator), the ELBO gradient pmean-ed over the
    chain group, so a c-way chain axis multiplies the MC sample count by
    c; the variational parameters stay equal on every rank.
    `chunk_steps` is base_tpu's, kept for its signature and unused, as in
    vi.run_vi_chunked: on the GPU no limit on one execution forces
    chunks."""
    noise = vi_mod._noise(mesh.chain_generator(gen), z0, cfg)
    return vi_mod.fit_vi(_logpost_z(model, transform, mesh), z0, noise, cfg,
                         group=mesh.chain_group)


def vi_warm_start_sharded(model, transform, z0: torch.Tensor,
                          gen: torch.Generator, n_chains: int, mesh: Mesh,
                          free_mask=None, cfg: vi_mod.VIConfig | None = None,
                          chunk_steps: int = 100):
    """vi.vi_warm_start over the mesh: (init_z [n_chains, P], inv_mass0
    [P, P], VIResult), the draws from `gen` after the fit (equal on every
    rank).  `chunk_steps` is unused (run_vi_sharded)."""
    res = run_vi_sharded(model, transform, z0, gen,
                         cfg or vi_mod.WARM_START_CFG, mesh, chunk_steps)
    return (*vi_mod.warm_start_draws(res, z0, gen, n_chains, free_mask),
            res)


def run_mh_sharded(model, init_position: torch.Tensor, gen: torch.Generator,
                   step_init: torch.Tensor, cfg: mh_mod.MHConfig, mesh: Mesh,
                   burn_model=None):
    """Reference-parity adaptive MH over the mesh: every chain shard runs
    its block with its chain shard's generator; stars sum inside the
    density.  `burn_model` (optional): a model over the useDuringBurnIn
    star subset, sharded over the same star axis, the target of stages
    1-2.  Returns (samples [n_rec, C_total, P], info) with the pooled
    accept_rate and logposts [n_rec, C_total]."""
    f_burn = None if burn_model is None else _logpost(burn_model, mesh)
    samples, info = mh_mod.run_adaptive_mh(
        _logpost(model, mesh), mesh.chain_block(init_position),
        mesh.chain_generator(gen), step_init, cfg, logpost_burnin_fn=f_burn)
    return mesh.gather_chains(samples, 1), dict(
        accept_rate=comm.pmean(info["accept_rate"].mean(), mesh.chain_group),
        logposts=mesh.gather_chains(info["logposts"], 1),
    )
