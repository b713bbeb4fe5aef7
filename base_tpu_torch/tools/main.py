"""CLI entry points mirroring the reference executables, on a CUDA device
(port of base_tpu.tools.main).

One `python -m base_tpu_torch.tools.main <tool>` per reference binary
[upstream: singlePopMcmc/, simCluster/, scatterCluster/, sampleMass/,
sampleWDMass/, makeCMD/, multiPopMcmc/ — SURVEY.md E1-E7]:

  simulate        simCluster: forward-model a cluster, write photometry
  scatter         scatterCluster: add noise/cutoffs, write sampler .phot
  single-pop      singlePopMcmc: posterior over cluster params (hmc,
                  nuts, smc, vi, or reference-parity adaptive mh), .res
  sample-mass     sampleMass: per-star (mass, ratio) conditionals
  sample-wd-mass  sampleWDMass: per-WD precursor/WD-mass conditionals
  make-cmd        makeCMD: model isochrone CMD at given params
  multi-pop       multiPopMcmc: the two-population model, .mp.res
  convert-models  pack upstream-format text grids into .npz (grids.parse)

Every tool shares one YAML config (+ `--set a.b=c` overrides), like the
reference's single base9.yaml [SURVEY.md C12]; base_tpu's configs and
files (.phot, .res, packed .npz grids) serve both packages unchanged.

Device: `--device` (default `cuda`) holds the grids, stars, chains and
generators; on a CUDA device the density runs through the CUDA kernels,
and mcmc.usePallas false is refused there.  With no CUDA device a tool
exits non-zero unless `--device cpu` asks for the CPU, where the kernels'
plain PyTorch versions run.  Nothing moves to the CPU on its own.

Random streams: base_tpu draws from `jax.random.PRNGKey(seed + j)` and
`fold_in(PRNGKey(seed), k)`.  Each becomes a `torch.Generator` on the
device, `PRNGKey(seed + j)` seeded `seed + j` and `fold_in(PRNGKey(seed),
k)` seeded `seed + k * 2**32` (`_gen`), with base_tpu's j and k:

  j = 0  simulate's cluster; the chains' start jitter (mh: its draws)
  j = 1  scatter's noise          j = 2  sample-mass
  j = 3  sample-wd-mass           j = 7  simulate's field stars
  k = 1  hmc / nuts               k = 2  smc
  k = 3  vi's fit                 k = 4  vi's posterior draws

The draws follow base_tpu's distributions, not its random bits.  MH runs
every chain in one batched density call a step (mh.run_adaptive_mh).

`--mesh C,S` (single-pop and multi-pop; the other tools ignore it, as
base_tpu's do) runs the sampler over a (chains x stars) mesh of C * S
ranks (base_tpu_torch.parallel): under `torchrun` the tool joins the
world it was started in and checks C * S == WORLD_SIZE; otherwise it
starts the C * S ranks itself (torch.multiprocessing, spawn), after
building the CUDA kernels once.  The backend follows
parallel.distributed's rule (NCCL with a card per rank, else gloo).  Every
sampler runs sharded (parallel.run): hmc through the chunked driver
(checkpointed with --resume), nuts, smc (mcmc.runIter particles over the
chain shards), vi (its Monte Carlo draws over the chain shards) and mh
(with the useDuringBurnIn model on the same star shards).  Chain shard ci
draws from `Mesh.chain_generator` of the generator above.  Rank 0 alone
writes the .res, the metrics and the checkpoint, and prints the summary.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from base_tpu_torch import constants as C
from base_tpu_torch.io import phot as photio
from base_tpu_torch.io import res as resio
from base_tpu_torch.io.settings import (Settings, load_settings,
                                        resolve_use_pallas)


def _common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", default=None, help="YAML settings file")
    parser.add_argument(
        "--set", action="append", default=[], metavar="a.b=c",
        help="dotted settings override (repeatable)",
    )
    parser.add_argument("--photFile", default=None)
    parser.add_argument("--outputFileBase", default=None)
    parser.add_argument("--modelDirectory", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the run (default cuda; cpu runs the "
             "kernels' plain PyTorch versions)",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the run to DIR",
    )
    parser.add_argument(
        "--debug", action="store_true",
        help="autograd anomaly mode with NaN checks: a NaN in a gradient "
             "raises, naming the forward operation that made it (slow)",
    )
    parser.add_argument(
        "--metrics", default=None, metavar="FILE.jsonl",
        help="append structured throughput metrics to FILE.jsonl",
    )
    parser.add_argument(
        "--mesh", default=None, metavar="C,S",
        help="shard over a (chains x stars) mesh of C*S ranks, e.g. 2,2",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="checkpoint to <outputFileBase>.ckpt and resume if present "
             "(hmc sampler)",
    )
    parser.add_argument(
        "--store", default=None, choices=("file", "sqlite"),
        help="chain-output backing store (files.store): 'sqlite' also "
             "writes <outputFileBase>.db",
    )


def _settings(args) -> Settings:
    s = load_settings(args.config, args.set)
    if args.photFile is not None:
        s.files.photFile = args.photFile
    if args.outputFileBase is not None:
        s.files.outputFileBase = args.outputFileBase
    if args.modelDirectory is not None:
        s.files.modelDirectory = args.modelDirectory
    if args.seed is not None:
        s.mcmc.seed = args.seed
    if getattr(args, "store", None) is not None:
        s.files.store = args.store
    return s


def _device(args) -> torch.device:
    mesh = _mesh(args)
    if mesh is not None:
        return mesh.device
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"{args.tool}: no CUDA device (torch.cuda.is_available() is "
            f"false); pass --device cpu to run the plain PyTorch path on "
            f"the CPU"
        )
    return dev


def _mesh(args):
    """The rank's parallel.mesh.Mesh of a sharded run, else None."""
    return getattr(args, "mesh_ctx", None)


def _lead(args) -> bool:
    """Whether this process writes the outputs: rank 0, or the only one."""
    mesh = _mesh(args)
    return mesh is None or mesh.rank == 0


def _gen(device: torch.device, seed: int, k: int = 0) -> torch.Generator:
    """The generator of base_tpu's fold_in(PRNGKey(seed), k); k = 0 is
    PRNGKey(seed) itself (module docstring)."""
    return torch.Generator(device=device).manual_seed(seed + k * 2**32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class _Counted:
    """A density with a count of its calls and of the rows (chains,
    particles) they evaluated."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0
        self.rows = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        self.rows += x.shape[0]
        return self.fn(x)


def cmd_simulate(args) -> None:
    from base_tpu_torch.grids.load import make_model
    from base_tpu_torch.sim.simulate import (simulate_cluster,
                                             simulate_field_stars)

    s = _settings(args)
    dev = _device(args)
    bundle = make_model(s, device=dev)
    params = torch.as_tensor(s.cluster.start_vector(), device=dev)
    cat = simulate_cluster(
        bundle.ms, params, s.simCluster.nStars, _gen(dev, s.mcmc.seed),
        percent_binary=s.simCluster.percentBinary,
        min_mass=s.simCluster.minMass,
        wd_cooling=bundle.wd_cooling, wd_atm=bundle.wd_atm,
        ifmr_kind=bundle.ifmr_kind,
        percent_db=s.simCluster.percentDB,
    )
    mags = _np(cat.mags)
    mass1 = _np(cat.mass1)
    mratio = _np(cat.mass_ratio)
    stage = _np(cat.stage)
    cm = np.full(mags.shape[0], 0.999, np.float32)
    n_field = s.simCluster.nFieldStars
    if n_field > 0:
        fmags = _np(simulate_field_stars(
            _gen(dev, s.mcmc.seed + 7), n_field, cat.mags))
        mags = np.concatenate([mags, fmags])
        mass1 = np.concatenate([mass1, np.ones(n_field, np.float32)])
        mratio = np.concatenate([mratio, np.zeros(n_field, np.float32)])
        stage = np.concatenate(
            [stage, np.full(n_field, C.StarStatus.MSRG, np.int32)]
        )
        cm = np.concatenate([cm, np.full(n_field, 0.01, np.float32)])
    table = photio.from_simulation(
        ids=None, bands=bundle.ms.bands,
        mags=mags,
        sigmas=np.zeros_like(mags),
        mass1=mass1,
        mass_ratio=mratio,
        stage=stage,
        cm_prior=cm,
    )
    out = s.files.outputFileBase + ".sim.phot"
    photio.write_phot(out, table)
    n_wd = int((stage == C.StarStatus.WD).sum())
    print(
        f"simulate: wrote {table.n_stars} stars ({n_wd} WDs, "
        f"{n_field} field) -> {out}"
    )


def cmd_scatter(args) -> None:
    from base_tpu_torch.sim.scatter import exposure_limits, scatter_cluster

    s = _settings(args)
    dev = _device(args)
    table = photio.read_phot(s.files.photFile)
    if s.scatterCluster.exposures:
        limits = exposure_limits(
            [float(x) for x in s.scatterCluster.exposures],
            base_limit=s.scatterCluster.limitMag, device=dev,
        )
    else:
        limits = s.scatterCluster.limitMag
    sc = scatter_cluster(
        torch.as_tensor(table.mags, device=dev), _gen(dev, s.mcmc.seed + 1),
        limit_mag=limits,
        bright_limit=s.scatterCluster.brightLimit,
        faint_limit=s.scatterCluster.faintLimit,
        sigma_floor=s.scatterCluster.sigmaFloor,
        relevant_filt=s.scatterCluster.relevantFilt,
    )
    table.mags = _np(sc.mags)
    table.sigmas = _np(sc.sigmas)
    out = s.files.outputFileBase + ".phot"
    photio.write_phot(out, table)
    print(f"scatter: wrote {table.n_stars} stars -> {out}")


def _active_bands(table, ms_grid, wd_atm=None):
    """Dynamic filter selection: active set = .phot header ∩ model bands
    (∩ atmosphere bands when WDs are present) [upstream: base9/Filters —
    SURVEY.md C13].  Returns (phot table, ms grid, wd atm) all sliced to
    the active set; errors clearly on an empty intersection."""
    from base_tpu_torch.grids import filters as filt
    from base_tpu_torch.grids.isochrone import select_grid_bands
    from base_tpu_torch.grids.wd_atmosphere import select_atm_bands

    active, phot_idx, ms_idx = filt.intersect_bands(table.bands, ms_grid.bands)
    if wd_atm is not None:
        active, sub_idx, atm_idx = filt.intersect_bands(active, wd_atm.bands)
        phot_idx, ms_idx = phot_idx[sub_idx], ms_idx[sub_idx]
    if not active:
        raise SystemExit(
            f"no overlapping filters: photometry has {list(table.bands)}, "
            f"model grid '{ms_grid.name}' has {list(ms_grid.bands)}"
            + (f", WD atmospheres have {list(wd_atm.bands)}" if wd_atm else "")
        )
    if tuple(active) != tuple(table.bands):
        table = table.select_bands(phot_idx, active)
    if tuple(active) != tuple(ms_grid.bands):
        ms_grid = select_grid_bands(ms_grid, ms_idx, active)
    if wd_atm is not None and tuple(active) != tuple(wd_atm.bands):
        wd_atm = select_atm_bands(wd_atm, atm_idx, active)
    return table, ms_grid, wd_atm


def _build_model_from_phot(s: Settings, table: photio.PhotTable,
                           device: torch.device):
    from base_tpu_torch.grids.load import make_model
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars, require_one_set

    bundle = make_model(s, device=device)
    stage = table.stage
    is_wd = stage == C.StarStatus.WD
    has_wd = bool(is_wd.any())
    table, ms_grid, wd_atm = _active_bands(
        table, bundle.ms, bundle.wd_atm if has_wd else None
    )
    bundle = bundle._replace(
        ms=ms_grid, wd_atm=wd_atm if has_wd else bundle.wd_atm
    )
    usable = (stage == C.StarStatus.MSRG) | is_wd
    ms_rows = table.select(usable & ~is_wd)
    wd_rows = table.select(is_wd)
    frange = s.cluster.field_mag_range_array(ms_rows.mags.shape[1])
    ms = make_ms_stars(ms_rows.mags, ms_rows.sigmas, cm_prior=ms_rows.cm_prior,
                       field_mag_range=frange,
                       sigma_model=s.mcmc.sigmaModel, device=device)
    require_one_set(ms, "the CLI (one --photFile)")
    wds = None
    if wd_rows.n_stars > 0:
        wds = make_ms_stars(
            wd_rows.mags, wd_rows.sigmas, cm_prior=wd_rows.cm_prior,
            field_mag_range=s.cluster.field_mag_range_array(
                wd_rows.mags.shape[1]),
            sigma_model=s.mcmc.sigmaModel, device=device,
        )
    return post.make_single_pop_model(
        bundle.ms, ms,
        prior_mean=s.cluster.prior_mean_vector(),
        prior_sigma=s.cluster.prior_sigma_vector(),
        n_q=s.mcmc.nMassRatio,
        binaries=not s.mcmc.noBinaries,
        wd_cooling=None if wds is None else bundle.wd_cooling,
        wd_atm=None if wds is None else bundle.wd_atm,
        wd_stars=wds,
        ifmr_kind=bundle.ifmr_kind,
        p_db=s.simCluster.percentDB,
        use_pallas=resolve_use_pallas(s.mcmc.usePallas, device),
        upsample=s.mcmc.upsample,
        device=device,
    )


def _announce_draws(s: Settings, n_chains: int) -> None:
    """Loud per-chain draw count: mcmc.runIter is TOTAL recorded draws
    across chains here (the reference's runIter is per its single chain
    — docs/MIGRATION.md), so a ported config would otherwise silently
    run n_chains x fewer draws per chain than its author expects."""
    per = s.mcmc.runIter // max(n_chains, 1)
    print(
        f"mcmc.runIter = {s.mcmc.runIter} TOTAL recorded draws across "
        f"{n_chains} chains -> {per} draws/chain (thin={s.mcmc.thin}; "
        f"reference runIter is per-chain — see docs/MIGRATION.md)"
    )


def _window_logger(mlog, names):
    """Streaming per-window diagnostics hook for the chunked driver:
    R-hat/ESS/acceptance per recorded window, not one post-hoc row
    (SURVEY.md §5 metrics plan).  In a sharded run every rank gets the
    hook (the driver gathers the window on all of them); only rank 0 has
    a logger."""
    from base_tpu_torch.inference import diagnostics as diag

    def on_window(ci, zs, lps):
        if mlog is None:
            return
        rhat = _np(diag.split_rhat(zs))
        ess = _np(diag.ess(zs))
        mlog.log(
            "window",
            window=ci,
            n=int(zs.shape[0]) * int(zs.shape[1]),
            logpost_mean=float(lps.mean()),
            **{f"rhat_{n}": float(rhat[i]) for i, n in enumerate(names)},
            **{f"ess_{n}": float(ess[i]) for i, n in enumerate(names)},
        )

    return on_window


def _start_chains(z0: torch.Tensor, n_chains: int, s: Settings):
    """n_chains copies of the start z0 [P], jittered by 0.02 sd."""
    return z0[None, :] + 0.02 * torch.randn(
        (n_chains, z0.shape[0]), generator=_gen(z0.device, s.mcmc.seed),
        device=z0.device)


def _run_hmc(fz, init, s: Settings, n_chains: int, free_mask,
             ckpt_path: str | None, on_window=None, sharded=None):
    """HMC through the host-chunked driver, in chunks of a quarter of the
    draws (at most 100): checkpointed to ckpt_path (--resume) and / or
    reporting each chunk to on_window (--metrics) when they are given.
    `sharded` (model, transform, mesh) runs it over the mesh
    (parallel.run) instead of on the density fz.  Returns (zs [N, C, P],
    info)."""
    from base_tpu_torch.inference.driver import (DriverConfig,
                                                 make_hmc_chunked_runner)
    from base_tpu_torch.inference.hmc import HMCConfig

    n_draws = s.mcmc.runIter // n_chains
    cfg = HMCConfig(
        n_warmup=s.mcmc.warmup,
        n_samples=n_draws,
        thin=s.mcmc.thin, l_max=s.mcmc.lMax,
        target_accept=s.mcmc.targetAccept,
        dense_mass=s.mcmc.denseMass,
        free_mask=free_mask,
    )
    chunk = max(min(100, n_draws // 4), 1)
    gen = _gen(init.device, s.mcmc.seed, 1)
    if sharded is not None:
        from base_tpu_torch.parallel import run as prun

        model, tr, mesh = sharded
        return prun.run_hmc_sharded_checkpointed(
            model, tr, init, gen, cfg, mesh,
            DriverConfig(checkpoint_path=ckpt_path, chunk_size=chunk,
                         on_window=on_window))
    runner = make_hmc_chunked_runner(
        fz, cfg, chunk, checkpoint_path=ckpt_path, on_window=on_window)
    return runner(init, gen)


def _run_nuts(fz, init, s: Settings, n_chains: int, free_mask,
              sharded=None):
    from base_tpu_torch.inference.nuts import (NUTSConfig,
                                               make_nuts_chunked_runner)

    ncfg = NUTSConfig(
        n_warmup=s.mcmc.warmup, n_samples=s.mcmc.runIter // n_chains,
        thin=s.mcmc.thin, target_accept=s.mcmc.targetAccept,
        dense_mass=s.mcmc.denseMass, free_mask=free_mask,
    )
    gen = _gen(init.device, s.mcmc.seed, 1)
    if sharded is not None:
        from base_tpu_torch.parallel import run as prun

        model, tr, mesh = sharded
        return prun.run_nuts_sharded(model, tr, init, gen, ncfg, mesh)
    return make_nuts_chunked_runner(fz, ncfg)(init, gen)


def _run_smc(fz, z0: torch.Tensor, s: Settings, sharded=None):
    """Tempered SMC from N(z0, 0.5^2): 4 replicates folded into the
    particle axis, with a repeat-run evidence SE; sharded, one run whose
    max(runIter, 256) particles split over the chain shards, as base_tpu
    runs it.  Returns (particles [N, P], info)."""
    from base_tpu_torch.inference.smc import SMCConfig, make_smc_chunked_runner

    n_part = max(s.mcmc.runIter, 256)
    sd0 = 0.5
    gen = _gen(z0.device, s.mcmc.seed, 2)
    if sharded is not None:
        from base_tpu_torch.parallel import run as prun

        model, tr, mesh = sharded
        scfg = SMCConfig(n_particles=max(n_part // mesh.n_chain_shards, 64))
        return prun.run_smc_sharded(model, tr, z0, gen, scfg, mesh,
                                    q0_sd=sd0)

    def log_q0(z):
        return (-0.5 * ((z - z0) / sd0) ** 2 - math.log(sd0)
                - 0.9189385).sum(-1)

    def sample_q0(g, n):
        return z0[None, :] + sd0 * torch.randn(
            (n, z0.shape[0]), generator=g, device=z0.device)

    n_rep = 4
    scfg = SMCConfig(n_particles=max(n_part // n_rep, 64))
    return make_smc_chunked_runner(fz, sample_q0, log_q0, scfg,
                                   n_rep=n_rep)(gen)


def _run_vi(fz, z0: torch.Tensor, s: Settings, sharded=None):
    """Full-rank ADVI (sharded: run_vi_sharded), then max(runIter, 256)
    posterior draws.  Returns (draws [N, P], VIResult)."""
    from base_tpu_torch.inference.vi import VIConfig, run_vi, sample_posterior

    vcfg = VIConfig(n_steps=max(s.mcmc.warmup * 3, 600), full_rank=True)
    gen = _gen(z0.device, s.mcmc.seed, 3)
    if sharded is not None:
        from base_tpu_torch.parallel import run as prun

        model, tr, mesh = sharded
        res = prun.run_vi_sharded(model, tr, z0, gen, vcfg, mesh)
    else:
        res = run_vi(fz, z0, gen, vcfg)
    n_draw = max(s.mcmc.runIter, 256)
    return sample_posterior(res, _gen(z0.device, s.mcmc.seed, 4), n_draw), res


def _run_mh(f, f_burn, start: np.ndarray, step0: np.ndarray, s: Settings,
            n_chains: int, device: torch.device, sharded=None):
    """Reference-parity 3-stage adaptive MH on every chain at once;
    `sharded` (model, burn model or None, mesh) runs it over the mesh.
    Returns (xs [N, C, P], lps [N, C], accept)."""
    from base_tpu_torch.inference.mh import MHConfig, run_adaptive_mh

    cfg = MHConfig(
        n_stage1=s.mcmc.stage1Iter, n_stage2=s.mcmc.stage2IterMax,
        n_main=s.mcmc.runIter // n_chains, thin=s.mcmc.thin,
    )
    init = torch.as_tensor(start, device=device)[None, :].repeat(n_chains, 1)
    gen = _gen(device, s.mcmc.seed)
    step = torch.as_tensor(step0, device=device)
    if sharded is not None:
        from base_tpu_torch.parallel import run as prun

        model, burn_model, mesh = sharded
        xs, info = prun.run_mh_sharded(model, init, gen, step, cfg, mesh,
                                       burn_model=burn_model)
        return xs, info["logposts"], float(info["accept_rate"])
    xs, info = run_adaptive_mh(f, init, gen, step, cfg,
                               logpost_burnin_fn=f_burn)
    return xs, info["logposts"], float(info["accept_rate"].mean())


def _density_counts(counters, mesh) -> tuple[int, int]:
    """(density calls, rows evaluated): the counted densities', or in a
    sharded run this rank's calls and the rows of every chain shard
    (parallel.run's counters; collective over the chain group)."""
    if mesh is None:
        return sum(c.calls for c in counters), sum(c.rows for c in counters)
    from base_tpu_torch.parallel import comm
    from base_tpu_torch.parallel import run as prun

    rows = comm.psum(torch.tensor(float(prun.density_rows)),
                     mesh.chain_group)
    return prun.density_calls, int(rows)


def cmd_single_pop(args) -> None:
    from base_tpu_torch.inference import diagnostics as diag
    from base_tpu_torch.model import posterior as post

    s = _settings(args)
    dev = _device(args)
    mesh = _mesh(args)
    lead = _lead(args)
    table = photio.read_phot(s.files.photFile)
    model = _build_model_from_phot(s, table, dev)
    start = s.cluster.start_vector()
    n_chains = s.mcmc.chains
    if lead:
        _announce_draws(s, n_chains)
    resume = bool(getattr(args, "resume", False))
    ckpt_path = s.files.outputFileBase + ".ckpt" if resume else None
    if resume and s.mcmc.sampler != "hmc" and lead:
        print(
            f"single-pop: --resume is checkpointed-HMC only; "
            f"sampler={s.mcmc.sampler} runs without checkpoints",
            file=sys.stderr,
        )
    mlog = None
    if args.metrics and lead:
        from base_tpu_torch.utils.metrics import MetricsLogger

        mlog = MetricsLogger(args.metrics)
    if mesh is not None:
        from base_tpu_torch.parallel import run as prun

        prun.reset_counts()
    counters = []
    t_sample0 = time.perf_counter()

    if s.mcmc.sampler in ("hmc", "nuts", "smc", "vi"):
        tr = post.default_transform(model)
        fz = None
        if mesh is None:
            fz = _Counted(post.make_logpost_z_fn(model, tr))
            counters.append(fz)
        xs, lps, accept = _sample_z(
            fz, tr, start, s, n_chains, post.free_mask(model), dev,
            ckpt_path, (_window_logger(mlog, C.PARAM_NAMES)
                        if args.metrics else None),
            sharded=None if mesh is None else (model, tr, mesh))
    else:
        # Reference-style per-param step scales, masked by the shared
        # sampled-parameter helper so MH frees exactly what HMC/NUTS do
        # (incl. the quadratic IFMR coefficient under ifmr=quadratic).
        step0 = np.array(
            [0.05, 0.02, 0.05, 0.05, 0.03, 0.02, 0.02, 0.02, 0.005],
            np.float32,
        ) * np.asarray(post.free_mask(model), np.float32)
        # useDuringBurnIn: stages 1-2 target only the flagged stars
        # (reference C3/C14 semantics); stage 3 uses everything.
        burn_model = None
        if (table.use_dbi == 0).any():
            burn_model = _build_model_from_phot(
                s, table.select(table.use_dbi != 0), dev
            )
        if mesh is None:
            f = _Counted(post.make_logpost_fn(model))
            f_burn = (None if burn_model is None
                      else _Counted(post.make_logpost_fn(burn_model)))
            counters += [c for c in (f, f_burn) if c is not None]
            xs, lps, accept = _run_mh(f, f_burn, start, step0, s, n_chains,
                                      dev)
        else:
            xs, lps, accept = _run_mh(None, None, start, step0, s, n_chains,
                                      dev, sharded=(model, burn_model, mesh))

    xs_np, lps_np = _np(xs), _np(lps).reshape(xs.shape[0], -1)
    wall = time.perf_counter() - t_sample0
    calls, rows = _density_counts(counters, mesh)
    if not lead:
        return
    out = s.files.outputFileBase + ".res"
    resio.write_res(out, xs_np, lps_np)
    if s.files.store == "sqlite":
        from base_tpu_torch.io.sqlite_store import write_res_sqlite

        db = s.files.outputFileBase + ".db"
        write_res_sqlite(
            db, xs_np, lps_np,
            meta={"sampler": s.mcmc.sampler, "seed": s.mcmc.seed,
                  "chains": s.mcmc.chains, "tool": "single-pop"},
        )
        print(f"  sqlite store -> {db}")
    summ = diag.summarize(xs, C.PARAM_NAMES)
    if mlog is not None:
        # evals: density rows evaluated (chains x calls, warmup included),
        # counted at the density, not estimated from l_max.
        mlog.throughput(
            "single-pop", n_samples=xs.shape[0] * xs.shape[1],
            n_evals=rows, seconds=wall,
            sampler=s.mcmc.sampler, accept=accept,
            density_calls=calls,
            ess_age=float(summ["ess"][0]), rhat_age=float(summ["rhat"][0]),
            stars=int(table.n_stars), chains=n_chains, device=str(dev),
            **({} if mesh is None else dict(
                mesh=f"{mesh.n_chain_shards},{mesh.n_star_shards}",
                backend=mesh.backend)),
        )
        mlog.close()
    print(f"single-pop ({s.mcmc.sampler}): {xs.shape[0]}x{xs.shape[1]} "
          f"samples -> {out}")
    if mesh is not None:
        print(f"  {mesh.describe()}")
    print(f"  accept={accept:.3f}")
    for i, name in enumerate(C.PARAM_NAMES[:6]):
        print(
            f"  {name:12s} mean={summ['mean'][i]: .4f} sd={summ['sd'][i]:.4f}"
            f" rhat={summ['rhat'][i]:.3f} ess={summ['ess'][i]:.0f}"
        )


def _sample_z(fz, tr, start: np.ndarray, s: Settings, n_chains: int,
              free_mask, device: torch.device, ckpt_path: str | None = None,
              on_window=None, sharded=None):
    """The gradient-based samplers on the density fz of unconstrained z,
    through the transform `tr`: mcmc.sampler nuts, smc, vi, or else hmc;
    `sharded` (model, tr, mesh) runs them over the mesh instead (fz
    unused).  Returns (xs [N, C, P] constrained, lps [N, C], accept); smc
    and vi give their particles / draws as N rows of one chain, and
    accept is the move acceptance (smc) or the final ELBO (vi)."""
    z0 = tr.inverse(torch.as_tensor(start, device=device))
    lead = sharded is None or sharded[2].rank == 0
    if s.mcmc.sampler in ("smc", "vi"):
        if s.mcmc.sampler == "smc":
            z_part, info = _run_smc(fz, z0, s, sharded)
            accept = float(info["accept"])
            se = (f" +- {float(info['log_evidence_se']):.2f}"
                  if "log_evidence_se" in info else "")
            if lead:
                print(
                    f"  smc: log_evidence={float(info['log_evidence']):.2f}"
                    f"{se} stages={int(info['n_stages'])} "
                    f"move_accept={accept:.2f} "
                    f"move_scale={float(info['move_scale']):.3f}"
                )
        else:
            z_part, res = _run_vi(fz, z0, s, sharded)
            accept = float(res.final_elbo)
            if lead:
                print(f"  vi: final ELBO={accept:.2f}")
        if sharded is None:
            with torch.no_grad():
                lps = fz(z_part)
        else:
            from base_tpu_torch.parallel import run as prun

            lps = prun.logpost_at(*sharded, z_part)
        return tr.forward(z_part)[:, None, :], lps[:, None], accept
    init = _start_chains(z0, n_chains, s)
    if s.mcmc.sampler == "nuts":
        zs, info = _run_nuts(fz, init, s, n_chains, free_mask, sharded)
    else:
        zs, info = _run_hmc(fz, init, s, n_chains, free_mask, ckpt_path,
                            on_window, sharded)
    return tr.forward(zs), info["logposts"], float(info["accept_prob"])


def cmd_sample_mass(args) -> None:
    from base_tpu_torch.io.samples import write_star_samples
    from base_tpu_torch.model import conditionals as cond

    s = _settings(args)
    dev = _device(args)
    table = photio.read_phot(s.files.photFile)
    model = _build_model_from_phot(s, table, dev)
    chain = resio.read_res(s.files.outputFileBase + ".res")
    thin = max(len(chain.params) // 200, 1)
    draws = torch.as_tensor(chain.params[::thin], device=dev)
    out = cond.sample_ms_masses(model, draws, _gen(dev, s.mcmc.seed + 2))
    ids = table.select(table.stage == C.StarStatus.MSRG).ids
    path = s.files.outputFileBase + ".massSamples"
    write_star_samples(
        path, ids,
        {"mass": _np(out.mass1), "massRatio": _np(out.mass_ratio)},
    )
    mpath = s.files.outputFileBase + ".membership"
    p_member = _np(out.p_member)
    write_star_samples(mpath, ids, {"pMember": p_member}, fmt="%.5f")
    print(
        f"sample-mass: {draws.shape[0]} draws x {out.mass1.shape[1]} stars "
        f"-> {path} (+ membership -> {mpath})"
    )
    pm = p_member.mean(0)
    lo = np.argsort(pm)[: min(5, len(pm))]
    for i in lo:
        if pm[i] < 0.5:
            print(f"  likely field star {ids[i]}: P(member)={pm[i]:.3f}")


def cmd_sample_wd_mass(args) -> None:
    from base_tpu_torch.io.samples import write_star_samples
    from base_tpu_torch.model import conditionals as cond

    s = _settings(args)
    dev = _device(args)
    table = photio.read_phot(s.files.photFile)
    model = _build_model_from_phot(s, table, dev)
    if model.wd_stars is None:
        print("sample-wd-mass: no WD stars in photometry", file=sys.stderr)
        sys.exit(1)
    chain = resio.read_res(s.files.outputFileBase + ".res")
    thin = max(len(chain.params) // 200, 1)
    draws = torch.as_tensor(chain.params[::thin], device=dev)
    out = cond.sample_wd_masses(model, draws, _gen(dev, s.mcmc.seed + 3))
    ids = table.select(table.stage == C.StarStatus.WD).ids
    path = s.files.outputFileBase + ".wdMassSamples"
    write_star_samples(
        path, ids,
        {"zamsMass": _np(out.zams_mass),
         "wdMass": _np(out.wd_mass),
         "logCoolAge": _np(out.log_cool_age),
         "isDB": _np(out.is_db).astype(np.float32),
         "pMember": _np(out.p_member)},
    )
    print(
        f"sample-wd-mass: {draws.shape[0]} draws x {out.zams_mass.shape[1]} "
        f"WDs -> {path}"
    )


def _build_multi_pop_model(s: Settings, table: photio.PhotTable,
                           device: torch.device):
    """The two-population model of a .phot: its MS stars, its WDs (both
    populations' precursors, lambda-mixed), the 12-vector priors and
    start, with NaN multiPop starts and priors derived from cluster Y.
    Returns (model, start [12], the MH step scales [12])."""
    from base_tpu_torch.grids.load import make_model
    from base_tpu_torch.model import multipop as mp
    from base_tpu_torch.model.stardata import make_ms_stars

    bundle = make_model(s, device=device)
    rows = table.select(table.stage == C.StarStatus.MSRG)
    stars = make_ms_stars(rows.mags, rows.sigmas, cm_prior=rows.cm_prior,
                          field_mag_range=s.cluster.field_mag_range_array(
                              rows.mags.shape[1]),
                          sigma_model=s.mcmc.sigmaModel, device=device)
    wd_kwargs = {}
    wd_rows = table.select(table.stage == C.StarStatus.WD)
    if wd_rows.n_stars > 0:
        wd_kwargs = dict(
            wd_cooling=bundle.wd_cooling,
            wd_atm=bundle.wd_atm,
            wd_stars=make_ms_stars(
                wd_rows.mags, wd_rows.sigmas, cm_prior=wd_rows.cm_prior,
                field_mag_range=s.cluster.field_mag_range_array(
                    wd_rows.mags.shape[1]),
                device=device,
            ),
            ifmr_kind=bundle.ifmr_kind,
            p_db=s.simCluster.percentDB,
        )

    start9 = s.cluster.start_vector()
    y0 = float(start9[C.Param.YYY])
    # multiPop section [upstream: Settings multiPop YA/YB/lambda starts &
    # steps — SURVEY.md C12]: NaN starts/priors derive from cluster Y.
    mpset = s.multiPop
    ya0 = mpset.startY_A if np.isfinite(mpset.startY_A) else y0 - 0.02
    yb0 = mpset.startY_B if np.isfinite(mpset.startY_B) else y0 + 0.02
    if not ya0 < yb0:
        # The ordered transform's inverse needs dY > 0; an inverted
        # start would silently produce NaN initial positions.
        print(
            f"multi-pop: startY_A ({ya0}) must be < startY_B ({yb0}) — "
            f"the populations are identified by Y_A < Y_B",
            file=sys.stderr,
        )
        raise SystemExit(2)
    lam0 = float(np.clip(mpset.startLambda, 1e-3, 1.0 - 1e-3))
    pm_ya = mpset.priorY_A if np.isfinite(mpset.priorY_A) else ya0
    pm_yb = mpset.priorY_B if np.isfinite(mpset.priorY_B) else yb0
    prior_mean = np.concatenate(
        [s.cluster.prior_mean_vector(),
         np.asarray([pm_ya, pm_yb, mpset.priorLambda], np.float32)]
    )
    prior_sigma = np.concatenate(
        [s.cluster.prior_sigma_vector(),
         np.asarray([mpset.priorY_A_sigma, mpset.priorY_B_sigma,
                     mpset.priorLambda_sigma], np.float32)]
    )
    model = mp.make_multipop_model(
        bundle.ms, stars, prior_mean, prior_sigma,
        n_q=s.mcmc.nMassRatio, binaries=not s.mcmc.noBinaries,
        use_pallas=resolve_use_pallas(s.mcmc.usePallas, device),
        upsample=s.mcmc.upsample, device=device,
        **wd_kwargs,
    )
    start = np.concatenate(
        [start9, np.asarray([ya0, yb0, lam0], np.float32)]
    )
    step = np.zeros(mp.NPARAMS_MP, np.float32)
    step[[0, 2, 3, 4]] = [0.05, 0.05, 0.05, 0.03]
    step[mp.MP_YYA] = mpset.stepY_A
    step[mp.MP_YYB] = mpset.stepY_B
    step[mp.MP_LAMBDA] = mpset.stepLambda
    return model, start, step


def cmd_multi_pop(args) -> None:
    """Two-population helium-spread sampler (multiPopMcmc analog).

    All five samplers run here: hmc (default) and nuts gradient-sample
    through the ORDERED (Y_A, dY>0) transform (the label-switching mode
    is cut away by the bijection); smc runs tempered SMC with a
    replicated evidence estimate; vi fits full-rank ADVI; mh is the
    reference-parity 3-stage adaptive MH on the constrained 12-vector.
    WDs in the .phot evaluate against both populations' precursor chains
    (lambda-mixed)."""
    from base_tpu_torch.inference import diagnostics as diag
    from base_tpu_torch.model import multipop as mp

    s = _settings(args)
    dev = _device(args)
    mesh = _mesh(args)
    table = photio.read_phot(s.files.photFile)
    model, start, step0 = _build_multi_pop_model(s, table, dev)
    n_chains = s.mcmc.chains
    if _lead(args):
        _announce_draws(s, n_chains)
    resume = bool(getattr(args, "resume", False))
    ckpt_path = s.files.outputFileBase + ".mp.ckpt" if resume else None
    if resume and s.mcmc.sampler != "hmc" and _lead(args):
        print(
            f"multi-pop: --resume is checkpointed-HMC only; "
            f"sampler={s.mcmc.sampler} runs without checkpoints",
            file=sys.stderr,
        )

    if s.mcmc.sampler == "mh":
        if mesh is None:
            xs, lps, accept = _run_mh(mp.make_logpost_fn(model), None, start,
                                      step0, s, n_chains, dev)
        else:
            xs, lps, accept = _run_mh(None, None, start, step0, s, n_chains,
                                      dev, sharded=(model, None, mesh))
    else:
        tr = mp.ordered_transform(model)
        fz = None if mesh is not None else mp.make_logpost_z_fn(model, tr)
        xs, lps, accept = _sample_z(
            fz, tr, start, s, n_chains, mp.free_mask(model), dev, ckpt_path,
            sharded=None if mesh is None else (model, tr, mesh))
    xs_np, lps_np = _np(xs), _np(lps).reshape(xs.shape[0], -1)
    if not _lead(args):
        return

    out = s.files.outputFileBase + ".mp.res"
    cols = list(mp.MP_PARAM_NAMES) + ["logPost", "chain"]
    with open(out, "w") as f:
        f.write(" ".join(cols) + "\n")
        for n in range(xs_np.shape[0]):
            for c in range(xs_np.shape[1]):
                row = [f"{v:.6f}" for v in xs_np[n, c]]
                row += [f"{lps_np[n, c]:.4f}", str(c)]
                f.write(" ".join(row) + "\n")
    if s.files.store == "sqlite":
        from base_tpu_torch.io.sqlite_store import write_res_sqlite

        db = s.files.outputFileBase + ".db"
        write_res_sqlite(
            db, xs_np, lps_np, columns=tuple(mp.MP_PARAM_NAMES),
            meta={"sampler": s.mcmc.sampler, "seed": s.mcmc.seed,
                  "chains": s.mcmc.chains, "tool": "multi-pop"},
        )
        print(f"  sqlite store -> {db}")
    summ = diag.summarize(xs, mp.MP_PARAM_NAMES)
    print(
        f"multi-pop ({s.mcmc.sampler}): {xs.shape[0]}x{xs.shape[1]} "
        f"samples -> {out}"
    )
    print(f"  accept={accept:.3f}")
    for i in [0, 2, 3, 4, mp.MP_YYA, mp.MP_YYB, mp.MP_LAMBDA]:
        name = mp.MP_PARAM_NAMES[i]
        print(
            f"  {name:12s} mean={summ['mean'][i]: .4f} "
            f"sd={summ['sd'][i]:.4f} rhat={summ['rhat'][i]:.3f}"
        )


@torch.no_grad()
def cmd_make_cmd(args) -> None:
    """Write the model CMD sequence at the truth parameters: upsampled
    MS/RGB isochrone plus the WD cooling sequence [upstream: makeCMD —
    SURVEY.md E7]."""
    from base_tpu_torch.grids import filters as filt
    from base_tpu_torch.grids.isochrone import (derive_isochrone,
                                                upsample_isochrone)
    from base_tpu_torch.grids.load import make_model

    s = _settings(args)
    dev = _device(args)
    bundle = make_model(s, device=dev)
    p = s.cluster.start_vector()
    pt = torch.as_tensor(p, device=dev)
    iso = derive_isochrone(
        bundle.ms, pt[None, C.Param.FEH], pt[None, C.Param.YYY],
        pt[None, C.Param.AGE]
    )
    # Exact (piecewise-linear) refinement so the written sequence is a
    # smooth curve rather than the raw EEP nodes.
    iso = upsample_isochrone(iso, factor=4)
    dist = p[C.Param.MOD] + p[C.Param.ABS] * filt.absorption_coefs(
        bundle.ms.bands
    )
    app = _np(iso.mags[0]) + dist[None, :]
    valid = _np(iso.valid[0]) > 0.5
    out = s.files.outputFileBase + ".cmd"
    with open(out, "w") as f:
        f.write("stage mass " + " ".join(bundle.ms.bands) + "\n")
        for m, row in zip(_np(iso.mass[0])[valid], app[valid]):
            f.write(f"MS {m:.6f} "
                    + " ".join(f"{v:.4f}" for v in row) + "\n")
        n_wd = 0
        if bundle.wd_cooling is not None and bundle.wd_atm is not None:
            from base_tpu_torch.model import ifmr as ifmr_mod
            from base_tpu_torch.model import wd as wd_mod

            # WD sequence: ZAMS masses from just above the AGB tip to the
            # max precursor mass, evolved through IFMR -> cooling ->
            # atmosphere (DA) exactly as the likelihood's WD branch.
            tip = float(iso.agb_tip[0])
            start = tip * 1.01
            if start >= float(C.MAX_WD_PRECURSOR_MASS):
                # Young cluster: the AGB tip already exceeds the largest
                # WD precursor — there is no WD sequence to draw (an
                # increasing linspace from here would fabricate one).
                print(f"make-cmd: {valid.sum()} MS nodes + 0 WD nodes "
                      f"(AGB tip {tip:.2f} above max precursor) -> {out}")
                return
            prec_m = torch.linspace(start, float(C.MAX_WD_PRECURSOR_MASS),
                                    64, device=dev)
            prec = wd_mod.wd_prec_logage(
                bundle.ms, pt[None, C.Param.FEH], pt[None, C.Param.YYY],
                prec_m)[0]
            log_cool = wd_mod.cooling_log_age(prec, pt[C.Param.AGE])
            m_wd = ifmr_mod.ifmr_mass(bundle.ifmr_kind, prec_m, pt)
            # A node is real only when the cooling and atmosphere
            # interpolations are both in their hulls: the same validity
            # rule as the likelihood's WD branch (model.wd).
            mda, _, _, inside = wd_mod.wd_photometry(
                bundle.wd_cooling, bundle.wd_atm, pt[C.Param.CARBONICITY],
                m_wd, log_cool)
            wd_app = _np(mda) + dist[None, :]
            for m, row, good in zip(_np(prec_m), wd_app, _np(inside)):
                if good and np.isfinite(row).all():
                    f.write(f"WD {m:.6f} "
                            + " ".join(f"{v:.4f}" for v in row) + "\n")
                    n_wd += 1
    print(f"make-cmd: {valid.sum()} MS nodes + {n_wd} WD nodes -> {out}")


def cmd_convert_models(args) -> None:
    """Pack upstream-format text grids into the .npz containers load.py
    serves (ingestion pipeline for the separately-distributed model data,
    SURVEY.md L0/§7 step 0).  Host work: no device is used."""
    from base_tpu_torch.grids.parse import convert_model_directory

    s = _settings(args)
    src = args.src or s.files.modelDirectory
    dst = args.dst or s.files.modelDirectory
    if not src or not dst:
        raise SystemExit("convert-models: pass --src <textdir> --dst "
                         "<npzdir> (or set modelDirectory)")
    written = convert_model_directory(src, dst)
    for w in written:
        print(f"convert-models: wrote {w}")
    if not written:
        print("convert-models: no recognized grid files found")


TOOLS = {
    "simulate": cmd_simulate,
    "scatter": cmd_scatter,
    "single-pop": cmd_single_pop,
    "multi-pop": cmd_multi_pop,
    "sample-mass": cmd_sample_mass,
    "sample-wd-mass": cmd_sample_wd_mass,
    "make-cmd": cmd_make_cmd,
    "convert-models": cmd_convert_models,
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="base-tpu-torch")
    sub = parser.add_subparsers(dest="tool", required=True)
    for name in TOOLS:
        p = sub.add_parser(name)
        _common(p)
        if name == "convert-models":
            p.add_argument("--src", default=None,
                           help="directory of upstream-format text grids")
            p.add_argument("--dst", default=None,
                           help="output directory for packed .npz grids")
    args = parser.parse_args(argv)
    shape = _parse_mesh(args.mesh) if args.tool in MESH_TOOLS else None
    if shape is None:
        _run_tool(args)
    else:
        _run_sharded(args, shape)


def _run_tool(args) -> None:
    from base_tpu_torch.utils.metrics import (debug_guards, named_scope,
                                              profile_trace)

    # The tool's whole run is one range named after it in the trace (rank
    # 0's, in a sharded run).
    with profile_trace(args.profile if _lead(args) else None), \
            named_scope(args.tool), debug_guards(args.debug):
        TOOLS[args.tool](args)


# The tools that take --mesh; the others ignore it, as base_tpu's do.
MESH_TOOLS = ("single-pop", "multi-pop")


def _parse_mesh(spec: str | None):
    """--mesh C,S -> (C, S) (C alone: S = 1); None when no mesh was
    requested."""
    if not spec:
        return None
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        parts = []
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2 or min(parts) < 1:
        raise SystemExit(f"--mesh wants C,S (got {spec!r})")
    return tuple(parts)


def _rank_main(rank: int, args, shape: tuple, init_method: str) -> None:
    """One rank of a sharded run: join the world, build the mesh, run the
    tool, leave.  (torch.multiprocessing's entry point; rank first.)"""
    from base_tpu_torch.parallel import distributed
    from base_tpu_torch.parallel.mesh import make_mesh

    if init_method == "env://":       # torchrun's world
        distributed.initialize(args.device)
    else:
        world = shape[0] * shape[1]
        distributed.initialize(args.device, init_method=init_method,
                               world_size=world, rank=rank, local_rank=rank,
                               local_world_size=world)
    try:
        args.mesh_ctx = make_mesh(*shape)
        _run_tool(args)
    finally:
        distributed.shutdown()


def _run_sharded(args, shape: tuple) -> None:
    """The tool over a C x S mesh: in the world torchrun started (its
    WORLD_SIZE must be C * S), or in C * S ranks started here."""
    import os

    world = shape[0] * shape[1]
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise SystemExit(
                f"{args.tool}: --mesh {shape[0]},{shape[1]} needs "
                f"{world} ranks; torchrun started "
                f"{os.environ['WORLD_SIZE']}")
        _rank_main(int(os.environ["RANK"]), args, shape, "env://")
        return
    import shutil
    import tempfile

    import torch.multiprocessing as tmp

    if _device(args).type == "cuda":
        # Build the kernels once, before the ranks start.
        from base_tpu_torch.ops import build

        build.build()
    store = tempfile.mkdtemp(prefix="btt_mesh_")
    init_method = f"file://{os.path.join(store, 'store')}"
    try:
        if world == 1:
            _rank_main(0, args, shape, init_method)
        else:
            tmp.start_processes(_rank_main, args=(args, shape, init_method),
                                nprocs=world, start_method="spawn")
    except tmp.ProcessException as e:
        raise SystemExit(f"{args.tool}: rank {e.error_index} of the "
                         f"{shape[0]}x{shape[1]} mesh failed: {e}") from None
    finally:
        shutil.rmtree(store, ignore_errors=True)


if __name__ == "__main__":
    main()
