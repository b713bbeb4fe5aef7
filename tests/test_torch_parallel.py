"""The port's parallel layer (base_tpu_torch.parallel) on the CPU: a
spawned world of 4 gloo ranks runs the sharded cases, on the
`cluster_model` recipe of tests/test_parallel.py (50 stars, n_q 6, no
binaries; base_tpu's catalog, read from
tests/data/parallel_cluster_stars.npz) built in both packages from the
same numpy inputs, and the parent holds the results to base_tpu's
shard_map, to the port unsharded, and to tests/test_parallel.py's
checks.  This file holds (a), (b), (c)
and (f); tests/test_torch_parallel_samplers.py (d), (e) and (g), and
tests/test_torch_parallel_longaxis.py (h), each with a world of its own
(WORLD_JOBS):

  (a) the star-sharded value and gradient at meshes (1, 4) (50 stars pad
      to 52) and (2, 2), against base_tpu's shard_map local_logpost_fn on
      the conftest's 8 CPU devices (mesh 2 x 4) and against the port
      unsharded, at test_parallel.py's bounds; a two-population model and
      one with WDs (the CLI's simulated photometry) against the port
      unsharded;
  (b) a plain forward all-reduce in place of parallel.comm's enter /
      reduce_sum pair fails (a);
  (c) pooled moments, the frozen step size, the ESS fraction and
      systematic resampling over a chain group of 4 against the unsharded
      functions on the concatenated chains;
  (d) sharded HMC, MH (with and without a burn-in model), NUTS, SMC and
      VI with test_parallel.py's checks, at its chain and particle counts
      and shorter runs (the plain density costs ~10-15 ms a call on one
      CPU thread, against base_tpu's compiled one);
  (e) the star shards of a chain block draw bit for bit alike;
  (f) a 1 x 1 mesh (a world of one, in this process) equals the
      unsharded path bit for bit;
  (g) a sharded checkpointed run interrupted and resumed equals an
      uninterrupted one bit for bit;
  (h) tests/test_longaxis.py's recipe: the sharded VI warm start into
      run_hmc_sharded with inv_mass0 and chain_chunk.

The workers import no JAX: the JAX imports stay inside the parent's
fixtures and tests.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from base_tpu_torch.inference.vi import VIConfig

torch.set_num_threads(1)

TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.0, 0.0, 0.0], np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32)
# Two populations: Y_A, Y_B, lambda after the nine shared slots.
TRUTH_MP = np.concatenate([TRUTH, [0.25, 0.30, 0.6]]).astype(np.float32)
PRIOR_SIGMA_MP = np.concatenate([PRIOR_SIGMA, [0.05, 0.05, -1]]).astype(
    np.float32)
DENSITY_MESHES = ((1, 4), (2, 2))
VI_CFG = VIConfig(n_steps=200, n_mc=4, full_rank=True, learning_rate=2e-2,
                  init_log_sd=-3.0)
WORLD = 4
WORLD_DEADLINE_S = 600
N_CHAINS = 8
# The cluster's catalog: base_tpu's, written by
# scripts/parallel_stars_from_jax.py (the workers and the parent read it;
# the density world's parent checks it against base_tpu's builder).
CLUSTER_STARS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "parallel_cluster_stars.npz")

# The CLI's small cluster with WDs (tests/test_torch_cli.py's config).
WD_CONFIG = (
    "cluster:\n"
    "  starting_logAge: 9.5\n  starting_Fe_H: -0.3\n"
    "  starting_distMod: 8.0\n  starting_Av: 0.15\n"
    "  prior_Fe_H: -0.3\n  prior_distMod: 8.0\n  prior_Av: 0.15\n"
    "simCluster:\n  nStars: 40\n  percentBinary: 0.3\n  percentDB: 0.1\n"
    "scatterCluster:\n  limitMag: 26.0\n"
    "mcmc:\n  upsample: 1\n  nMassRatio: 4\n"
)


def cluster_catalog(small_grid):
    """(mags, sigmas) of the recipe by base_tpu's simulate_cluster and
    scatter_cluster (scripts/parallel_stars_from_jax.py's builder)."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import parallel_stars_from_jax as gen

    return gen.catalog(small_grid)


def _fields(obj, static=("bands", "name")):
    return {f.name: (getattr(obj, f.name) if f.name in static
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


# ---- the models and inputs, built alike in the parent and the workers ----

def _port_model(inp, cls_name="single"):
    from base_tpu_torch import convert
    from base_tpu_torch.model import multipop as mp
    from base_tpu_torch.model import posterior as post

    grid = convert.grid_from_numpy(**inp["grid"], device="cpu")
    stars = convert.stars_from_numpy(**inp["stars"], device="cpu")
    if cls_name == "multi":
        return mp.make_multipop_model(grid, stars, TRUTH_MP, PRIOR_SIGMA_MP,
                                      n_q=6, binaries=False,
                                      use_pallas=inp["use_pallas"],
                                      device="cpu")
    return post.make_single_pop_model(grid, stars, TRUTH, PRIOR_SIGMA, n_q=6,
                                      binaries=False,
                                      use_pallas=inp["use_pallas"],
                                      device="cpu")


def _wd_model(inp):
    """The single-population model the CLI builds from its simulated
    photometry, WDs included."""
    from base_tpu_torch.io import phot as photio
    from base_tpu_torch.io.settings import load_settings
    from base_tpu_torch.tools import main as tmain

    s = load_settings(inp["wd_config"], [])
    return tmain._build_model_from_phot(
        s, photio.read_phot(inp["wd_phot"]), torch.device("cpu"))


def _points(truth, free, n=3, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.tile(truth, (n, 1))
    pts[1:] += rng.normal(0.0, 0.03, (n - 1, len(truth))) * np.asarray(free)
    return pts.astype(np.float32)


def _density_points(kind):
    if kind == "multi":
        return _points(TRUTH_MP, [1, 0, 1, 1, 1, 0, 0, 0, 0, 0.2, 0.2, 1])
    if kind == "wd":
        truth = np.array([9.5, 0.27, -0.3, 8.0, 0.15, 0.5, 0.75, 0.1, 0.0],
                         np.float32)
        return _points(truth, [1, 0, 1, 1, 1, 1, 1, 0.3, 0])
    return _points(TRUTH, [1, 1, 1, 1, 1, 0, 0, 0, 0])


def _pooled_inputs():
    """Chain-axis arrays for (c): samples [8, 30, 5], DA averages [8],
    log weights [2, 64] and particles [2, 64, 3] of two replicates, and
    the replicates' uniforms."""
    rng = np.random.default_rng(3)
    zs = (rng.normal(size=(N_CHAINS, 30, 5)) * [1e-3, 0.1, 1, 3, 0.01]
          + [10.0, 0.3, -1, 2, 0]).astype(np.float32)
    le = rng.normal(-3.0, 0.2, N_CHAINS).astype(np.float32)
    log_w = rng.normal(0.0, 2.0, (2, 64)).astype(np.float32)
    z = rng.normal(size=(2, 64, 3)).astype(np.float32)
    u = np.array([0.31, 0.77], np.float32)
    return tuple(torch.from_numpy(a) for a in (zs, le, log_w, z, u))


def _pooled(group, block):
    """(c)'s statistics of `block`'s slices, over `group`."""
    from base_tpu_torch.inference import hmc, smc

    zs, le, log_w, z, u = _pooled_inputs()
    zs, le = block(zs, 0), block(le, 0)
    log_w, z = block(log_w, 1), block(z, 1)
    mean, var = hmc._pooled_mean_var(zs, group)
    c = torch.zeros_like(le)
    states = hmc.HMCChainState(z=zs[:, 0], logpost=c, grad=zs[:, 0],
                               da=hmc.DAState(c, le, c, c, c))
    zr, anc = smc._systematic_resample(u, log_w, z, group)
    return dict(mean=mean, var=var, cov=hmc._pooled_cov(zs, group),
                eps=hmc.freeze_step_size(states, group),
                ess=smc._ess_fraction(log_w, 64.0, group), zr=zr, anc=anc)


# ---- the worker: one rank of the spawned world ----------------------------

class _Interrupt(Exception):
    pass


def _value_grad(model, mesh, pts):
    from base_tpu_torch.parallel import run as prun

    local = prun.shard_stars(model, mesh)
    f = prun.local_logpost_fn(local, local.stars, mesh.star_group,
                              local.wd_stars)
    x = torch.from_numpy(pts).requires_grad_(True)
    v = f(x)
    (g,) = torch.autograd.grad(v.sum(), x)
    return v.detach(), g


def _sampler_start(model):
    """(transform, z0 at the truth, init(seed) [N_CHAINS, 9], gen(seed))."""
    from base_tpu_torch.model import posterior as post

    tr = post.default_transform(model)
    z0 = tr.inverse(torch.from_numpy(TRUTH))

    def init(seed):
        return z0 + 0.01 * torch.randn(
            N_CHAINS, 9, generator=torch.Generator().manual_seed(seed))

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    return tr, z0, init, gen


# (g)'s runs: 8 + 12 transitions of l_max 4 in chunks of 4 draws (three
# chunks: the run is interrupted after the second).
RESUME_HMC = dict(n_warmup=8, n_samples=12, l_max=4, n_windows=2)
RESUME_CHUNK = 4
# (h)'s run: 16 + 16 transitions of l_max 4 from one start; chain_chunk 2
# of each rank's 4 chains.
LONGAXIS_HMC = dict(n_warmup=16, n_samples=16, l_max=4, n_windows=2,
                    chain_chunk=2)


def _longaxis(model, mesh):
    """(h) tests/test_longaxis.py's recipe at mesh (2, 2): sharded
    full-rank VI, then run_hmc_sharded from its draws with its covariance
    as inv_mass0, dense metric, step jitter and chain_chunk; cut to 50 VI
    steps and LONGAXIS_HMC (test_longaxis.py: 400 steps, then 96 + 128
    transitions of l_max 12 at 384 stars)."""
    from base_tpu_torch.inference import hmc
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.parallel import run as prun

    tr, z0, _, gen = _sampler_start(model)
    free = post.free_mask(model)
    draws, cov, _ = prun.vi_warm_start_sharded(
        model, tr, z0, gen(51), N_CHAINS, mesh, free_mask=free,
        cfg=dataclasses.replace(VI_CFG, n_steps=50), chunk_steps=25)
    cfg = hmc.HMCConfig(dense_mass=True, free_mask=free, jitter_mode="step",
                        init_step=0.1, **LONGAXIS_HMC)
    prun.reset_counts()
    zs, info = prun.run_hmc_sharded(model, tr, draws, gen(52), cfg, mesh,
                                    inv_mass0=cov)
    return dict(zs=zs, logposts=info["logposts"], accept=info["accept_prob"],
                draws=draws, calls=prun.density_calls,
                rows=prun.density_rows)


def _samplers_a(model, mesh, d):
    """(d) and (e) at mesh (2, 2): MH (with and without a burn-in model),
    NUTS and SMC."""
    from base_tpu_torch.inference import mh, nuts, smc
    from base_tpu_torch.parallel import run as prun

    out = {}
    tr, z0, init, gen = _sampler_start(model)
    step0 = torch.tensor([0.05, 0.02, 0.05, 0.05, 0.03, 0, 0, 0, 0])
    x0 = torch.from_numpy(np.tile(TRUTH, (N_CHAINS, 1)))
    xs, info = prun.run_mh_sharded(
        model, x0, gen(7), step0,
        mh.MHConfig(n_stage1=100, n_stage2=100, n_main=200), mesh)
    out["mh"] = dict(xs=xs, logposts=info["logposts"],
                     accept=info["accept_rate"])

    burn = dataclasses.replace(model, stars=type(model.stars)(
        **{f.name: getattr(model.stars, f.name)[:30]
           for f in dataclasses.fields(model.stars)}))
    step0 = torch.zeros(9)
    step0[[0, 2, 3, 4]] = torch.tensor([0.03, 0.05, 0.05, 0.02])
    xs, info = prun.run_mh_sharded(
        model, x0, gen(33), step0,
        mh.MHConfig(n_stage1=50, n_stage2=60, n_main=60), mesh,
        burn_model=burn)
    out["mh_burn"] = dict(xs=xs, logposts=info["logposts"])

    zs, info = prun.run_nuts_sharded(
        model, tr, init(18), gen(19),
        nuts.NUTSConfig(n_warmup=30, n_samples=30, max_depth=4,
                        n_windows=2), mesh)
    out["nuts"] = dict(zs=zs, accept=info["accept_prob"],
                       mean_leapfrogs=info["mean_leapfrogs"],
                       logposts=info["logposts"])

    particles, info = prun.run_smc_sharded(
        model, tr, z0, gen(17),
        smc.SMCConfig(n_particles=128, n_move=2, max_stages=16), mesh,
        q0_sd=0.3)
    out["smc"] = dict(particles=particles, **info)
    particles, info = prun.run_smc_sharded(
        model, tr, z0, gen(17),
        smc.SMCConfig(n_particles=32, n_move=2, max_stages=16), mesh,
        q0_sd=0.3, n_rep=2)
    out["smc_rep"] = dict(particles=particles, **info)
    return out


def _samplers_b(model, mesh, d):
    """(d), (e) and (g) at mesh (2, 2): HMC, VI and the sharded
    checkpointed HMC interrupted and resumed."""
    from base_tpu_torch.inference import hmc
    from base_tpu_torch.inference.driver import DriverConfig
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.parallel import run as prun

    out = {}
    tr, z0, init, gen = _sampler_start(model)
    prun.reset_counts()
    cfg = hmc.HMCConfig(n_warmup=50, n_samples=50, l_max=6, n_windows=2)
    zs, info = prun.run_hmc_sharded(model, tr, init(8), gen(9), cfg, mesh)
    out["hmc"] = dict(zs=zs, logposts=info["logposts"],
                      step_size=info["step_size"],
                      accept=info["accept_prob"],
                      calls=prun.density_calls)

    res = prun.run_vi_sharded(model, tr, z0, gen(31), VI_CFG, mesh)
    draws, cov, _ = prun.vi_warm_start_sharded(
        model, tr, z0, gen(32), N_CHAINS, mesh,
        free_mask=post.free_mask(model),
        cfg=dataclasses.replace(VI_CFG, n_steps=50))
    out["vi"] = dict(mu=res.mu, scale=res.scale, final_elbo=res.final_elbo,
                     draws=draws, cov=cov)

    # (g): interrupted after chunk 1 (its checkpoint written), resumed;
    # an equality of any run length, so RESUME_HMC is short.
    rcfg = hmc.HMCConfig(**RESUME_HMC)

    def stop(ci, zs, lps):
        if ci == 1:
            raise _Interrupt

    path = f"{d}/sharded.ckpt"
    try:
        prun.run_hmc_sharded_checkpointed(
            model, tr, init(41), gen(42), rcfg, mesh,
            DriverConfig(checkpoint_path=path, chunk_size=RESUME_CHUNK,
                         on_window=stop))
        raise AssertionError("the run was not interrupted")
    except _Interrupt:
        pass
    resumed = prun.run_hmc_sharded_checkpointed(
        model, tr, init(41), gen(42), rcfg, mesh,
        DriverConfig(checkpoint_path=path, chunk_size=RESUME_CHUNK))
    whole = prun.run_hmc_sharded_checkpointed(
        model, tr, init(41), gen(42), rcfg, mesh,
        DriverConfig(chunk_size=RESUME_CHUNK))
    out["resume"] = [(zs, info["logposts"], info["step_size"],
                      info["inv_mass"]) for zs, info in (resumed, whole)]
    return out


def _job_density(inp, d):
    """(a), (b) and (c): the sharded densities at DENSITY_MESHES, with the
    plain forward all-reduce, and the pooled statistics."""
    from base_tpu_torch.parallel import comm
    from base_tpu_torch.parallel.mesh import make_mesh

    out = {}
    models = dict(single=_port_model(inp), multi=_port_model(inp, "multi"),
                  wd=_wd_model(inp))
    for shape in DENSITY_MESHES:
        mesh = make_mesh(*shape)
        for kind, model in models.items():
            out["density", kind, shape] = _value_grad(
                model, mesh, _density_points(kind))
        enter = comm.enter
        comm.enter = lambda x, group: x   # a plain forward all-reduce
        try:
            out["plain_allreduce", shape] = _value_grad(
                models["single"], mesh, _density_points("single"))
        finally:
            comm.enter = enter
    mesh = make_mesh(WORLD, 1)
    out["pooled"] = _pooled(mesh.chain_group, mesh.chain_block)
    return out


def _job_samplers(inp, d):
    """(d), (e) and (g) at mesh (2, 2)."""
    from base_tpu_torch.parallel.mesh import make_mesh

    model, mesh = _port_model(inp), make_mesh(2, 2)
    return {**_samplers_a(model, mesh, d), **_samplers_b(model, mesh, d)}


def _job_longaxis(inp, d):
    """(h) at mesh (2, 2)."""
    from base_tpu_torch.parallel.mesh import make_mesh

    return dict(longaxis=_longaxis(_port_model(inp), make_mesh(2, 2)))


# Each test file spawns one world of WORLD ranks running one job (~10-35 s
# on one CPU thread a rank): this file the densities and pooled
# statistics, tests/test_torch_parallel_samplers.py the samplers and the
# checkpointed HMC, tests/test_torch_parallel_longaxis.py (h).  (A file
# holds at most 8 Tier-1 tests: pytest-xdist's loadfile hands out files
# with more tests ahead of the JAX long pole, tests/test_cli_mesh.py.)
WORLD_JOBS = dict(density=_job_density, samplers=_job_samplers,
                  longaxis=_job_longaxis)


def _world(rank, d, job):
    """One rank of the world running WORLD_JOBS[job]
    (torch.multiprocessing's entry)."""
    torch.set_num_threads(1)
    from base_tpu_torch.parallel import distributed

    distributed.initialize("cpu", init_method=f"file://{d}/store",
                           world_size=WORLD, rank=rank, local_rank=rank,
                           local_world_size=WORLD, timeout_s=120)
    try:
        inputs = f"{d}/inputs.pt"      # the parent writes it meanwhile
        deadline = time.monotonic() + WORLD_DEADLINE_S
        while not os.path.exists(inputs) and time.monotonic() < deadline:
            time.sleep(0.1)
        inp = torch.load(inputs, weights_only=False)
        torch.save(WORLD_JOBS[job](inp, d), f"{d}/rank{rank}.pt")
    finally:
        distributed.shutdown()


# ---- the parent ------------------------------------------------------------

class _Ranks:
    """The spawned world's results: each rank's dict, waited for on first
    use, so that the parent's own JAX work runs while the world does."""

    def __init__(self, d, ctx):
        self.d, self.ctx = d, ctx
        self.deadline = time.monotonic() + WORLD_DEADLINE_S
        self._ranks = None

    def _join(self):
        if self._ranks is None:
            while not self.ctx.join(timeout=5):
                if time.monotonic() > self.deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    pytest.fail(f"the spawned world ran past "
                                f"{WORLD_DEADLINE_S} s")
            self._ranks = [torch.load(self.d / f"rank{r}.pt",
                                      weights_only=False)
                           for r in range(WORLD)]
        return self._ranks

    def __getitem__(self, i):
        return self._join()[i]

    def __iter__(self):
        return iter(self._join())


def spawn_world(small_grid, tmp_path_factory, job):
    """base_tpu's cluster_model on the catalog of
    tests/data/parallel_cluster_stars.npz, the port's inputs from it, and
    the results of the world's WORLD ranks running WORLD_JOBS[job]
    (_Ranks).  The world starts first and waits for the inputs file; the
    CLI's WD photometry is made only for the density job, which then, as
    the world runs, holds the catalog to base_tpu's simulate_cluster and
    scatter_cluster (threefry keys 21 and 22) bit for bit."""
    import torch.multiprocessing as tmp

    from base_tpu.model import posterior as jpost
    from base_tpu.model.stardata import make_ms_stars
    from base_tpu_torch.tools import main as tmain

    d = tmp_path_factory.mktemp(f"torch_parallel_{job}")
    ctx = tmp.start_processes(_world, args=(str(d), job), nprocs=WORLD,
                              start_method="spawn", join=False)
    with np.load(CLUSTER_STARS) as f:
        mags, sigmas = f["mags"], f["sigmas"]
    stars = make_ms_stars(mags, sigmas, cm_prior=0.999)
    jm = jpost.make_single_pop_model(small_grid, stars, prior_mean=TRUTH,
                                     prior_sigma=PRIOR_SIGMA, n_q=6,
                                     binaries=False)
    inp = dict(grid=_fields(small_grid), stars=_fields(jm.stars),
               use_pallas=bool(jm.use_pallas))
    if job == "density":
        cfg = d / "wd.yaml"
        cfg.write_text(WD_CONFIG)
        args = ["--config", str(cfg), "--outputFileBase", str(d / "wd"),
                "--seed", "5", "--device", "cpu"]
        tmain.main(["simulate", *args])
        tmain.main(["scatter", *args, "--photFile", str(d / "wd.sim.phot")])
        inp.update(wd_config=str(cfg), wd_phot=str(d / "wd.phot"))
    torch.save(inp, d / "inputs.tmp")
    os.replace(d / "inputs.tmp", d / "inputs.pt")   # whole, or not there
    if job == "density":
        want = cluster_catalog(small_grid)
        if not (np.array_equal(want[0], mags)
                and np.array_equal(want[1], sigmas)):
            raise AssertionError(f"{CLUSTER_STARS} is not base_tpu's "
                                 f"catalog: rewrite it with scripts/"
                                 f"parallel_stars_from_jax.py")
    return jm, inp, _Ranks(d, ctx)


@pytest.fixture(scope="module")
def world(small_grid, tmp_path_factory):
    return spawn_world(small_grid, tmp_path_factory, "density")


def _unsharded(inp, kind):
    """The port's own density and its gradient at the kind's points."""
    from base_tpu_torch.model import multipop as mp
    from base_tpu_torch.model import posterior as post

    model = _wd_model(inp) if kind == "wd" else _port_model(inp, kind)
    log_post = mp.log_post if kind == "multi" else post.log_post
    x = torch.from_numpy(_density_points(kind)).requires_grad_(True)
    v = log_post(model, x)
    (g,) = torch.autograd.grad(v.sum(), x)
    return v.detach().numpy(), g.numpy()


def _check_parallel_bounds(got_v, got_g, want_v, want_g):
    """tests/test_parallel.py's bounds: the value to 1e-5 relative (the
    star sum reassociated across shards), the gradient to rtol 5e-3 and
    2e-3 of its largest component."""
    np.testing.assert_allclose(got_v, want_v, rtol=1e-5)
    np.testing.assert_allclose(got_g, want_g, rtol=5e-3,
                               atol=2e-3 * float(np.abs(want_g).max()))


@pytest.fixture(scope="module")
def base_tpu_sharded(world, small_grid):
    """base_tpu's shard_map local_logpost_fn (mesh 2 x 4 on the 8 CPU
    devices) and its gradient at the single-population points."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from base_tpu.parallel import run as jrun
    from base_tpu.parallel.mesh import make_mesh

    jm = world[0]
    mesh = make_mesh(n_chain_shards=2, n_star_shards=4)
    sharded = jrun.shard_stars(jm, mesh)
    frame = dataclasses.replace(sharded, stars=None)

    def device_fn(stars_local, params):
        f = jrun.local_logpost_fn(frame, stars_local, jrun.STAR_AXIS)
        return jax.value_and_grad(f)(params)

    fn = jax.jit(jax.shard_map(
        device_fn, mesh=mesh, in_specs=(jrun._star_specs(sharded.stars), P()),
        out_specs=(P(), P()), check_vma=True))
    vg = [fn(sharded.stars, jnp.asarray(p))
          for p in _density_points("single")]
    return (np.array([float(v) for v, _ in vg]),
            np.stack([np.asarray(g) for _, g in vg]))


@pytest.mark.parametrize("shape", DENSITY_MESHES)
def test_star_sharded_logpost_and_grad_match_base_tpu(world, base_tpu_sharded,
                                                      shape):
    """(a) The port's star-sharded density and gradient, on every rank,
    against base_tpu's shard_map and against the port unsharded (mesh
    (1, 4) pads the 50 stars to 52: padding must not leak)."""
    _, inp, ranks = world
    want_v, want_g = _unsharded(inp, "single")
    for r in ranks:
        v, g = (t.numpy() for t in r["density", "single", shape])
        _check_parallel_bounds(v, g, *base_tpu_sharded)
        _check_parallel_bounds(v, g, want_v, want_g)


@pytest.mark.parametrize("shape", DENSITY_MESHES)
def test_star_sharded_multipop_and_wd_match_unsharded(world, shape):
    """(a) The two-population density and the one with WDs (MS and WD
    stars both sharded and padded) against the port unsharded."""
    _, inp, ranks = world
    for kind in ("multi", "wd"):
        want_v, want_g = _unsharded(inp, kind)
        for r in ranks:
            v, g = (t.numpy() for t in r["density", kind, shape])
            _check_parallel_bounds(v, g, want_v, want_g)


@pytest.mark.parametrize("shape", DENSITY_MESHES)
def test_plain_forward_allreduce_fails(world, shape):
    """(b) The gradient rule is load-bearing: with a plain forward
    all-reduce (no enter) each rank keeps its own stars' gradient, and
    (a)'s gradient check fails while the value still passes."""
    _, inp, ranks = world
    want_v, want_g = _unsharded(inp, "single")
    for r in ranks:
        v, g = (t.numpy() for t in r["plain_allreduce", shape])
        np.testing.assert_allclose(v, want_v, rtol=1e-5)
        with pytest.raises(AssertionError):
            _check_parallel_bounds(v, g, want_v, want_g)


def test_pooled_statistics_over_chain_group(world):
    """(c) Over a chain group of 4: pooled mean / variance / covariance,
    the frozen step size and the ESS fraction equal the unsharded
    functions on the concatenated chains to 1e-6; resampling gives every
    rank its slice of the same ancestry, bit for bit."""
    _, _, ranks = world
    want = _pooled(None, lambda x, dim: x)
    got = [r["pooled"] for r in ranks]
    for k in ("mean", "var", "cov", "eps", "ess"):
        for g in got:
            np.testing.assert_allclose(g[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    for k in ("zr", "anc"):
        assert torch.equal(torch.cat([g[k] for g in got], 1), want[k]), k


def test_mesh_1x1_equals_unsharded(world):
    """(f) A world of one in this process: the 1 x 1 mesh's density and
    gradient, and run_hmc_sharded, equal the unsharded path given the
    chain-shard-0 generator, bit for bit."""
    from base_tpu_torch.inference import hmc
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.parallel import distributed
    from base_tpu_torch.parallel import run as prun
    from base_tpu_torch.parallel.mesh import make_mesh

    _, inp, _ = world
    model = _port_model(inp)
    tr = post.default_transform(model)
    z0 = tr.inverse(torch.from_numpy(TRUTH))
    init = z0 + 0.01 * torch.randn(4, 9,
                                   generator=torch.Generator().manual_seed(3))
    cfg = hmc.HMCConfig(n_warmup=16, n_samples=8, l_max=4, n_windows=2,
                        dense_mass=True)
    want_v, want_g = _unsharded(inp, "single")
    with distributed.world_of_one("cpu"):
        mesh = make_mesh(1, 1)
        v, g = _value_grad(model, mesh, _density_points("single"))
        zs, info = prun.run_hmc_sharded(
            model, tr, init, torch.Generator().manual_seed(5), cfg, mesh)
        g0 = mesh.chain_generator(torch.Generator().manual_seed(5))
    assert np.array_equal(v.numpy(), want_v)
    assert np.array_equal(g.numpy(), want_g)
    want_zs, want_info = hmc.run_hmc(post.make_logpost_z_fn(model, tr), init,
                                     g0, cfg)
    assert torch.equal(zs, want_zs)
    assert torch.equal(info["logposts"], want_info["logposts"])
    assert torch.equal(info["inv_mass"], want_info["inv_mass"])
    assert torch.equal(info["step_size"], want_info["step_size"])
