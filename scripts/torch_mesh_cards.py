"""The parallel layer across the cards of one host: every card a rank,
NCCL by the backend rule (the PyTorch/CUDA port, base_tpu_torch.parallel).

chip_smoke.py phase 14 runs the layer on one card (a world of one, and two
ranks sharing the card over gloo).  This script starts one rank per card
(torch.multiprocessing, spawn) and, at every (chains x stars) mesh of
that world ((1, N), (N, 1) and, for N = 4, (2, 2)), holds the sharded
density and gradient to the unsharded card density at
tests/test_parallel.py's bounds (config 1 at 64 chains, config 5's 10 000
stars on 1024 rows, value only, and on 8 with the gradient), runs sharded
HMC on config 1 (each rank's launches equal to its density calls, the
ranks' gathered draws bit-identical), then the CLI's `single-pop --mesh
2,S` at chip_smoke's phase-12 settings over every card.

Config 5 across the cards (BASELINE.json config 5; tests/test_longaxis.py's
recipe at full size): at meshes (1, N) and, for an even N, (2, N / 2),
vi_warm_start_sharded and run_hmc_sharded from its draws with its
covariance as inv_mass0 at 10 000 stars, dense metric, step jitter, l_max
24, chain_chunk LONGAXIS_CHUNK, cut to LONGAXIS_WARMUP + LONGAXIS_SAMPLES
transitions (the benchmark: 192 + 1024): each rank's density calls equal
to its evaluations times its blocks, every call one block's rows, every
kernel launched once per call; then at (N, 1) run_smc_sharded at
benchmarks/smc_10k_tpu.py's 4 replicates x 1024 particles from the VI
mean (q0 isotropic, as run_smc_sharded's: sd twice the largest VI sd of
the free parameters), kernels 1 and 3 once per call, with its wall and
log-evidence +- SE.

It prints one JSON line per mesh, config 5's, the CLI's, the card's name
and power limit, and exits non-zero on any failed check.

    python3 scripts/torch_mesh_cards.py [--config5-only]

from the repository root, on a machine with two or more CUDA devices;
`--config5-only` runs config 5's part alone.
"""
import argparse
import json
import math
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402


def meshes(world: int) -> list:
    shapes = [(1, world), (world, 1)]
    if world == 4:
        shapes.append((2, 2))
    return shapes


# Config 5's sharded long-axis runs: 16 chains in blocks of 4 a density
# call (4 blocks on each rank at (1, 4), 2 at (2, 2)).
LONGAXIS_CHAINS, LONGAXIS_CHUNK, LONGAXIS_L_MAX = 16, 4, 24
LONGAXIS_WARMUP, LONGAXIS_SAMPLES, LONGAXIS_WINDOWS = 8, 8, 2
# Config 5's sharded SMC: benchmarks/smc_10k_tpu.py's 4 x 1024 particles.
SMC_REPS, SMC_PARTICLES, SMC_INFLATE = 4, 1024, 2.0


def config5_meshes(world: int) -> list:
    shapes = [(1, world)]
    if world % 2 == 0 and world > 2:
        shapes.append((2, world // 2))
    return shapes


def sharded_longaxis(model, mesh, label: str):
    """vi_warm_start_sharded into run_hmc_sharded(inv_mass0=) with
    chain_chunk over the mesh.  Returns (results, draws, VI result)."""
    from base_tpu_torch.inference.hmc import HMCConfig, chain_blocks
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.parallel import run as prun

    dev = model.grid.device
    tr = post.default_transform(model)
    free = post.free_mask(model)
    z0 = tr.inverse(torch.as_tensor(cs.TRUTH, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init, inv_mass0, vres = prun.vi_warm_start_sharded(
        model, tr, z0, torch.Generator(device=dev).manual_seed(5),
        LONGAXIS_CHAINS, mesh, free_mask=free)
    torch.cuda.synchronize()
    t_vi = time.perf_counter() - t0
    cfg = HMCConfig(n_warmup=LONGAXIS_WARMUP, n_samples=LONGAXIS_SAMPLES,
                    l_max=LONGAXIS_L_MAX, n_windows=LONGAXIS_WINDOWS,
                    dense_mass=True, free_mask=free, jitter_mode="step",
                    init_step=0.1, chain_chunk=LONGAXIS_CHUNK)
    prun.reset_counts()
    cs.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    zs, info = prun.run_hmc_sharded(
        model, tr, init, torch.Generator(device=dev).manual_seed(7), cfg,
        mesh, inv_mass0=inv_mass0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = cs.launch_counts()
    local = LONGAXIS_CHAINS // mesh.n_chain_shards
    blocks = chain_blocks(local, LONGAXIS_CHUNK)
    evals = 1 + LONGAXIS_L_MAX * (
        LONGAXIS_WINDOWS * max(LONGAXIS_WARMUP // LONGAXIS_WINDOWS, 1)
        + LONGAXIS_SAMPLES)
    calls, rows = prun.density_calls, prun.density_rows
    if not (calls == evals * blocks and rows == evals * local):
        raise AssertionError(f"{label}: {calls} density calls of {rows} "
                             f"rows, want {evals} evaluations x {blocks} "
                             f"blocks of {local // blocks} rows")
    cs.check_one_launch_per_call(label, counts, evals, blocks=blocks)
    age = tr.forward(zs)[..., 0]
    res = dict(vi_wall_s=t_vi, vi_elbo=float(vres.final_elbo),
               hmc_wall_s=wall, chains=LONGAXIS_CHAINS, local_chains=local,
               chain_chunk=LONGAXIS_CHUNK, blocks=blocks, evaluations=evals,
               density_calls=calls, calls_per_s=calls / wall,
               ms_per_evaluation=1e3 * wall / evals, launches=counts,
               accept=float(info["accept_prob"]),
               step_size=float(info["step_size"]),
               age=dict(mean=float(age.mean()), sd=float(age.std()),
                        truth=float(cs.TRUTH[0])))
    if not (torch.isfinite(zs).all() and res["accept"] > 0.0):
        raise AssertionError(f"{label}: sharded long-axis HMC {res}")
    return res, zs, vres


def sharded_smc5(model, mesh, vres, label: str) -> tuple[dict, torch.Tensor]:
    """run_smc_sharded at SMC_REPS x SMC_PARTICLES from the VI mean (the
    pinned dims at the truth), q0 sd SMC_INFLATE x the largest VI sd of
    the free parameters; kernels 1 and 3 launched once per density call,
    2 and 4 never.  Returns (results, particles)."""
    from base_tpu_torch.inference.smc import SMCConfig
    from base_tpu_torch.inference.vi import posterior_covariance
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.parallel import run as prun

    dev = model.grid.device
    tr = post.default_transform(model)
    free = torch.as_tensor(post.free_mask(model), device=dev) > 0
    z0 = tr.inverse(torch.as_tensor(cs.TRUTH, device=dev))
    center = torch.where(free, vres.mu, z0)
    sd = posterior_covariance(vres).diagonal().clamp_min(0).sqrt()
    q0_sd = SMC_INFLATE * float(sd[free].max())
    cfg = SMCConfig(n_particles=SMC_PARTICLES // mesh.n_chain_shards,
                    max_stages=30, n_move=3)
    prun.reset_counts()
    cs.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    particles, info = prun.run_smc_sharded(
        model, tr, center, torch.Generator(device=dev).manual_seed(7), cfg,
        mesh, q0_sd=q0_sd, n_rep=SMC_REPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cs.launch_counts()
    calls = prun.density_calls
    cs.check_one_launch_per_call(label, counts, calls,
                                 kernels=("table_fwd", "marglik_fwd"))
    xs = tr.forward(particles)
    res = dict(wall_s=wall, replicates=SMC_REPS,
               particles_per_replicate=SMC_PARTICLES,
               rows_per_call=prun.density_rows // max(calls, 1),
               density_calls=calls, ms_per_call=1e3 * wall / max(calls, 1),
               q0_sd=q0_sd, launches=counts, stages=int(info["n_stages"]),
               beta=float(info["beta"]), move_accept=float(info["accept"]),
               move_scale=float(info["move_scale"]),
               log_evidence=float(info["log_evidence"]),
               log_evidence_se=float(info["log_evidence_se"]),
               log_evidences=info["log_evidences"].tolist(),
               age=dict(mean=float(xs[:, 0].mean()),
                        sd=float(xs[:, 0].std()), truth=float(cs.TRUTH[0])))
    ok = (res["beta"] >= 1.0 and bool(torch.isfinite(xs).all())
          and all(map(math.isfinite, (res["log_evidence"],
                                      res["log_evidence_se"]))))
    if not ok:
        raise AssertionError(f"{label}: sharded SMC {res}")
    return res, particles


def config5_main(world: int, model5, res: dict, draws: dict) -> None:
    """Config 5's part of a rank (module docstring)."""
    from base_tpu_torch.parallel.mesh import make_mesh

    vres = None
    for shape in config5_meshes(world):
        mesh = make_mesh(*shape)
        key = f"config5 {shape[0]}x{shape[1]}"
        r, draws[key], vres = sharded_longaxis(model5, mesh, key)
        res[key] = dict(mesh=mesh.describe(), world=world, longaxis=r)
    mesh = make_mesh(world, 1)
    key = f"config5 smc {world}x1"
    r, draws[key] = sharded_smc5(model5, mesh, vres, key)
    res[key] = dict(mesh=mesh.describe(), world=world, smc=r)


def rank_main(rank: int, world: int, out_dir: str,
              config5_only: bool = False) -> None:
    """One rank: every mesh's density checks and sharded HMC, then config
    5's runs; its results and draws saved to out_dir/rank<r>.pt."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars
    from base_tpu_torch.ops import build
    from base_tpu_torch.parallel import distributed
    from base_tpu_torch.parallel.mesh import make_mesh

    build.library()
    dev = distributed.initialize(
        "cuda", init_method=f"file://{out_dir}/store", world_size=world,
        rank=rank, local_rank=rank, local_world_size=world,
        timeout_s=cs.WORLD14_TIMEOUT_S)
    res, draws = {}, {}
    try:
        model = cs.make_model(cs.make_data(), dev)
        z = cs.chain_points(model, 0.05, seed=1)
        mags, sig = cs.make_data5()
        model5 = post.make_single_pop_model(
            synthetic.make_grid(n_eep=cs.N_EEP, device=dev),
            make_ms_stars(mags, sig, cm_prior=0.99, device=dev), cs.TRUTH,
            cs.PRIOR_SIGMA, n_q=cs.N_Q, upsample=cs.UPSAMPLE5, device=dev)
        z5 = cs.chain_points(model5, 0.02, seed=5,
                             n_chains=cs.N_REP5 * cs.N_PARTICLES5)
        for shape in ([] if config5_only else meshes(world)):
            mesh = make_mesh(*shape)
            key = f"{shape[0]}x{shape[1]}"
            r = dict(mesh=mesh.describe(), world=world)
            r["config1"] = cs.sharded_density_errs(model, mesh, z)
            r["config5"] = cs.sharded_density_errs(model5, mesh, z5,
                                                   grad=False)
            r["config5_grad"] = cs.sharded_density_errs(
                model5, mesh, z5[:cs.N_ROWS5_GRAD])
            r["hmc"], draws[key] = cs.sharded_hmc(model, mesh, key)
            res[key] = r
        config5_main(world, model5, res, draws)
        torch.save(dict(results=res, draws=draws), f"{out_dir}/rank{rank}.pt")
    finally:
        distributed.shutdown()


def main() -> None:
    import torch.multiprocessing as tmp

    from base_tpu_torch.ops import build
    from base_tpu_torch.tools import main as cli

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config5-only", action="store_true",
                    help="run config 5's part alone")
    args = ap.parse_args()
    world = torch.cuda.device_count()
    if world < 2:
        raise SystemExit(f"torch_mesh_cards: {world} CUDA devices; this "
                         f"script needs two or more")
    build.build()
    cs.log(f"{world} x {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        tmp.start_processes(rank_main,
                            args=(world, out_dir, args.config5_only),
                            nprocs=world, start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = [torch.load(f"{out_dir}/rank{r}.pt", map_location="cpu")
                 for r in range(world)]
    for key in ranks[0]["results"]:
        same = all(torch.equal(ranks[0]["draws"][key], r["draws"][key])
                   for r in ranks[1:])
        print(json.dumps({"mesh": key, "draws_bit_identical": same,
                          "ranks": [r["results"][key] for r in ranks]}))
        if not same:
            raise AssertionError(f"{key}: the ranks' draws differ")
    cs.log(f"world of {world}: {wall:.1f} s with the spawn")
    if args.config5_only:
        print(cs.nvidia_smi())
        return

    with tempfile.TemporaryDirectory() as tmpdir:
        conf = os.path.join(os.getcwd(), "conf", "base9.yaml")
        base = os.path.join(tmpdir, "run")
        sets = [a for x in cs.CLI_SETS for a in ("--set", x)]
        args = ["--config", conf, "--outputFileBase", base, *sets,
                "--device", "cuda"]
        cli.main(["simulate", *args])
        cli.main(["scatter", *args, "--photFile", base + ".sim.phot"])
        metrics_path = os.path.join(tmpdir, "m.jsonl")
        spec = f"2,{world // 2}"
        t0 = time.perf_counter()
        cli.main(["single-pop", *args, "--photFile", base + ".phot",
                  "--mesh", spec, "--metrics", metrics_path])
        wall = time.perf_counter() - t0
        with open(metrics_path) as f:
            m = [json.loads(line) for line in f][-1]
        from base_tpu_torch.io.res import read_res

        chain = read_res(base + ".res")
        age = chain.params[:, 0]
        res = dict(mesh=m["mesh"], backend=m["backend"], world=world,
                   tool_wall_s=wall, single_pop_wall_s=m["wall_s"],
                   density_calls_rank0=m["density_calls"],
                   calls_per_s=m["density_calls"] / m["wall_s"],
                   rows=int(chain.params.shape[0]),
                   age=dict(mean=float(age.mean()), sd=float(age.std())))
        print(json.dumps({"cli": res}))
        if not (m["backend"] == "nccl" and torch.isfinite(
                torch.as_tensor(chain.params)).all()):
            raise AssertionError(f"single-pop --mesh {spec}: {res}")
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
