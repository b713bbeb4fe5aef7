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
2,S` at chip_smoke's phase-12 settings over every card.  It prints one
JSON line per mesh, the CLI's, the card's name and power limit, and exits
non-zero on any failed check.

    python3 scripts/torch_mesh_cards.py

from the repository root, on a machine with two or more CUDA devices.
"""
import json
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


def rank_main(rank: int, world: int, out_dir: str) -> None:
    """One rank: every mesh's density checks and sharded HMC; its results
    and draws saved to out_dir/rank<r>.pt."""
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
        for shape in meshes(world):
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
        torch.save(dict(results=res, draws=draws), f"{out_dir}/rank{rank}.pt")
    finally:
        distributed.shutdown()


def main() -> None:
    import torch.multiprocessing as tmp

    from base_tpu_torch.ops import build
    from base_tpu_torch.tools import main as cli

    world = torch.cuda.device_count()
    if world < 2:
        raise SystemExit(f"torch_mesh_cards: {world} CUDA devices; this "
                         f"script needs two or more")
    build.build()
    cs.log(f"{world} x {torch.cuda.get_device_name(0)}")
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        tmp.start_processes(rank_main, args=(world, out_dir), nprocs=world,
                            start_method="spawn")
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
