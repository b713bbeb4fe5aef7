"""The port's CLI under `--mesh` (tests/test_cli_mesh.py on the port):
`single-pop --mesh 2,2 --device cpu` starts 4 gloo ranks of itself and
shards the chains and the stars; `--metrics` streams per-window rows from
rank 0 during the run; the sharded chain agrees statistically with the
unsharded CLI; a sharded `--resume` killed after its second checkpoint
and relaunched equals an uninterrupted run bit for bit; multi-pop runs
hmc (with `--resume`), nuts, smc, vi and mh over the mesh, and single-pop
the four samplers besides hmc.  The runs are short (a quarter of
test_cli_mesh.py's draws): every rank runs the plain density on one CPU
thread.

The killed-and-resumed run starts its 4 ranks itself, as a user's
`--mesh 2,2` does.  Every other `--mesh 2,2` run of the module goes
through one of two worlds of 4 gloo ranks, spawned once at the start and
running side by side (`mesh_world`): each rank calls the CLI's `main` on
its world's runs in order, with the CLI's `_run_sharded` handing each
tool that world's 2 x 2 mesh (what `_rank_main` does after joining a
world), so that the module pays for two starts of 4 ranks instead of
twelve, and a test waits only for its own run."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from base_tpu_torch.io import res as resio
from base_tpu_torch.tools.main import main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

CFG = (
    "cluster:\n"
    "  starting_logAge: 9.5\n  starting_Fe_H: -0.3\n"
    "  starting_distMod: 8.0\n  starting_Av: 0.15\n"
    "  prior_Fe_H: -0.3\n  prior_distMod: 8.0\n  prior_Av: 0.15\n"
    "simCluster:\n  nStars: 30\n  percentBinary: 0.0\n"
    "scatterCluster:\n  limitMag: 26.0\n"
    "mcmc:\n  chains: 4\n  runIter: 96\n  warmup: 48\n"
    "  sampler: hmc\n  lMax: 6\n  noBinaries: true\n  denseMass: false\n"
    "  upsample: 1\n  nMassRatio: 4\n  stage1Iter: 50\n"
    "  stage2IterMax: 50\n"
)


@pytest.fixture(scope="module")
def photdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_climesh")
    (d / "cfg.yaml").write_text(CFG)
    base = ["--config", str(d / "cfg.yaml"), "--seed", "5",
            "--outputFileBase", str(d / "sim"), "--device", "cpu"]
    main(["simulate"] + base)
    main(["scatter"] + base + ["--photFile", str(d / "sim.sim.phot")])
    return d


def _argv(photdir, tool, outbase, extra, seed="5", phot="sim.phot"):
    return [tool, "--config", str(photdir / "cfg.yaml"),
            "--photFile", str(photdir / phot),
            "--outputFileBase", str(photdir / outbase), "--seed", seed,
            "--device", "cpu", *extra]


def _run(photdir, outbase, extra, phot="sim.phot"):
    main(_argv(photdir, "single-pop", outbase, extra, phot=phot))
    return resio.read_res(str(photdir / (outbase + ".res")))


# ---- two worlds of 4 ranks for the module's --mesh 2,2 runs ---------------

WORLD = 4
WORLD_DEADLINE_S = 900
MP_RESUME = ["--mesh", "2,2", "--resume", "--set", "mcmc.runIter=32",
             "--set", "mcmc.warmup=16"]


def _short(sampler):
    """Settings that keep a sampler's run short: NUTS's trees reach depth
    8 (255 leaves) while its metric adapts, so it records 4 draws a chain
    after 8 warmup transitions; vi fits max(3 warmup, 600) steps."""
    if sampler == "nuts":
        return ["--set", "mcmc.warmup=8", "--set", "mcmc.runIter=16"]
    return ["--set", "mcmc.warmup=24"]


def _mesh_jobs(photdir):
    """Two lists (one a world) of (name, argv, files rank 0 copies after
    the run) of every --mesh 2,2 run the tests read, in the order each
    world runs them; the vi runs (600 steps) in different worlds."""
    def job(name, tool, outbase, extra, seed="5", phot="sim.phot",
            copies=()):
        return (name, _argv(photdir, tool, outbase, extra, seed=seed,
                            phot=phot), copies)

    def sampler(tool, name):
        return ["--mesh", "2,2", "--set", f"mcmc.sampler={name}",
                *_short(name)]

    mpres = ("mpres.mp.res", "mpres.mp.ckpt")
    return (
        [job("metrics", "single-pop", "mesh",
             ["--mesh", "2,2", "--metrics", str(photdir / "m.jsonl")]),
         job("mp_vi", "multi-pop", "mp_vi", sampler("mp", "vi"), seed="7"),
         # multi-pop --resume twice: the first run's files kept aside.
         job("mpres1", "multi-pop", "mpres", MP_RESUME, seed="7",
             copies=tuple((f, f.replace("mpres", "mpres_first"))
                          for f in mpres)),
         job("mpres2", "multi-pop", "mpres", MP_RESUME, seed="7"),
         job("sp_smc", "single-pop", "sp_smc", sampler("sp", "smc")),
         job("sp_mh", "single-pop", "sp_mh", sampler("sp", "mh"),
             phot="dbi.phot")],
        [job("mpmesh", "multi-pop", "mpmesh", ["--mesh", "2,2"], seed="7"),
         job("sp_vi", "single-pop", "sp_vi", sampler("sp", "vi")),
         job("mp_nuts", "multi-pop", "mp_nuts", sampler("mp", "nuts"),
             seed="7"),
         job("sp_nuts", "single-pop", "sp_nuts", sampler("sp", "nuts")),
         job("mp_smc", "multi-pop", "mp_smc", sampler("mp", "smc"),
             seed="7"),
         job("mp_mh", "multi-pop", "mp_mh", sampler("mp", "mh"),
             seed="7")],
    )


def _mesh_world(rank, d, store, jobs):
    """One rank of a world (torch.multiprocessing's entry): join it,
    build the 2 x 2 mesh, run each job's CLI argv with the CLI's
    `_run_sharded` replaced by one that hands the tool this mesh.  Rank 0
    marks a job done (`<d>/<job>.done`) once every rank has left it; a
    job's traceback goes to `<d>/<job>.rank<rank>.err`."""
    import torch.distributed as dist

    from base_tpu_torch.parallel import distributed
    from base_tpu_torch.parallel.mesh import make_mesh
    from base_tpu_torch.tools import main as tmain

    distributed.initialize("cpu", init_method=f"file://{store}",
                           world_size=WORLD, rank=rank, local_rank=rank,
                           local_world_size=WORLD, timeout_s=120)
    try:
        mesh = make_mesh(2, 2)

        def run_sharded(args, shape):
            assert shape == (2, 2), shape
            args.mesh_ctx = mesh
            tmain._run_tool(args)

        tmain._run_sharded = run_sharded
        for name, argv, copies in jobs:
            try:
                tmain.main(argv)
            except (Exception, SystemExit):   # the CLI exits on errors
                Path(d, f"{name}.rank{rank}.err").write_text(
                    traceback.format_exc())
            dist.barrier()
            if rank == 0:
                for src, dst in copies:
                    if Path(d, src).exists():
                        shutil.copy(Path(d, src), Path(d, dst))
                Path(d, f"{name}.done").touch()
    finally:
        distributed.shutdown()


@pytest.fixture(scope="module")
def mesh_world(photdir, tmp_path_factory):
    """Starts the two worlds on `_mesh_jobs` and returns `ran(name)`,
    which waits until that job is done and raises with a rank's traceback
    where it failed; at the end of the module the worlds are joined."""
    import torch.multiprocessing as tmp

    from base_tpu_torch.io import phot as photio

    # single-pop mh: photometry that leaves every third star out of
    # burn-in, so that its stages 1-2 target the useDuringBurnIn model on
    # the same star shards.
    table = photio.read_phot(str(photdir / "sim.phot"))
    table.use_dbi[::3] = 0
    photio.write_phot(str(photdir / "dbi.phot"), table)
    stores = tmp_path_factory.mktemp("torch_climesh_stores")
    ctxs = [tmp.start_processes(
        _mesh_world, args=(str(photdir), str(stores / f"store{i}"), jobs),
        nprocs=WORLD, start_method="spawn", join=False)
        for i, jobs in enumerate(_mesh_jobs(photdir))]
    deadline = time.monotonic() + WORLD_DEADLINE_S

    def kill():
        for ctx in ctxs:
            for p in ctx.processes:
                p.kill()

    def ran(name):
        while not (photdir / f"{name}.done").exists():
            if time.monotonic() > deadline:
                kill()
                pytest.fail(f"the spawned worlds ran past "
                            f"{WORLD_DEADLINE_S} s")
            if all(not p.is_alive() for c in ctxs for p in c.processes):
                pytest.fail(f"the spawned worlds ended without --mesh run "
                            f"{name!r}")
            time.sleep(0.2)
        errs = sorted(photdir.glob(f"{name}.rank*.err"))
        if errs:
            pytest.fail(f"--mesh run {name!r} failed on {errs[0].name}:\n"
                        + errs[0].read_text()[-3000:])

    yield ran
    for ctx in ctxs:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                kill()
                break


@pytest.fixture(scope="module")
def metrics_run(photdir, mesh_world):
    """single-pop --mesh 2,2 --metrics: (its chain, its metrics rows)."""
    mesh_world("metrics")
    chain = resio.read_res(str(photdir / "mesh.res"))
    mpath = photdir / "m.jsonl"
    return chain, [json.loads(ln) for ln in mpath.read_text().splitlines()]


def test_mesh_hmc_streams_window_metrics(metrics_run):
    """--mesh 2,2 on 4 CPU ranks + per-window JSONL rows from rank 0."""
    chain, rows = metrics_run
    assert chain.params.shape == (96, 9)
    assert np.isfinite(chain.logpost).all()
    assert abs(chain.params[:, 0].mean() - 9.5) < 0.2
    wins = [r for r in rows if r["event"] == "window"]
    assert len(wins) >= 2, "streaming diagnostics must emit per-window rows"
    assert all("rhat_logAge" in w and "ess_logAge" in w for w in wins)
    assert all(np.isfinite(w["logpost_mean"]) for w in wins)
    assert all(b["t"] > a["t"] for a, b in zip(wins, wins[1:]))
    (tp,) = [r for r in rows if r["event"] == "single-pop"]
    assert tp["mesh"] == "2,2" and tp["backend"] == "gloo"
    assert tp["density_calls"] > 0 and tp["evals_per_sec"] > 0


def test_mesh_matches_single_device(photdir, metrics_run):
    """The sharded CLI path agrees with the unsharded one statistically
    (same model, same data; the chain shards' streams differ from the
    unsharded stream by construction)."""
    a = _run(photdir, "plain", [])
    b = metrics_run[0]
    for j in (0, 2, 3):  # age, FeH, distMod
        sd = max(a.params[:, j].std(), 1e-4)
        assert abs(a.params[:, j].mean() - b.params[:, j].mean()) < 6 * sd


WORKER = r"""
import os
import signal
import sys

from base_tpu_torch.io import checkpoint as ckpt

# Module level, so that the spawned ranks (which run this file as
# __mp_main__) die too: rank 0, the one that saves, after its n-th save.
fault_after = int(os.environ.get("BTT_FAULT_AFTER", "0"))
if fault_after > 0:
    real_save = ckpt.save_checkpoint
    n = [0]

    def dying_save(path, tree):
        real_save(path, tree)
        n[0] += 1
        if n[0] >= fault_after:
            os.kill(os.getpid(), signal.SIGKILL)

    ckpt.save_checkpoint = dying_save

if __name__ == "__main__":
    from base_tpu_torch.tools.main import main

    main(sys.argv[1:])
    print("DONE", flush=True)
"""


def test_cli_mesh_kill_resume_bit_identical(photdir, metrics_run, tmp_path):
    """single-pop --mesh 2,2 --resume: rank 0 SIGKILLed after its second
    checkpoint (the run fails), the same command relaunched resumes from
    the whole run's checkpoint, and its chain equals the uninterrupted
    --mesh 2,2 run's bit for bit (--metrics and --resume run the same
    chunked sampler)."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def run(fault_after):
        argv = _argv(photdir, "single-pop", "faulted",
                     ["--resume", "--mesh", "2,2"])
        return subprocess.run(
            [sys.executable, str(script), *argv], capture_output=True,
            text=True, timeout=600,
            env=dict(env, BTT_FAULT_AFTER=str(fault_after)))

    r1 = run(2)
    assert r1.returncode != 0 and "DONE" not in r1.stdout, r1.stderr[-2000:]
    assert not (photdir / "faulted.res").exists()
    assert (photdir / "faulted.ckpt").exists()
    r2 = run(0)
    assert r2.returncode == 0, r2.stderr[-2000:]
    a = resio.read_res(str(photdir / "faulted.res"))
    b = metrics_run[0]
    np.testing.assert_array_equal(a.params, b.params)
    np.testing.assert_array_equal(a.logpost, b.logpost)


def _mp_res(photdir, outbase):
    return np.loadtxt(str(photdir / f"{outbase}.mp.res"), skiprows=1)


def test_multipop_mesh_cli(photdir, mesh_world):
    """multi-pop --mesh 2,2: the two-population density through the same
    sharded machinery, the ordered Y_A < Y_B transform intact."""
    mesh_world("mpmesh")
    raw = _mp_res(photdir, "mpmesh")
    assert raw.shape == (96, 14)  # 12 params + logPost + chain
    assert np.isfinite(raw).all()
    assert (raw[:, 10] > raw[:, 9]).all()
    assert abs(raw[:, 0].mean() - 9.5) < 0.25


def test_multipop_mesh_resume_runs(photdir, mesh_world):
    """multi-pop --mesh 2,2 --resume writes and consumes the .mp.ckpt
    checkpoint: the second invocation restores the finished run and
    rewrites identical output."""
    mesh_world("mpres1")
    mesh_world("mpres2")
    a = _mp_res(photdir, "mpres_first")
    assert (photdir / "mpres_first.mp.ckpt").exists()
    b = _mp_res(photdir, "mpres")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sampler", ["nuts", "vi", "smc", "mh"])
def test_multipop_sampler_breadth(photdir, mesh_world, sampler):
    """multi-pop --mesh 2,2 runs every other sampler end to end (vi:
    run_vi_sharded, smc: run_smc_sharded, mh: run_mh_sharded)."""
    mesh_world(f"mp_{sampler}")
    raw = _mp_res(photdir, f"mp_{sampler}")
    assert raw.shape[1] == 14
    assert np.isfinite(raw[:, :12]).all()
    if sampler != "mh":   # mh samples the constrained 12-vector
        assert (raw[:, 10] > raw[:, 9]).all()
    assert abs(raw[:, 0].mean() - 9.5) < 0.3


@pytest.mark.parametrize("sampler", ["nuts", "vi", "smc", "mh"])
def test_single_pop_mesh_samplers(photdir, mesh_world, sampler):
    """single-pop --mesh 2,2 with every sampler besides hmc; mh on
    photometry that leaves every third star out of burn-in (`dbi.phot`,
    written by `mesh_world`), so that its stages 1-2 target the
    useDuringBurnIn model on the same star shards."""
    mesh_world(f"sp_{sampler}")
    chain = resio.read_res(str(photdir / f"sp_{sampler}.res"))
    assert np.isfinite(chain.params).all()
    assert np.isfinite(chain.logpost).all()
    assert abs(chain.params[:, 0].mean() - 9.5) < 0.3
