"""The port's CLI under `--mesh` (tests/test_cli_mesh.py on the port):
`single-pop --mesh 2,2 --device cpu` starts 4 gloo ranks of itself and
shards the chains and the stars; `--metrics` streams per-window rows from
rank 0 during the run; the sharded chain agrees statistically with the
unsharded CLI; a sharded `--resume` killed after its second checkpoint
and relaunched equals an uninterrupted run bit for bit; multi-pop runs
hmc (with `--resume`), nuts, smc, vi and mh over the mesh, and single-pop
the four samplers besides hmc.  The runs are short (a quarter of
test_cli_mesh.py's draws): every rank runs the plain density on one CPU
thread."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from base_tpu_torch.io import res as resio
from base_tpu_torch.tools.main import main

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


def _argv(photdir, tool, outbase, extra, seed="5"):
    return [tool, "--config", str(photdir / "cfg.yaml"),
            "--photFile", str(photdir / "sim.phot"),
            "--outputFileBase", str(photdir / outbase), "--seed", seed,
            "--device", "cpu", *extra]


def _run(photdir, outbase, extra, phot="sim.phot"):
    argv = _argv(photdir, "single-pop", outbase, extra)
    argv[argv.index("--photFile") + 1] = str(photdir / phot)
    main(argv)
    return resio.read_res(str(photdir / (outbase + ".res")))


@pytest.fixture(scope="module")
def metrics_run(photdir):
    """single-pop --mesh 2,2 --metrics: (its chain, its metrics rows)."""
    mpath = photdir / "m.jsonl"
    chain = _run(photdir, "mesh", ["--mesh", "2,2", "--metrics", str(mpath)])
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


def _mp_res(photdir, outbase, extra, seed="7"):
    main(_argv(photdir, "multi-pop", outbase, extra, seed=seed))
    return np.loadtxt(str(photdir / f"{outbase}.mp.res"), skiprows=1)


def test_multipop_mesh_cli(photdir):
    """multi-pop --mesh 2,2: the two-population density through the same
    sharded machinery, the ordered Y_A < Y_B transform intact."""
    raw = _mp_res(photdir, "mpmesh", ["--mesh", "2,2"])
    assert raw.shape == (96, 14)  # 12 params + logPost + chain
    assert np.isfinite(raw).all()
    assert (raw[:, 10] > raw[:, 9]).all()
    assert abs(raw[:, 0].mean() - 9.5) < 0.25


def test_multipop_mesh_resume_runs(photdir):
    """multi-pop --mesh 2,2 --resume writes and consumes the .mp.ckpt
    checkpoint: the second invocation restores the finished run and
    rewrites identical output."""
    extra = ["--mesh", "2,2", "--resume", "--set", "mcmc.runIter=32",
             "--set", "mcmc.warmup=16"]
    a = _mp_res(photdir, "mpres", extra)
    assert (photdir / "mpres.mp.ckpt").exists()
    b = _mp_res(photdir, "mpres", extra)
    np.testing.assert_array_equal(a, b)


def _short(sampler):
    """Settings that keep a sampler's run short: NUTS's trees reach depth
    8 (255 leaves) while its metric adapts, so it records 4 draws a chain
    after 8 warmup transitions; vi fits max(3 warmup, 600) steps."""
    if sampler == "nuts":
        return ["--set", "mcmc.warmup=8", "--set", "mcmc.runIter=16"]
    return ["--set", "mcmc.warmup=24"]


@pytest.mark.parametrize("sampler", ["nuts", "vi", "smc", "mh"])
def test_multipop_sampler_breadth(photdir, sampler):
    """multi-pop --mesh 2,2 runs every other sampler end to end (vi:
    run_vi_sharded, smc: run_smc_sharded, mh: run_mh_sharded)."""
    raw = _mp_res(photdir, f"mp_{sampler}",
                  ["--mesh", "2,2", "--set", f"mcmc.sampler={sampler}",
                   *_short(sampler)])
    assert raw.shape[1] == 14
    assert np.isfinite(raw[:, :12]).all()
    if sampler != "mh":   # mh samples the constrained 12-vector
        assert (raw[:, 10] > raw[:, 9]).all()
    assert abs(raw[:, 0].mean() - 9.5) < 0.3


@pytest.mark.parametrize("sampler", ["nuts", "vi", "smc", "mh"])
def test_single_pop_mesh_samplers(photdir, sampler):
    """single-pop --mesh 2,2 with every sampler besides hmc; mh on
    photometry that leaves every third star out of burn-in, so that its
    stages 1-2 target the useDuringBurnIn model on the same star
    shards."""
    from base_tpu_torch.io import phot as photio

    phot = "sim.phot"
    if sampler == "mh":
        table = photio.read_phot(str(photdir / "sim.phot"))
        table.use_dbi[::3] = 0
        photio.write_phot(str(photdir / "dbi.phot"), table)
        phot = "dbi.phot"
    chain = _run(photdir, f"sp_{sampler}",
                 ["--mesh", "2,2", "--set", f"mcmc.sampler={sampler}",
                  *_short(sampler)], phot=phot)
    assert np.isfinite(chain.params).all()
    assert np.isfinite(chain.logpost).all()
    assert abs(chain.params[:, 0].mean() - 9.5) < 0.3
