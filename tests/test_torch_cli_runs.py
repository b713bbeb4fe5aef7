"""The port's CLI runs on the CPU: the checkpointed driver interrupted and
resumed, a tiny `--device cpu` workflow through every tool, and multi-pop
under MH (tests/test_torch_cli.py holds the helpers, the model from a
.phot, make-cmd and the device rules against base_tpu)."""
import os

import numpy as np
import pytest
import torch

from base_tpu_torch.inference import hmc as thmc
from base_tpu_torch.inference.driver import (DriverConfig,
                                             run_hmc_checkpointed)
from base_tpu_torch.io import phot as tphot
from base_tpu_torch.io import res as tres
from base_tpu_torch.io.samples import read_star_samples
from base_tpu_torch.tools import main as tmain
from test_torch_cli import workdir  # noqa: F401

torch.set_num_threads(1)


def _gauss(z):
    return -0.5 * ((z - torch.tensor([1.0, -2.0, 0.5])) ** 2).sum(-1)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("chunk", [8, 5])
def test_resume_bit_identical(tmp_path, chunk):
    """run_hmc_checkpointed interrupted after chunk 1 (an on_window that
    raises) and resumed from its checkpoint, with a generator seeded
    otherwise, equals the uninterrupted run bit for bit (draws, log
    posteriors, acceptance, final states, generator state); chunk 5 makes
    the last chunk uneven.  The uninterrupted run's draws equal run_hmc's
    under the same seed (an uneven last chunk over-runs, but records only
    the first draws)."""
    cfg = thmc.HMCConfig(n_warmup=40, n_samples=24, l_max=6, n_windows=2,
                         dense_mass=True)
    init = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))

    def run(path, gen_seed=1, on_window=None):
        gen = torch.Generator().manual_seed(gen_seed)
        zs, info = run_hmc_checkpointed(
            _gauss, init, gen, cfg,
            DriverConfig(checkpoint_path=path, chunk_size=chunk,
                         on_window=on_window))
        return zs, info, gen.get_state()

    def stop(ci, zs, lps):
        assert zs.shape == (chunk, 4, 3) and lps.shape == (chunk, 4)
        if ci == 1:
            raise _Stop

    want = run(None)
    ck = str(tmp_path / "run.ckpt")
    with pytest.raises(_Stop):
        run(ck, on_window=stop)
    got = run(ck, gen_seed=99)
    assert torch.equal(got[0], want[0]) and got[0].shape == (24, 4, 3)
    for k in ("logposts", "accept_prob", "step_size", "inv_mass"):
        assert torch.equal(got[1][k], want[1][k]), k
    for a, b in zip(got[1]["final_states"], want[1]["final_states"]):
        assert torch.equal(a, b) if torch.is_tensor(a) else all(
            torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(got[2], want[2])
    zs, info = thmc.run_hmc(_gauss, init, torch.Generator().manual_seed(1),
                            cfg)
    assert torch.equal(zs, want[0])
    assert torch.equal(info["logposts"], want[1]["logposts"])


@pytest.mark.parametrize("sampler", ["hmc", "mh"])
def test_cpu_workflow(workdir, sampler):
    """single-pop (with --metrics and --store sqlite) -> sample-mass ->
    sample-wd-mass on the CPU: finite chains of the expected shape near
    the truth, the density calls counted, per-star outputs."""
    d, args = workdir
    phot = ["--photFile", str(d / "run.phot")]
    out = str(d / sampler)
    a = [x if x != str(d / "run") else out for x in args]
    a += ["--set", f"mcmc.sampler={sampler}"]
    tmain.main(["single-pop", *a, *phot, "--metrics", out + ".jsonl",
                "--store", "sqlite"])
    chain = tres.read_res(out + ".res")
    assert chain.params.shape == (32, 9) and set(chain.chain) == set(range(4))
    assert np.isfinite(chain.params).all() and np.isfinite(
        chain.logpost).all()
    assert abs(chain.params[:, 0].mean() - 9.5) < 0.2
    assert os.path.exists(out + ".db")
    import json

    with open(out + ".jsonl") as f:
        m = [json.loads(line) for line in f][-1]
    assert m["event"] == "single-pop" and m["density_calls"] > 0
    assert m["chains"] == 4 and m["device"] == "cpu"
    if sampler == "hmc":
        # init + (warmup + draws) transitions of l_max leapfrog steps.
        assert m["density_calls"] == 1 + (8 + 8) * 8

    tmain.main(["sample-mass", *a, *phot])
    ids, cols = read_star_samples(out + ".massSamples")
    table = tphot.read_phot(str(d / "run.phot"))
    assert len(ids) == int((table.stage == 1).sum())
    assert cols["mass"].shape == (32, len(ids))
    _, mcols = read_star_samples(out + ".membership")
    assert ((mcols["pMember"] >= 0) & (mcols["pMember"] <= 1)).all()
    tmain.main(["sample-wd-mass", *a, *phot])
    wids, wcols = read_star_samples(out + ".wdMassSamples")
    assert len(wids) == int((table.stage == 3).sum())
    assert set(wcols) == {"zamsMass", "wdMass", "logCoolAge", "isDB",
                          "pMember"}
    assert np.isfinite(wcols["wdMass"]).all()


def test_multi_pop_mh(workdir):
    d, args = workdir
    out = str(d / "mp")
    a = [x if x != str(d / "run") else out for x in args]
    tmain.main(["multi-pop", *a, "--photFile", str(d / "ms.phot"),
                "--set", "mcmc.sampler=mh", "--set", "mcmc.stage1Iter=50",
                "--set", "mcmc.stage2IterMax=20"])
    raw = np.loadtxt(out + ".mp.res", skiprows=1)
    assert raw.shape == (32, 14) and np.isfinite(raw).all()
    assert set(raw[:, 13]) == set(range(4))
    lam = raw[:, 11]
    assert ((lam > 0) & (lam < 1)).all()
