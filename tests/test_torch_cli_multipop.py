"""The two-population model the port's CLI builds from a .phot
(`tools.main._build_multi_pop_model`) against the one base_tpu's
`multi-pop` builds from the same file and settings: the start and the MH
step vectors exactly, and log_post with its gradient through the ordered
transform, with and without WDs."""
import numpy as np
import pytest
import torch

from base_tpu.inference import mh as jmh
from base_tpu.model import multipop as jmp
from base_tpu.tools import main as jmain
from base_tpu_torch.io import phot as tphot
from base_tpu_torch.io import settings as tsettings
from base_tpu_torch.model import multipop as tmp
from base_tpu_torch.tools import main as tmain
from test_torch_cli import CONFIG
from test_torch_multipop import _check_parity, _points

torch.set_num_threads(1)

# The multiPop section as conf/base9.yaml leaves it (NaN starts and
# priors, derived from cluster Y), and with explicit starts and priors.
MULTIPOP = {
    "derived": [],
    "explicit": ["multiPop.startY_A=0.24", "multiPop.startY_B=0.3",
                 "multiPop.startLambda=0.4", "multiPop.priorY_A=0.245",
                 "multiPop.priorY_B=0.305", "multiPop.priorY_A_sigma=0.02",
                 "multiPop.stepY_A=0.003"],
}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The port's simulate -> scatter photometry on the CPU (with WDs),
    and the same stars without them."""
    d = tmp_path_factory.mktemp("torch_cli_mp")
    cfg = d / "c.yaml"
    cfg.write_text(CONFIG)
    args = ["--config", str(cfg), "--outputFileBase", str(d / "run"),
            "--seed", "5", "--device", "cpu"]
    tmain.main(["simulate", *args])
    tmain.main(["scatter", *args, "--photFile", str(d / "run.sim.phot")])
    table = tphot.read_phot(str(d / "run.phot"))
    assert (table.stage == 3).sum() >= 1
    tphot.write_phot(str(d / "ms.phot"), table.select(table.stage != 3))
    return d


class _Built(Exception):
    pass


def _base_tpu_build(monkeypatch, cfg: str, phot: str, sets: list):
    """(model, start, step0) as base_tpu's `multi-pop` builds them: its
    command runs up to the MH sampler's config, where it is stopped and
    its locals read."""
    def stop(*args, **kwargs):
        raise _Built

    monkeypatch.setattr(jmh, "MHConfig", stop)
    argv = ["multi-pop", "--config", cfg, "--photFile", phot,
            "--set", "mcmc.sampler=mh", *[a for x in sets
                                          for a in ("--set", x)]]
    with pytest.raises(_Built) as e:
        jmain.main(argv)
    tb = e.value.__traceback__
    while tb.tb_frame.f_code.co_name != "cmd_multi_pop":
        tb = tb.tb_next
    loc = tb.tb_frame.f_locals
    return loc["model"], loc["start"], loc["step0"]


@pytest.mark.parametrize("phot,case", [("ms.phot", "derived"),
                                       ("ms.phot", "explicit"),
                                       ("run.phot", "derived")])
def test_multi_pop_model_equals_base_tpu(workdir, monkeypatch, phot, case):
    d = workdir
    cfg, path = str(d / "c.yaml"), str(d / phot)
    sets = MULTIPOP[case]
    jm, jstart, jstep = _base_tpu_build(monkeypatch, cfg, path, sets)
    tm, tstart, tstep = tmain._build_multi_pop_model(
        tsettings.load_settings(cfg, sets), tphot.read_phot(path),
        torch.device("cpu"))
    wd = phot == "run.phot"
    assert (tm.wd_stars is not None) == (jm.wd_stars is not None) == wd
    np.testing.assert_array_equal(tstart, np.asarray(jstart))
    np.testing.assert_array_equal(tstep, np.asarray(jstep))
    for k in ("mean", "sigma"):
        np.testing.assert_array_equal(getattr(tm.priors, k).numpy(),
                                      np.asarray(getattr(jm.priors, k)))
    # Points off the start's grid nodes (where JAX's clip halves the
    # gradient); with WDs, the IFMR away from its prior means too.
    center = tstart.copy()
    center[[0, 9, 10]] += (0.013, 0.0013, -0.0017)
    if wd:
        center[5:8] = (0.45, 0.75, 0.1)
    _check_parity(jm, tm, _points(center, 3, 7, wd=wd), one_at_a_time=wd)
    assert tmp.free_mask(tm) == jmp.free_mask(jm)
