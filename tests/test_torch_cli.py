"""The port's CLI (base_tpu_torch.tools.main) and its helpers against
base_tpu's: the four helpers, the model the CLI builds from a .phot (its
log_post and gradient, with and without WDs), make-cmd's output, the
profile and debug flags, and the device rules.  The checkpointed driver
interrupted and resumed and the `--device cpu` workflows are in
tests/test_torch_cli_runs.py (a file holds at most 8 Tier-1 tests:
pytest-xdist's loadfile hands out files with more tests ahead of the JAX
long pole, tests/test_cli_mesh.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.grids import filters as jfilt
from base_tpu.grids.isochrone import select_grid_bands as jselect
from base_tpu.inference import diagnostics as jdiag
from base_tpu.io import phot as jphot
from base_tpu.io import settings as jsettings
from base_tpu.model import posterior as jpost
from base_tpu.sim.scatter import exposure_limits as jexposure
from base_tpu.tools import main as jmain
from base_tpu_torch import convert
from base_tpu_torch.grids import filters as tfilt
from base_tpu_torch.grids.isochrone import select_grid_bands as tselect
from base_tpu_torch.inference import diagnostics as tdiag
from base_tpu_torch.io import phot as tphot
from base_tpu_torch.io import settings as tsettings
from base_tpu_torch.model import posterior as tpost
from base_tpu_torch.sim.scatter import exposure_limits as texposure
from base_tpu_torch.tools import main as tmain
from test_torch_posterior import _check_log_post, _fields

torch.set_num_threads(1)

# A small cluster: 40 stars, 30% binaries, 8 bands, WDs from the synthetic
# cooling and atmosphere grids, upsample 1, 4 chains.
CONFIG = (
    "cluster:\n"
    "  starting_logAge: 9.5\n  starting_Fe_H: -0.3\n"
    "  starting_distMod: 8.0\n  starting_Av: 0.15\n"
    "  prior_Fe_H: -0.3\n  prior_distMod: 8.0\n  prior_Av: 0.15\n"
    "simCluster:\n  nStars: 40\n  percentBinary: 0.3\n  percentDB: 0.1\n"
    "scatterCluster:\n  limitMag: 26.0\n"
    "mcmc:\n  chains: 4\n  runIter: 32\n  warmup: 8\n  lMax: 8\n"
    "  upsample: 1\n  nMassRatio: 4\n  stage1Iter: 50\n"
    "  stage2IterMax: 50\n"
)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The config, and the port's simulate -> scatter photometry (with
    WDs, and the same stars without them) on the CPU."""
    d = tmp_path_factory.mktemp("torch_cli")
    cfg = d / "c.yaml"
    cfg.write_text(CONFIG)
    args = ["--config", str(cfg), "--outputFileBase", str(d / "run"),
            "--seed", "5", "--device", "cpu"]
    tmain.main(["simulate", *args])
    tmain.main(["scatter", *args, "--photFile", str(d / "run.sim.phot")])
    table = tphot.read_phot(str(d / "run.phot"))
    assert (table.stage == 3).sum() >= 1 and (table.stage == 1).sum() >= 30
    tphot.write_phot(str(d / "ms.phot"), table.select(table.stage != 3))
    return d, args


def test_helpers_equal_base_tpu(small_grid):
    rng = np.random.default_rng(0)
    samples = rng.normal(size=(40, 4, 3)).astype(np.float32)
    want = jdiag.summarize(jnp.asarray(samples), ("a", "b", "c"))
    got = tdiag.summarize(torch.from_numpy(samples), ("a", "b", "c"))
    assert got["names"] == want["names"]
    for k in ("mean", "sd", "rhat", "ess"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5, err_msg=k)

    for phot, model in ((("V", "B", "X", "K"), jfilt.DEFAULT_BANDS),
                        (("U", "B"), ("B", "U", "V")), (("X",), ("U",))):
        w, g = jfilt.intersect_bands(phot, model), tfilt.intersect_bands(
            phot, model)
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)

    tgrid = convert.grid_from_numpy(**_fields(small_grid), device="cpu")
    idx, bands = np.array([3, 0]), ("R", "U")
    j, t = jselect(small_grid, idx, bands), tselect(tgrid, idx, bands)
    assert t.bands == j.bands == bands
    np.testing.assert_array_equal(t.mags.numpy(), np.asarray(j.mags))
    np.testing.assert_array_equal(t.mass.numpy(), np.asarray(j.mass))

    exposures = [0.0, 0.5, 1.0, 30.0]
    np.testing.assert_allclose(
        texposure(exposures, 21.5, device="cpu").numpy(),
        np.asarray(jexposure(exposures, 21.5)), rtol=1e-6)


def _points(free, n=4, seed=0):
    """n 9-vectors near the config's truth, moved in the free dims."""
    rng = np.random.default_rng(seed)
    truth = jsettings.load_settings(None).cluster.start_vector()
    truth[[0, 2, 3, 4]] = [9.5, -0.3, 8.0, 0.15]
    truth[6:8] = [0.75, 0.1]       # off the IFMR prior means' defaults
    sd = np.array([0.03, 0.005, 0.05, 0.05, 0.02, 0.05, 0.02, 0.01, 0.0])
    pts = truth + rng.normal(size=(n, 9)) * sd * np.asarray(free)
    pts[0] = truth
    return pts.astype(np.float32)


@pytest.mark.parametrize("phot", ["run.phot", "ms.phot"])
def test_model_from_phot_equals_base_tpu(workdir, phot):
    """The model the CLI builds from a .phot (active bands, MS and WD star
    rows, priors, q grid, WD branch): log_post and its gradient against
    base_tpu's CLI model on the same file, with _check_log_post's
    tolerances."""
    d, _ = workdir
    path = str(d / phot)
    cfg = str(d / "c.yaml")
    jm = jmain._build_model_from_phot(jsettings.load_settings(cfg),
                                      jphot.read_phot(path))
    tm = tmain._build_model_from_phot(tsettings.load_settings(cfg),
                                      tphot.read_phot(path),
                                      torch.device("cpu"))
    assert (tm.wd_stars is None) == (jm.wd_stars is None) == (phot ==
                                                              "ms.phot")
    assert tpost.free_mask(tm) == tuple(float(v)
                                        for v in jpost.free_mask(jm))
    _check_log_post(jm, tm, _points(tpost.free_mask(tm)), tpost.log_post)


def _cmd_rows(path):
    raw = np.loadtxt(path, skiprows=1, dtype=str, ndmin=2)
    return raw[:, 0], raw[:, 1:].astype(np.float64)


def test_make_cmd_equals_base_tpu(workdir):
    d, args = workdir
    cfg = str(d / "c.yaml")
    jmain.main(["make-cmd", "--config", cfg, "--outputFileBase",
                str(d / "jax")])
    tmain.main(["make-cmd", "--config", cfg, "--outputFileBase",
                str(d / "port"), "--device", "cpu"])
    with open(d / "jax.cmd") as f, open(d / "port.cmd") as g:
        assert f.readline() == g.readline()
    st_j, v_j = _cmd_rows(d / "jax.cmd")
    st_t, v_t = _cmd_rows(d / "port.cmd")
    assert (st_t == st_j).all() and (st_t == "WD").sum() > 0
    # One unit of the .4f format plus the float32 floor.
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=2e-4)


def test_profile_and_debug_flags(workdir, monkeypatch):
    """--profile writes a Chrome trace in which the tool's run is one range
    named after it; --debug runs the tool in autograd's anomaly mode with
    NaN checks and restores the mode after it."""
    import json

    d, args = workdir
    seen = []
    monkeypatch.setitem(tmain.TOOLS, "make-cmd", lambda a: seen.append(
        (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())))
    tmain.main(["make-cmd", *args, "--debug", "--profile",
                str(d / "prof")])
    tmain.main(["make-cmd", *args])
    assert seen[0] == (True, True) and seen[1][0] is False
    assert not torch.is_anomaly_enabled()
    trace = json.loads((d / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "make-cmd" for e in trace["traceEvents"])


def test_device_rules(workdir):
    """usePallas false on a CUDA device raises (no card needed: the rule
    is resolve_use_pallas); auto means the kernels iff CUDA; typos raise;
    with no CUDA device the CLI's default device exits non-zero, and
    convert-models without --src/--dst exits non-zero.  --mesh is
    base_tpu's: make-cmd ignores it, and a mesh spec that is not C,S
    exits non-zero."""
    rp = tsettings.resolve_use_pallas
    for v in (False, "false", "off", "0"):
        with pytest.raises(ValueError, match="mcmc.usePallas"):
            rp(v, "cuda")
        assert rp(v, "cpu") is False
    assert rp("auto", "cuda") is True and rp("auto", "cpu") is False
    assert rp(True, "cuda") is True and rp("true", "cpu") is True
    for bad in ("ture", "enable"):
        with pytest.raises(ValueError):
            rp(bad, "cpu")
    d, args = workdir
    tmain.main(["make-cmd", *args, "--mesh", "2,1"])
    assert (d / "run.cmd").exists()
    cases = [["single-pop", *args, "--photFile", str(d / "run.phot"),
              "--mesh", spec] for spec in ("2,x", "2,1,1", "0,1")]
    cases.append(["convert-models", *args])
    if not torch.cuda.is_available():
        cases.append(["make-cmd", *[x for x in args
                                    if x not in ("--device", "cpu")]])
    for argv in cases:
        with pytest.raises(SystemExit) as e:
            tmain.main(argv)
        assert e.value.code not in (0, None)
