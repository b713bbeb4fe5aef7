"""The port's host layer against base_tpu's: the YAML subset reader against
PyYAML, the settings, the .phot / .res / sample / SQLite writers byte for
byte, the checkpoint store, the metrics stream and guards, and the model
bundle factory (grids.load) for every family and for a packed .npz."""
import dataclasses
import io
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from base_tpu.grids import load as jload
from base_tpu.io import phot as jphot
from base_tpu.io import res as jres
from base_tpu.io import samples as jsamples
from base_tpu.io import settings as jsettings
from base_tpu.io import sqlite_store as jsqlite
from base_tpu_torch.grids import load as tload
from base_tpu_torch.io import checkpoint as tckpt
from base_tpu_torch.io import phot as tphot
from base_tpu_torch.io import res as tres
from base_tpu_torch.io import samples as tsamples
from base_tpu_torch.io import settings as tsettings
from base_tpu_torch.io import sqlite_store as tsqlite
from base_tpu_torch.io import yaml_subset
from base_tpu_torch.utils.metrics import (MetricsLogger, debug_guards,
                                          named_scope, profile_trace)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

# conf/base9.yaml and the configs tests/test_cli.py writes.
CONFIGS = {
    "base9": (ROOT / "conf" / "base9.yaml").read_text(),
    "roundtrip": (
        "cluster:\n  starting_logAge: 9.45\n  prior_Fe_H_sigma: 0.25\n"
        "simCluster:\n  nStars: 60\n  percentBinary: 0.2\n"
        "mcmc:\n  chains: 4\n"
    ),
    "field_box": (
        "cluster:\n  fieldMagRange: [12.0, 13.0]\n"
        "mcmc:\n  sigmaModel: 0.01\n"
    ),
    "workflow": (
        "cluster:\n"
        "  starting_logAge: 9.5\n  starting_Fe_H: -0.3\n"
        "  starting_distMod: 8.0\n  starting_Av: 0.15\n"
        "  prior_Fe_H: -0.3\n  prior_distMod: 8.0\n  prior_Av: 0.15\n"
        "simCluster:\n  nStars: 60\n  percentBinary: 0.0\n  percentDB: 0.1\n"
        "scatterCluster:\n  limitMag: 26.0\n"
        "mcmc:\n  chains: 4\n  runIter: 800\n  stage1Iter: 200\n"
        "  stage2IterMax: 200\n  sampler: mh\n  noBinaries: true\n"
    ),
    "multipop": (
        "cluster:\n"
        "  starting_logAge: 9.4\n  starting_Fe_H: -0.2\n"
        "  starting_distMod: 9.0\n  starting_Av: 0.1\n  starting_Y: 0.27\n"
        "  prior_Fe_H: -0.2\n  prior_distMod: 9.0\n  prior_Av: 0.1\n"
        "simCluster:\n  nStars: 48\n  percentBinary: 0.0\n"
        "scatterCluster:\n  limitMag: 26.0\n"
        "mcmc:\n  chains: 4\n  runIter: 256\n  warmup: 96\n  lMax: 8\n"
        "  noBinaries: true\n  nMassRatio: 4\n"
    ),
    "multipop_bad": (
        "simCluster:\n  nStars: 16\n"
        "multiPop:\n  startY_A: 0.33\n  startY_B: 0.25\n"
    ),
    "sqlite": (
        "cluster:\n  starting_logAge: 9.5\n"
        "simCluster:\n  nStars: 24\n  percentBinary: 0.0\n"
        "mcmc:\n  chains: 2\n  runIter: 64\n  stage1Iter: 50\n"
        "  stage2IterMax: 50\n  sampler: mh\n  noBinaries: true\n"
    ),
    # Scalar forms the subset resolves as PyYAML does.
    "scalars": (
        "# comment\nfiles:\n  photFile: 'it''s.phot'  # trailing\n"
        "  outputFileBase: \"out\"\n  modelDirectory:\n  store: ~\n"
        "mcmc:\n  usePallas: auto\n  denseMass: yes\n  noBinaries: Off\n"
        "  sigmaModel: 1.0e-2\n  targetAccept: .85\n  seed: -3\n"
        "multiPop:\n  startY_A: .nan\n  priorY_B: -.inf\n"
        "scatterCluster:\n  exposures: [1, 2.5, 'x y']\n  limitMag: 1e5\n"
    ),
}

# Outside the subset: each must raise, never be guessed at.
BAD_YAML = {
    "anchor": "cluster:\n  starting_Y: &y 0.27\n",
    "alias": "cluster:\n  starting_Y: *y\n",
    "multiline_quoted": "files:\n  photFile: 'a\n    b.phot'\n",
    "multiline_plain": "files:\n  photFile: a\n    b.phot\n",
    "block_scalar": "files:\n  photFile: |\n    a.phot\n",
    "block_sequence": "models:\n  bands:\n    - U\n    - B\n",
    "flow_mapping": "mcmc: {chains: 4}\n",
    "nested_list": "models:\n  bands: [[U], B]\n",
    "tag": "mcmc:\n  seed: !!str 7\n",
    "tab": "mcmc:\n\tseed: 7\n",
    "duplicate": "mcmc:\n  seed: 7\n  seed: 8\n",
    "document_marker": "---\nmcmc:\n  seed: 7\n",
    "octal": "mcmc:\n  seed: 017\n",
    "sexagesimal": "mcmc:\n  seed: 1:30\n",
    "underscore": "mcmc:\n  runIter: 10_000\n",
    "escape": "files:\n  photFile: \"a\\tb\"\n",
    "bool_key": "on: 1\n",
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_yaml_subset_equals_pyyaml(name):
    text = CONFIGS[name]
    got, want = yaml_subset.safe_load(text), yaml.safe_load(text)
    assert repr(got) == repr(want)      # types too; nan == nan by repr


@pytest.mark.parametrize("name", sorted(BAD_YAML))
def test_yaml_subset_refuses_the_rest(name):
    with pytest.raises(ValueError, match="outside the subset"):
        yaml_subset.safe_load(BAD_YAML[name])


def test_yaml_subset_empty_document():
    assert yaml_subset.safe_load("") is yaml.safe_load("") is None
    assert yaml_subset.safe_load("# only\n\n") is None


def _settings_pair(tmp_path, name, overrides):
    cfg = tmp_path / f"{name}.yaml"
    cfg.write_text(CONFIGS[name])
    return (jsettings.load_settings(str(cfg), overrides),
            tsettings.load_settings(str(cfg), overrides))


@pytest.mark.parametrize("name,overrides", [
    ("base9", []),
    ("base9", ["mcmc.warmup=64", "mcmc.runIter=4096", "mcmc.usePallas=auto"]),
    ("roundtrip", ["mcmc.runIter=400", "mcmc.sampler=mh"]),
    ("field_box", ["cluster.fieldMagRange=11,12,13"]),
    ("scalars", ["multiPop.startY_A=0.25", "models.bands=U,B,V",
                 "mcmc.denseMass=false", "scatterCluster.exposures=1,2"]),
])
def test_settings_equal_base_tpu(tmp_path, name, overrides):
    j, t = _settings_pair(tmp_path, name, overrides)
    assert repr(dataclasses.asdict(t)) == repr(dataclasses.asdict(j))
    for m in ("start_vector", "prior_mean_vector", "prior_sigma_vector"):
        np.testing.assert_array_equal(getattr(t.cluster, m)(),
                                      getattr(j.cluster, m)())
    np.testing.assert_array_equal(t.cluster.field_mag_range_array(3),
                                  j.cluster.field_mag_range_array(3))


def test_settings_unknown_key_raises():
    for load in (jsettings.load_settings, tsettings.load_settings):
        with pytest.raises(KeyError):
            load(None, ["mcmc.doesNotExist=1"])


def test_to_yaml_round_trips(tmp_path):
    s = tsettings.load_settings(None, ["cluster.fieldMagRange=11,12",
                                       "files.photFile=a b.phot",
                                       "mcmc.usePallas=true"])
    text = tsettings.to_yaml(s)
    cfg = tmp_path / "dumped.yaml"
    cfg.write_text(text)
    back = tsettings.load_settings(str(cfg))
    assert repr(dataclasses.asdict(back)) == repr(dataclasses.asdict(s))
    assert repr(yaml.safe_load(text)) == repr(dataclasses.asdict(s))
    # base_tpu reads the port's dump to the same settings.
    assert repr(dataclasses.asdict(jsettings.load_settings(str(cfg)))) == \
        repr(dataclasses.asdict(s))


def _phot_table(mod, rng):
    t = mod.from_simulation(
        ids=None, bands=("U", "B", "V"),
        mags=rng.normal(15, 2, (7, 3)).astype(np.float32),
        sigmas=np.abs(rng.normal(0.02, 0.01, (7, 3))).astype(np.float32),
        stage=np.array([1, 1, 3, 1, 1, 3, 1]), cm_prior=0.9,
    )
    t.sigmas[2, 1] = -9.0
    t.use_dbi[4] = 0
    return t


def test_phot_writer_byte_identical_and_round_trips(tmp_path):
    jp, tp = tmp_path / "j.phot", tmp_path / "t.phot"
    jphot.write_phot(str(jp), _phot_table(jphot, np.random.default_rng(1)))
    t = _phot_table(tphot, np.random.default_rng(1))
    tphot.write_phot(str(tp), t)
    assert tp.read_bytes() == jp.read_bytes()
    back = tphot.read_phot(str(tp))
    np.testing.assert_allclose(back.mags, t.mags, atol=1e-5)
    np.testing.assert_allclose(back.sigmas, t.sigmas, atol=1e-5)
    assert back.bands == t.bands and back.ids == t.ids
    assert (back.stage == t.stage).all() and (back.use_dbi == t.use_dbi).all()
    sub = back.select(back.stage == 3).select_bands(np.array([2, 0]),
                                                    ("V", "U"))
    assert sub.n_stars == 2 and sub.mags.shape == (2, 2)


@pytest.mark.parametrize("multi", [True, False])
def test_res_writer_byte_identical_and_round_trips(tmp_path, multi):
    rng = np.random.default_rng(2)
    shape = (20, 3) if multi else (20,)
    samples = rng.normal(size=shape + (9,)).astype(np.float32)
    lp = rng.normal(size=shape).astype(np.float32)
    jp, tp = tmp_path / "j.res", tmp_path / "t.res"
    jres.write_res(str(jp), samples, lp)
    tres.write_res(str(tp), torch.from_numpy(samples).numpy(), lp)
    assert tp.read_bytes() == jp.read_bytes()
    back = tres.read_res(str(tp))
    np.testing.assert_allclose(back.params, samples.reshape(-1, 9),
                               atol=1e-5)
    np.testing.assert_allclose(back.logpost, lp.reshape(-1), atol=1e-4)
    assert (back.chain is not None) == multi
    assert tres.RES_COLUMNS == jres.RES_COLUMNS


def test_samples_writer_byte_identical_and_round_trips(tmp_path):
    rng = np.random.default_rng(3)
    ids = ["4", "7", "11"]
    cols = {"mass": rng.uniform(0.2, 2, (5, 3)).astype(np.float32),
            "massRatio": rng.uniform(0, 1, (5, 3)).astype(np.float32)}
    jp, tp = tmp_path / "j.s", tmp_path / "t.s"
    jsamples.write_star_samples(str(jp), ids, cols)
    tsamples.write_star_samples(str(tp), ids, cols)
    assert tp.read_bytes() == jp.read_bytes()
    got_ids, got = tsamples.read_star_samples(str(tp))
    assert got_ids == ids
    for k in cols:
        np.testing.assert_allclose(got[k], cols[k], atol=1e-6)
    with pytest.raises(ValueError):
        tsamples.write_star_samples(str(tp), ids[:2], cols)


@pytest.mark.parametrize("columns", [None, tuple("abcdefghijkl")])
def test_sqlite_store_byte_identical_and_round_trips(tmp_path, columns):
    rng = np.random.default_rng(4)
    P = 9 if columns is None else 12
    samples = rng.normal(size=(6, 2, P)).astype(np.float32)
    lp = rng.normal(size=(6, 2)).astype(np.float32)
    meta = {"sampler": "hmc", "seed": 7}
    jp, tp = tmp_path / "j.db", tmp_path / "t.db"
    jsqlite.write_res_sqlite(str(jp), samples, lp, meta=meta, columns=columns)
    tsqlite.write_res_sqlite(str(tp), samples, lp, meta=meta, columns=columns)
    assert tp.read_bytes() == jp.read_bytes()
    params, logpost, chain, got_meta = tsqlite.read_res_sqlite(str(tp))
    np.testing.assert_allclose(params[:, :P].reshape(6, 2, P), samples,
                               atol=1e-6)
    np.testing.assert_allclose(logpost.reshape(6, 2), lp, atol=1e-6)
    assert set(chain) == {0, 1} and got_meta == {"sampler": "hmc",
                                                 "seed": "7"}


def test_checkpoint_round_trip_with_generator_state(tmp_path):
    from base_tpu_torch.inference.hmc import DAState, HMCChainState

    gen = torch.Generator().manual_seed(5)
    torch.randn(3, generator=gen)
    c = torch.arange(4.0)
    tree = dict(
        chain_state=HMCChainState(z=torch.randn(4, 2), logpost=c,
                                  grad=torch.ones(4, 2),
                                  da=DAState(c, c + 1, c + 2, c + 3, c + 4)),
        cursor=3, gen_state=gen.get_state(),
        host=dict(a=np.arange(6, dtype=np.float32).reshape(2, 3),
                  b=[np.asarray(3), 1.5]),
    )
    p = str(tmp_path / "ck")
    tckpt.save_checkpoint(p, tree)
    assert tckpt.checkpoint_exists(p) and not Path(p + ".tmp").exists()
    like = dict(
        chain_state=HMCChainState(z=torch.zeros(4, 2), logpost=c * 0,
                                  grad=torch.zeros(4, 2),
                                  da=DAState(*(c * 0,) * 5)),
        cursor=0, gen_state=torch.Generator().get_state(),
        host=dict(a=np.zeros((2, 3), np.float32), b=[np.asarray(0), 0.0]),
    )
    got = tckpt.restore_checkpoint(p, like)
    assert isinstance(got["chain_state"], HMCChainState)
    assert isinstance(got["chain_state"].da, DAState)
    for a, b in zip(torch.utils._pytree.tree_leaves(got["chain_state"]),
                    torch.utils._pytree.tree_leaves(tree["chain_state"])):
        assert torch.equal(a, b)
    assert got["cursor"] == 3 and got["host"]["b"][1] == 1.5
    np.testing.assert_array_equal(got["host"]["a"], tree["host"]["a"])
    fresh = torch.Generator()
    fresh.set_state(got["gen_state"])
    assert torch.equal(torch.randn(5, generator=fresh),
                       torch.randn(5, generator=gen))
    like["chain_state"] = like["chain_state"]._replace(z=torch.zeros(5, 2))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(p, like)


def test_metrics_jsonl_stream():
    buf = io.StringIO()
    m = MetricsLogger(stream=buf)
    m.log("warmup_done", accept=torch.tensor(0.82), window=3)
    m.throughput("sampling", n_samples=1000, n_evals=24000, seconds=2.0,
                 chains=64)
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert lines[0]["event"] == "warmup_done"
    assert abs(lines[0]["accept"] - 0.82) < 1e-6
    assert lines[1]["samples_per_sec"] == 500.0
    assert lines[1]["evals_per_sec"] == 12000.0
    assert lines[1]["dt"] >= 0 and lines[1]["wall_s"] == 2.0


def test_profile_trace_writes_chrome_trace(tmp_path):
    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "prof")):
        with named_scope("density"):
            (torch.ones(8) * 2.0).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any(e.get("name") == "density"
               for e in trace["traceEvents"])


@pytest.mark.parametrize("before", [False, True])
def test_debug_guards_restore_state(before):
    torch.autograd.set_detect_anomaly(before, check_nan=True)
    try:
        with debug_guards(enable=True):
            assert torch.is_anomaly_enabled()
            assert torch.is_anomaly_check_nan_enabled()
            with named_scope("likelihood"):
                x = torch.ones(4) * 2.0
            assert float(x.sum()) == 8.0
            z = torch.zeros(1, requires_grad=True)
            with pytest.raises(RuntimeError, match="nan"):
                torch.sqrt(z - 1.0).backward()
        assert torch.is_anomaly_enabled() is before
        with debug_guards(enable=False):
            assert torch.is_anomaly_enabled() is before
    finally:
        torch.autograd.set_detect_anomaly(False)


def _grid_arrays(grid, fields):
    return {f: np.asarray(getattr(grid, f)) for f in fields}


ISO_FIELDS = ("feh", "y", "age", "mass", "mags", "valid", "agb_tip")


@pytest.mark.parametrize("family", jload.MS_FAMILIES)
def test_load_ms_grid_equals_base_tpu(family):
    overrides = [f"models.msRgbModel={family}", "models.bands=U,B,V,K"]
    j = jload.load_ms_grid(jsettings.load_settings(None, overrides))
    t = tload.load_ms_grid(tsettings.load_settings(None, overrides),
                           device="cpu")
    assert (t.bands, t.name) == (j.bands, j.name)
    for k, v in _grid_arrays(j, ISO_FIELDS).items():
        np.testing.assert_array_equal(getattr(t, k).numpy(), v, err_msg=k)


@pytest.mark.parametrize("family", jload.WD_FAMILIES)
def test_make_model_wd_grids_equal_base_tpu(family):
    overrides = [f"models.wdModel={family}", "models.ifmr=quadratic"]
    j = jload.make_model(jsettings.load_settings(None, overrides))
    t = tload.make_model(tsettings.load_settings(None, overrides),
                         device="cpu")
    assert t.ifmr_kind == j.ifmr_kind == "quadratic"
    assert t.wd_cooling.name == j.wd_cooling.name
    for k in ("carb", "mass", "log_age", "log_teff", "log_radius"):
        np.testing.assert_array_equal(getattr(t.wd_cooling, k).numpy(),
                                      np.asarray(getattr(j.wd_cooling, k)))
    for k in ("log_teff", "log_g", "mags"):
        np.testing.assert_array_equal(getattr(t.wd_atm, k).numpy(),
                                      np.asarray(getattr(j.wd_atm, k)))
    assert t.wd_atm.bands == j.wd_atm.bands


def test_load_npz_packed_by_base_tpu(tmp_path):
    """A model directory packed by base_tpu (isochrones through its
    save_packed_isochrones; WD cooling and atmosphere .npz in its layout)
    loads in the port unchanged."""
    s = jsettings.load_settings(None, ["models.msRgbModel=dsed"])
    jgrid = jload.load_ms_grid(s)
    jload.save_packed_isochrones(str(tmp_path / "dsed.npz"), jgrid)
    cool = jload.load_wd_cooling(s)
    np.savez(tmp_path / "wd_wood.npz",
             **{k: np.asarray(getattr(cool, k)) for k in
                ("carb", "mass", "log_age", "log_teff", "log_radius")})
    atm = jload.load_wd_atmosphere(s)
    np.savez(tmp_path / "bergeron.npz", log_teff=np.asarray(atm.log_teff),
             log_g=np.asarray(atm.log_g), mags=np.asarray(atm.mags),
             bands=np.asarray(atm.bands))
    over = ["models.msRgbModel=dsed", "models.wdModel=wood",
            f"files.modelDirectory={tmp_path}"]
    j = jload.make_model(jsettings.load_settings(None, over))
    t = tload.make_model(tsettings.load_settings(None, over), device="cpu")
    assert t.ms.name == j.ms.name == "dsed" and t.ms.bands == jgrid.bands
    for k, v in _grid_arrays(j.ms, ISO_FIELDS).items():
        np.testing.assert_array_equal(getattr(t.ms, k).numpy(), v)
    for k in ("log_teff", "log_radius"):
        np.testing.assert_array_equal(getattr(t.wd_cooling, k).numpy(),
                                      np.asarray(getattr(j.wd_cooling, k)))
    np.testing.assert_array_equal(t.wd_atm.mags.numpy(),
                                  np.asarray(j.wd_atm.mags))
    assert t.wd_atm.name == "bergeron"


def test_unknown_family_raises():
    for over in (["models.msRgbModel=mist"], ["models.wdModel=x"]):
        s = tsettings.load_settings(None, over)
        with pytest.raises(ValueError):
            tload.make_model(s, device="cpu")
    assert math.isnan(tsettings.Settings().multiPop.startY_A)
