"""The port stands alone: no module of base_tpu_torch, and none of
chip_smoke.py, scripts/torch_profiler_probe.py,
scripts/torch_mesh_cards.py, scripts/torch_longaxis.py,
scripts/torch_sbc.py and scripts/torch_slow_checks.py, imports
base_tpu or jax (nor PyYAML, which the card's machine need not have); the
port's own copies of base_tpu's JAX-free constants, filter tables,
settings, .res columns and model families equal the originals; and the
port's API is base_tpu's but for the listed departures."""
import ast
import dataclasses
from pathlib import Path

import numpy as np

from base_tpu import constants as jconst
from base_tpu.grids import filters as jfilt
from base_tpu.grids import load as jload
from base_tpu.io import res as jres
from base_tpu.io import settings as jsettings
from base_tpu_torch import constants as tconst
from base_tpu_torch.grids import filters as tfilt
from base_tpu_torch.grids import load as tload
from base_tpu_torch.io import res as tres
from base_tpu_torch.io import settings as tsettings

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("base_tpu", "jax", "yaml")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


def test_port_imports_no_base_tpu_or_jax():
    files = sorted((ROOT / "base_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts/torch_profiler_probe.py",
              ROOT / "scripts/torch_mesh_cards.py",
              ROOT / "scripts/torch_longaxis.py",
              ROOT / "scripts/torch_sbc.py",
              ROOT / "scripts/torch_slow_checks.py"]
    assert len(files) > 20
    for module in ("model/multipop.py", "inference/vi.py",
                   "inference/mh.py", "inference/nuts.py",
                   "inference/smc.py", "io/settings.py", "io/yaml_subset.py",
                   "io/phot.py", "io/res.py", "io/samples.py",
                   "io/sqlite_store.py", "io/checkpoint.py",
                   "utils/metrics.py", "grids/load.py",
                   "inference/driver.py", "tools/main.py", "grids/parse.py",
                   "io/native.py", "parallel/distributed.py",
                   "parallel/mesh.py", "parallel/comm.py",
                   "parallel/run.py"):
        assert ROOT / "base_tpu_torch" / module in files
    bad = [
        f"{p.relative_to(ROOT)}: {mod}"
        for p in files
        for mod in _imported_modules(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_port_constants_and_filters_equal_base_tpu():
    assert tconst.NPARAMS == jconst.NPARAMS
    assert tconst.PARAM_NAMES == jconst.PARAM_NAMES
    assert tconst.IMF_LOG_MEAN == jconst.IMF_LOG_MEAN
    assert tconst.IMF_LOG_SIGMA == jconst.IMF_LOG_SIGMA
    assert tconst.MBOL_SUN == jconst.MBOL_SUN
    assert tconst.MAX_WD_PRECURSOR_MASS == jconst.MAX_WD_PRECURSOR_MASS
    for name in ("MAG_FLUX_COEF", "LOG10_E", "EPS", "MIN_MASS"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    for enum_name in ("Param", "StarStatus", "WdType"):
        t_enum = getattr(tconst, enum_name)
        j_enum = getattr(jconst, enum_name)
        assert {m.name: int(m) for m in t_enum} == {
            m.name: int(m) for m in j_enum}
    assert tfilt.FILTERS == jfilt.FILTERS
    assert tfilt.DEFAULT_BANDS == jfilt.DEFAULT_BANDS
    bands = list(jfilt.FILTERS)
    assert (tfilt.wavelengths(bands) == jfilt.wavelengths(bands)).all()
    assert (tfilt.absorption_coefs(bands)
            == jfilt.absorption_coefs(bands)).all()
    assert tfilt.absorption_coefs(bands).dtype == jfilt.absorption_coefs(
        bands).dtype


def test_port_host_copies_equal_base_tpu():
    """The JAX-free copies of the host layer: Settings() defaults, the .res
    columns, the model families and the synthetic grids' axis spans."""
    assert repr(dataclasses.asdict(tsettings.Settings())) == repr(
        dataclasses.asdict(jsettings.Settings()))
    assert tres.RES_COLUMNS == jres.RES_COLUMNS
    assert tload.MS_FAMILIES == jload.MS_FAMILIES
    assert tload.WD_FAMILIES == jload.WD_FAMILIES
    for family in jload.MS_FAMILIES:
        s = jsettings.load_settings(None, [f"models.msRgbModel={family}"])
        grid = jload.load_ms_grid(s)
        spans = tload.SYNTHETIC_SPANS[family]
        for axis in ("feh", "y", "age"):
            assert (np.linspace(*spans[axis]).astype(np.float32)
                    == np.asarray(getattr(grid, axis))).all(), (family, axis)


def test_port_ingest_copies_equal_base_tpu():
    """The grid converter's recognised extensions, and the native IO
    runtime's C++ source line for line once comments are set aside."""
    import re

    from base_tpu.grids import parse as jparse
    from base_tpu_torch.grids import parse as tparse

    assert tparse.MS_EXTS == jparse.MS_EXTS
    assert tparse.WD_EXTS == jparse.WD_EXTS

    def code(path):
        lines = (re.sub(r"//.*", "", ln).rstrip()
                 for ln in path.read_text().splitlines())
        return [ln for ln in lines if ln]

    assert code(ROOT / "base_tpu_torch/io/basetpu_io.cpp") == code(
        ROOT / "native/basetpu_io.cpp")


def test_port_parallel_names_equal_base_tpu():
    """The parallel layer keeps base_tpu's names: every public function of
    base_tpu.parallel's modules has its counterpart (utils/vma.py has none:
    parallel.comm's enter / reduce_sum do its job), the axis names are
    base_tpu's, and pad_to_multiple agrees."""
    import inspect

    from base_tpu.parallel import distributed as jdist
    from base_tpu.parallel import mesh as jmesh
    from base_tpu.parallel import run as jrun
    from base_tpu_torch.parallel import distributed as tdist
    from base_tpu_torch.parallel import mesh as tmesh
    from base_tpu_torch.parallel import run as trun

    for jmod, tmod in ((jdist, tdist), (jmesh, tmesh), (jrun, trun)):
        names = [n for n, f in vars(jmod).items()
                 if inspect.isfunction(f) and f.__module__ == jmod.__name__
                 and not n.startswith("_")]
        assert names
        missing = [n for n in names if not callable(getattr(tmod, n, None))]
        assert not missing, (tmod.__name__, missing)
    assert (tmesh.CHAIN_AXIS, tmesh.STAR_AXIS) == (jmesh.CHAIN_AXIS,
                                                   jmesh.STAR_AXIS)
    for n, k in ((50, 4), (52, 4), (1, 3), (10000, 2)):
        assert tmesh.pad_to_multiple(n, k) == jmesh.pad_to_multiple(n, k)


# ---- the port's API against base_tpu's, by ast over both trees ------------

# base_tpu modules the port holds under another path: the Pallas kernels'
# wrappers are the CUDA kernels' (ops/table.py, ops/marglik.py).
MODULE_MAP = {"ops/pallas_table.py": "ops/table.py",
              "ops/pallas_marglik.py": "ops/marglik.py"}
# Keyword names the port renames everywhere, base_tpu's -> the port's.
RENAMES = {
    "key": "gen",               # a torch.Generator takes the JAX key's place
    "axis_name": "group",       # a process group takes the shard_map axis's
    "star_axis": "star_group",  # the star group of the mesh
}
# Port functions that take another function's keywords through *args,
# **kwargs (base_tpu module, name) -> (port module, name).
DELEGATES = {
    ("model/posterior.py", "make_single_pop_model"):
        ("model/posterior.py", "make_model"),
    ("model/multipop.py", "make_multipop_model"):
        ("model/posterior.py", "make_model"),
}
_DO_NOT_PORT = "ROADMAP's Do not port: "
# The accepted departures: (module,) a module, (module, name) a public
# function or class, (module, name, keyword) a keyword or field; each
# with its reason.  A name base_tpu has and the port lacks that is not
# here fails test_port_api_matches_base_tpu; so does an entry that no
# longer names a departure.  Keywords the port adds (`device=`, the
# driver's `checkpoint_path=`, ...) are not departures: only base_tpu's
# names are held.  The star sets and replica blocks, which take the place
# of base_tpu's vmap over data sets, are listed as departures all the same
# (names and keywords base_tpu lacks, under base_tpu's module paths), and
# held to still be the port's.
_NO_VMAP = ("torch has no vmap through the port's kernels and generators: "
            "base_tpu's vmap over data sets (tests/test_calibration.py) "
            "becomes ")
_SETS = _NO_VMAP + "a star-set axis on the stars"
_REPLICAS = _NO_VMAP + "replica blocks of chains, each adapting on its own"
DEPARTURES = {
    ("model/stardata.py", "stack_ms_stars"): _SETS,
    ("model/stardata.py", "require_one_set"):
        _SETS + "; what takes one set says so",
    ("model/stardata.py", "MSStars.stacked"): _SETS,
    ("model/stardata.py", "MSStars.n_sets"): _SETS,
    ("ops/pallas_marglik.py", "chain_rows"): _SETS,
    **{("inference/hmc.py", name, "replicas"): _REPLICAS
       for name in ("run_hmc", "init_chains", "make_warmup_window",
                    "_window_update", "warmup", "freeze_step_size",
                    "sample_chunk", "hmc_transition")},
    ("utils/vma.py",): "torch has no varying-axes types; parallel.comm's "
                       "enter / reduce_sum do its job",
    ("grids/isochrone.py", "eep_mass_weights"):
        _DO_NOT_PORT + "only tests/test_grids.py calls it",
    ("model/likelihood.py", "ms_star_log_marginals_logspace"):
        _DO_NOT_PORT + "a cross-check of the JAX tests",
    ("model/likelihood.py", "gaussian_loglik_matrix"):
        _DO_NOT_PORT + "a cross-check of the JAX tests",
    ("model/likelihood.py", "gaussian_loglik_matmul"):
        _DO_NOT_PORT + "a cross-check of the JAX tests",
    ("model/wd.py", "wd_star_log_marginals_nodal"):
        _DO_NOT_PORT + "a cross-check of the JAX tests",
    ("ops/special.py", "log_gaussian"): _DO_NOT_PORT + "no caller",
    ("ops/special.py", "phi_interval"): _DO_NOT_PORT + "no caller",
    ("ops/special.py", "logaddexp"): _DO_NOT_PORT + "no caller",
    ("utils/transforms.py", "jax_sigmoid"):
        "JAX's sigmoid with its custom derivative; torch.sigmoid is the "
        "port's",
    ("inference/hmc.py", "_vmap_chains"):
        "vmap in chain blocks; value_and_grad's chain_chunk blocks replace "
        "it",
    ("inference/driver.py", "run_checkpointed"):
        "folded into make_hmc_chunked_runner (its checkpoint_path)",
    ("inference/driver.py", "run_hmc_chunked"):
        "folded into make_hmc_chunked_runner",
    ("inference/driver.py", "DriverConfig", "checkpoint_every"):
        "folded into make_hmc_chunked_runner: a checkpoint after every "
        "chunk",
    ("inference/hmc.py", "HMCChainState", "key"):
        "the chain states carry no key: one torch.Generator drives a run",
    ("inference/nuts.py", "NUTSChainState", "key"):
        "the chain states carry no key: one torch.Generator drives a run",
    ("inference/mh.py", "MHState", "key"):
        "the chain states carry no key: one torch.Generator drives a run",
    ("inference/smc.py", "SMCState", "key"):
        "the particle state carries no key: its generators drive a run",
    ("inference/hmc.py", "init_chains", "key"):
        "the chain states carry no key, so their start takes none",
    ("inference/nuts.py", "init_nuts_chains", "key"):
        "the chain states carry no key, so their start takes none",
    ("model/likelihood.py", "build_segment_table_fused", "interpret"):
        "Pallas's interpret mode: a CPU tensor takes the plain version",
    ("ops/pallas_table.py", "fused_combined_node_mags", "interpret"):
        "Pallas's interpret mode: a CPU tensor takes the plain version",
    ("ops/pallas_marglik.py", "fused_log_marginals", "interpret"):
        "Pallas's interpret mode: a CPU tensor takes the plain version",
    ("parallel/mesh.py", "make_mesh", "devices"):
        "one rank per mesh position, each with its own device",
    ("parallel/distributed.py", "initialize", "coordinator_address"):
        "JAX's coordinator: torch.distributed's init_method",
    ("parallel/distributed.py", "initialize", "num_processes"):
        "JAX's coordinator: torch.distributed's world_size",
    ("parallel/distributed.py", "initialize", "process_id"):
        "JAX's coordinator: torch.distributed's rank",
    ("parallel/run.py", "make_sharded_hmc_fns", "inv_mass0"):
        "moved to the returned callable's inv_mass0",
}


def _arg_names(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [f"*{v.arg}" for v in (a.vararg, a.kwarg) if v]


def _api(path: Path) -> dict:
    """{name: ("def", [keywords]) | ("class", [bases], [fields],
    {method: [keywords]}) | ("const",)} of a module's top level."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", _arg_names(node))
        elif isinstance(node, ast.ClassDef):
            out[node.name] = (
                "class", [b.id for b in node.bases if isinstance(b, ast.Name)],
                [s.target.id for s in node.body
                 if isinstance(s, ast.AnnAssign)
                 and isinstance(s.target, ast.Name)],
                {s.name: _arg_names(s) for s in node.body
                 if isinstance(s, ast.FunctionDef)
                 and not s.name.startswith("_")})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign)
                      else [node.target]):
                if isinstance(t, ast.Name):
                    out[t.id] = ("const",)
    return out


def _tree(pkg: str) -> dict:
    base = ROOT / pkg
    return {str(p.relative_to(base)): _api(p)
            for p in sorted(base.rglob("*.py"))}


def _fields(tree: dict, module: str, name: str) -> list:
    """A class's annotated fields, its bases' (found by name in its
    module, then anywhere in the tree) first."""
    _, bases, fields, _ = tree[module][name]
    inherited = []
    for b in bases:
        home = module if b in tree[module] else next(
            (m for m, api in tree.items()
             if api.get(b, ("",))[0] == "class"), None)
        if home is not None:
            inherited += _fields(tree, home, b)
    return inherited + fields


def _missing_keywords(want: list, have: list) -> list:
    return [k for k in want
            if k not in have and RENAMES.get(k) not in have]


def _api_departures() -> dict:
    """{departure key: what base_tpu has and the port lacks}."""
    jtree, ttree = _tree("base_tpu"), _tree("base_tpu_torch")
    named = {d[1] for d in DEPARTURES if len(d) == 2}
    found = {}
    for jmod, japi in jtree.items():
        tmod = MODULE_MAP.get(jmod, jmod)
        if tmod not in ttree:
            found[(jmod,)] = "module"
            continue
        tapi = ttree[tmod]
        for name, jv in japi.items():
            public = not name.startswith("_")
            if jv[0] == "const":
                if public and jmod == "constants.py" and name not in tapi:
                    found[(jmod, name)] = "constant"
                continue
            if not public and name not in named:
                continue
            if name not in tapi or tapi[name][0] != jv[0]:
                found[(jmod, name)] = jv[0]
                continue
            if jv[0] == "def":
                dmod, dname = DELEGATES.get((jmod, name), (tmod, name))
                have = ttree[dmod][dname][1]
                for k in _missing_keywords(jv[1], have):
                    found[(jmod, name, k)] = "keyword"
                continue
            for k in _missing_keywords(_fields(jtree, jmod, name),
                                       _fields(ttree, tmod, name)):
                found[(jmod, name, k)] = "field"
            tmeth = tapi[name][3]
            for meth, kws in jv[3].items():
                if meth not in tmeth:
                    found[(jmod, f"{name}.{meth}")] = "method"
                    continue
                for k in _missing_keywords(kws, tmeth[meth]):
                    found[(jmod, f"{name}.{meth}", k)] = "keyword"
    return found


def _api_additions() -> set:
    """Keys, as in DEPARTURES, of what the port adds: public functions,
    classes and class methods base_tpu's module lacks, and keywords its
    functions (public, or named in DEPARTURES) lack."""
    jtree, ttree = _tree("base_tpu"), _tree("base_tpu_torch")
    named = {d[1] for d in DEPARTURES if len(d) >= 2}
    added = set()
    for jmod, japi in jtree.items():
        tapi = ttree.get(MODULE_MAP.get(jmod, jmod), {})
        for name, tv in tapi.items():
            if tv[0] == "const" or (name.startswith("_")
                                    and name not in named):
                continue
            jv = japi.get(name)
            if jv is None or jv[0] != tv[0]:
                added.add((jmod, name))
            elif tv[0] == "def":
                added |= {(jmod, name, k) for k in tv[1]
                          if k not in jv[1] and k not in RENAMES.values()}
            else:
                added |= {(jmod, f"{name}.{m}") for m in tv[3]
                          if m not in jv[3]}
    return added


def test_port_api_matches_base_tpu():
    """Every public function and class of every module of base_tpu (and
    the constants of constants.py) has its counterpart in the port; every
    keyword of those functions and of their classes' public methods, and
    every field of those classes (dataclasses, NamedTuples; inherited ones
    included), is the port's too, under RENAMES; the exceptions are
    DEPARTURES, each with its reason, and each still a departure.  By ast
    over both trees: nothing of base_tpu is imported."""
    found = _api_departures()
    unlisted = {k: v for k, v in found.items() if k not in DEPARTURES}
    assert not unlisted, unlisted
    added = _api_additions()
    stale = [k for k in DEPARTURES if k not in found and k not in added]
    assert not stale, stale
    assert all(DEPARTURES.values())
    assert len(found) >= 25        # the walk saw both trees
