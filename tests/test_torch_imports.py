"""The port stands alone: no module of base_tpu_torch, and none of
chip_smoke.py, scripts/torch_profiler_probe.py and
scripts/torch_mesh_cards.py, imports base_tpu or jax
(nor PyYAML, which the card's machine need not have); and the port's own
copies of base_tpu's JAX-free constants, filter tables, settings, .res
columns and model families equal the originals."""
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
              ROOT / "scripts/torch_mesh_cards.py"]
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
    for enum_name in ("Param", "StarStatus"):
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
