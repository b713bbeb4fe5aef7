"""The port stands alone: no module of base_tpu_torch, and not chip_smoke.py,
imports base_tpu or jax; and the port's own copies of base_tpu's JAX-free
constants and filter tables equal the originals."""
import ast
from pathlib import Path

from base_tpu import constants as jconst
from base_tpu.grids import filters as jfilt
from base_tpu_torch import constants as tconst
from base_tpu_torch.grids import filters as tfilt

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("base_tpu", "jax")


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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [
        f"{p.relative_to(ROOT)}: {mod}"
        for p in files
        for mod in _imported_modules(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_port_constants_and_filters_equal_base_tpu():
    assert tconst.NPARAMS == jconst.NPARAMS
    assert tconst.IMF_LOG_MEAN == jconst.IMF_LOG_MEAN
    assert tconst.IMF_LOG_SIGMA == jconst.IMF_LOG_SIGMA
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
