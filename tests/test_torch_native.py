"""The port's native IO runtime (base_tpu_torch.io.native: its own copy of
the C++ table parser and async writer, built with g++ into
base_tpu_torch/_build/) against base_tpu's on tests/test_native.py's
cases."""
import numpy as np
import pytest

from base_tpu.io import native as jnative
from base_tpu_torch.io import native as tnative


@pytest.fixture(scope="module")
def table_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("native") / "table.txt"
    rng = np.random.default_rng(11)
    with open(p, "w") as f:
        f.write("# a comment line\n")
        f.write("colA colB colC colD\n")
        np.savetxt(f, rng.normal(size=(2000, 4)))
    return str(p)


def test_native_builds_into_the_port():
    """The library builds from the port's source into its own build
    directory, keyed on the source's hash, never into native/."""
    assert tnative.native_available(), "g++ toolchain present; lib must build"
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "base_tpu_torch"


def test_parse_table_matches_base_tpu(table_file):
    got, header = tnative.parse_table(table_file)
    want, want_header = jnative.parse_table(table_file)
    assert header == want_header == "colA colB colC colD"
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.loadtxt(table_file, skiprows=2),
                               rtol=1e-12)


def test_parse_table_python_fallback_matches(table_file):
    got, header = tnative._parse_table_py(table_file)
    want, want_header = jnative._parse_table_py(table_file)
    assert header == want_header
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("text", ["1 2 3\n4 5\n", "1 2\nx y\n3 4\n"])
def test_parse_table_refusals_match(tmp_path, text):
    """A ragged table and a second header line: both raise ValueError,
    natively and in the fallback."""
    p = tmp_path / "bad.txt"
    p.write_text(text)
    for mod in (tnative, jnative):
        with pytest.raises(ValueError):
            mod.parse_table(str(p))
        with pytest.raises(ValueError):
            mod._parse_table_py(str(p))


@pytest.mark.parametrize("append", [False, True])
def test_async_writer_matches_base_tpu(tmp_path, append):
    """5000 rows through each writer (and, with `append`, a second writer
    appending to the first's file): the files are byte-identical, complete
    and in order."""
    out = {}
    for name, mod in (("t", tnative), ("j", jnative)):
        p = str(tmp_path / f"{name}.txt")
        with mod.AsyncWriter(p) as w:
            for i in range(5000):
                w.write(f"row {i}\n")
        if append:
            with mod.AsyncWriter(p, append=True) as w:
                w.write("second\n")
                assert w.pending() >= 0
        out[name] = open(p, "rb").read()
    assert out["t"] == out["j"]
    lines = out["t"].decode().splitlines()
    assert len(lines) == 5000 + append
    assert lines[0] == "row 0" and lines[4999] == "row 4999"
