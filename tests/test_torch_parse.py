"""The port's grid text parsers, writers, converter and `convert-models`
CLI (base_tpu_torch.grids.parse, grids.load.save_packed_isochrones,
tools.main) against base_tpu's on the texts of tests/test_parse.py and
tests/test_parse_fuzz.py: parsed arrays equal, written files byte for
byte, and the same exception types and messages at the same inputs."""
import os

import numpy as np
import pytest
import torch

from base_tpu.grids import parse as jparse
from base_tpu.grids import synthetic as jsyn
from base_tpu.grids import wd_atmosphere as jwda
from base_tpu.grids import wd_cooling as jwdc
from base_tpu.tools import main as jmain
from base_tpu_torch import convert
from base_tpu_torch.grids import parse as tparse
from base_tpu_torch.grids import wd_atmosphere as twda
from base_tpu_torch.grids import wd_cooling as twdc
from base_tpu_torch.grids.load import make_model
from base_tpu_torch.io.settings import load_settings
from base_tpu_torch.tools import main as tmain

torch.set_num_threads(1)

BANDS = ("U", "B", "V", "R", "I", "J", "H", "K")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_grid(got, want, names):
    for name in names:
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        assert g.dtype == w.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert getattr(got, "bands", None) == getattr(want, "bands", None)
    assert got.name == want.name


MS_FIELDS = ("feh", "y", "age", "mass", "mags", "valid", "agb_tip")
WD_FIELDS = ("carb", "mass", "log_age", "log_teff", "log_radius")
ATM_FIELDS = ("log_teff", "log_g", "mags")


@pytest.fixture(scope="module")
def jgrids():
    ms = jsyn.make_grid(feh_axis=np.linspace(-1.0, 0.2, 3),
                        y_axis=np.linspace(0.24, 0.30, 2),
                        age_axis=np.linspace(8.8, 9.8, 3), n_eep=16,
                        bands=BANDS, ragged=True)
    cool = jwdc.synthetic_wd_cooling(n_mass=4, n_age=12,
                                     with_carbonicity=True)
    flat = jwdc.synthetic_wd_cooling(n_mass=4, n_age=12,
                                     with_carbonicity=False)
    atm = jwda.synthetic_bergeron(bands=BANDS, n_teff=6, n_logg=4)
    return dict(ms=ms, cool=cool, flat=flat, atm=atm)


def _port(kind, g):
    """The port's grid with the arrays of base_tpu grid g."""
    f = {k: np.asarray(v) for k, v in vars(g).items()
         if k not in ("bands", "name")}
    if kind == "ms":
        return convert.grid_from_numpy(**f, bands=g.bands, name=g.name,
                                       device="cpu")
    if kind in ("cool", "flat"):
        return twdc.pack(f["carb"], f["mass"], f["log_age"], f["log_teff"],
                         f["log_radius"], name=g.name, device="cpu")
    return twda.WdAtmosphereGrid(**{k: torch.from_numpy(v)
                                    for k, v in f.items()},
                                 bands=g.bands, name=g.name)


def _write_both(tmp_path, kind, g, *extra):
    writer = {"ms": "write_ms_model", "cool": "write_wd_cooling",
              "flat": "write_wd_cooling", "atm": "write_bergeron_table"}[kind]
    pj, pt = tmp_path / f"{kind}.j", tmp_path / f"{kind}.t"
    getattr(jparse, writer)(str(pj), g, *extra)
    getattr(tparse, writer)(str(pt), _port(kind, g), *extra)
    return pj.read_bytes(), pt.read_bytes()


@pytest.mark.parametrize("kind,extra", [("ms", ()), ("cool", ()),
                                        ("flat", ()), ("atm", (0,)),
                                        ("atm", (1,))])
def test_writers_byte_identical(tmp_path, jgrids, kind, extra):
    want, got = _write_both(tmp_path, kind, jgrids[kind], *extra)
    assert got == want


def test_parsers_equal_on_written_texts(tmp_path, jgrids):
    """Each format written by base_tpu and parsed by both: the arrays
    equal, the port's float32 on the CPU."""
    jw, _ = _write_both(tmp_path, "ms", jgrids["ms"])
    text = jw.decode()
    got = tparse.parse_ms_model(text, name="girardi")
    assert got.mass.device == torch.device("cpu")
    _same_grid(got, jparse.parse_ms_model(text, name="girardi"), MS_FIELDS)
    for kind in ("cool", "flat"):
        text = _write_both(tmp_path, kind, jgrids[kind])[0].decode()
        _same_grid(tparse.parse_wd_cooling(text, n_age=12, name=kind),
                   jparse.parse_wd_cooling(text, n_age=12, name=kind),
                   WD_FIELDS)
    da = _write_both(tmp_path, "atm", jgrids["atm"], 0)[0].decode()
    db = _write_both(tmp_path, "atm", jgrids["atm"], 1)[0].decode()
    _same_grid(tparse.parse_bergeron(da, db, BANDS),
               jparse.parse_bergeron(da, db, BANDS), ATM_FIELDS)
    coarse = jwda.synthetic_bergeron(bands=BANDS, n_teff=4, n_logg=3)
    db = _write_both(tmp_path, "atm", coarse, 1)[0].decode()
    _same_grid(tparse.parse_bergeron(da, db, BANDS),       # DB re-gridded
               jparse.parse_bergeron(da, db, BANDS), ATM_FIELDS)


def _dialects(text):
    """tests/test_parse_fuzz.py's benign variations of an MS text."""
    tabbed = "\n".join("\t".join(ln.split())
                       if ln and not ln.startswith("#") else ln
                       for ln in text.splitlines())
    crlf = "\r\n\r\n".join(text.splitlines()) + "\r\n"
    commented = "\n".join(("# interleaved comment\n" if i % 3 == 0 else "")
                          + "   " + ln
                          for i, ln in enumerate(text.splitlines()))
    return (tabbed, crlf, commented)


KV_TEXT = ("%s U B\n%f [Fe/H] = -0.5  Y=0.27\n%a logAge =9.0\n"
           "1 0.5 4.0 3.0\n2 0.6 3.5 2.5\n")
EEP_TEXT = ("%s V I\n%f [Fe/H]=0.0 Y=0.25\n%a logAge=9.0\n5 1.0 4.0 3.5\n"
            "6 1.1 3.8 3.3\n7 1.2 3.6 3.1\n%a logAge=9.5\n6 0.9 4.5 4.0\n"
            "7 1.0 4.2 3.7\n")


def test_ms_dialects_parse_equal(tmp_path, jgrids):
    text = _write_both(tmp_path, "ms", jgrids["ms"])[0].decode()
    for variant in (*_dialects(text), KV_TEXT, EEP_TEXT):
        _same_grid(tparse.parse_ms_model(variant),
                   jparse.parse_ms_model(variant), MS_FIELDS)


BAD = [
    ("parse_ms_model", "%s V\n1 1.0 4.0\n"),
    ("parse_ms_model", "%s V\n%f [Fe/H]=0 Y=0.25\n%a logAge=9\n1 1.0\n"),
    ("parse_ms_model", "%s U B\n1 0.5 4.0 3.0\n"),
    ("parse_ms_model", "%s U\n%a logAge=9.0\n"),
    ("parse_ms_model", "%f [Fe/H]=-0.5 Y=0.27\n%a logAge=9.0\n1 0.5 4.0\n"),
    ("parse_ms_model",
     "%s U B\n%f [Fe/H]=-0.5 Y=0.27\n%a logAge=9.0\n1 xyz 4.0 3.0\n"),
    ("parse_ms_model", "%s U\n%q whatever\n"),
    ("parse_ms_model", "%s U\n%f [Fe/H]=-0.5\n"),
    ("parse_ms_model", "%s U\n%f [Fe/H]=-0.5 Y=0.27\n%a age=9\n"),
    ("parse_ms_model", "# nothing here\n"),
    ("parse_ms_model", "%s\n"),
    ("parse_wd_cooling", "%m heavy\n8.0 4.0 -2.0\n"),
    ("parse_wd_cooling", "%m 0.6\n8.0 4.0\n"),
    ("parse_wd_cooling", "%m 0.6\n8.0 four -2.0\n"),
    ("parse_wd_cooling", "%c 0.2\n%m 0.6\n8.0 4.0 -2.0\n9.0 3.8 -2.1\n"
                         "%c 0.8\n%m 0.7\n8.0 4.1 -2.0\n9.0 3.9 -2.1\n"),
    ("parse_wd_cooling", "8.0 4.0 -2.0\n"),
    ("parse_wd_cooling", "%x 1\n"),
    ("parse_wd_cooling", "# empty\n"),
    ("_parse_bergeron_table", "Teff logg U\n5000 7.0 13.0\n", ["V"]),
    ("_parse_bergeron_table", "T logg U\n5000 7.0 13.0\n", ["U"]),
    ("_parse_bergeron_table", "Teff logg U\n5000 7.0 13.0 99.0\n", ["U"]),
    ("_parse_bergeron_table",
     "Teff logg U\n5000 7.0 13.0\nTeff logg U\n6000 7.0 12.0\n", ["U"]),
    ("_parse_bergeron_table", "# nope\n", ["U"]),
]


@pytest.mark.parametrize("case", range(len(BAD)))
def test_parse_errors_match(case):
    """Damaged inputs raise the same exception type with the same message
    (which names the line and what was expected)."""
    fn, text, *extra = BAD[case]
    with pytest.raises(Exception) as want:
        getattr(jparse, fn)(text, *extra)
    with pytest.raises(want.type) as got:
        getattr(tparse, fn)(text, *extra)
    assert str(got.value) == str(want.value)


def _text_dir(root, jgrids):
    src = root / "text"
    os.makedirs(src)
    jparse.write_ms_model(str(src / "girardi.ms"), jgrids["ms"])
    jparse.write_wd_cooling(str(src / "montgomery.wd"), jgrids["cool"])
    jparse.write_bergeron_table(str(src / "Table_DA"), jgrids["atm"], 0)
    jparse.write_bergeron_table(str(src / "Table_DB"), jgrids["atm"], 1)
    (src / "README").write_text("not a grid\n")
    return src


def test_convert_models_cli_matches_base_tpu(tmp_path, jgrids, capsys):
    """`convert-models --src --dst` of both CLIs on one text directory:
    the same messages (but for the directory), the same files, every
    array equal, and the port's make_model serves them."""
    src = _text_dir(tmp_path, jgrids)
    outs = {}
    for name, cli in (("j", jmain), ("t", tmain)):
        dst = tmp_path / name
        cli.main(["convert-models", "--src", str(src), "--dst", str(dst)])
        outs[name] = capsys.readouterr().out.replace(str(dst), "DST")
        assert sorted(os.listdir(dst)) == [
            "bergeron.npz", "girardi.npz", "wd_montgomery.npz"]
    assert outs["t"] == outs["j"]
    for fn in os.listdir(tmp_path / "j"):
        want, got = (np.load(tmp_path / d / fn) for d in ("j", "t"))
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    s = load_settings(None, [f"files.modelDirectory={tmp_path / 't'}",
                             "models.msRgbModel=girardi",
                             "models.wdModel=montgomery"])
    bundle = make_model(s, device="cpu")
    assert bundle.ms.name == "girardi" and bundle.ms.bands == BANDS
    np.testing.assert_array_equal(
        bundle.ms.mags.numpy(), np.load(tmp_path / "j" / "girardi.npz")["mags"])
    assert bundle.wd_atm.name == "bergeron"


def test_convert_models_cli_refusals(tmp_path):
    """No --src/--dst and no modelDirectory: both CLIs exit with the same
    message; a directory with no grid in it writes nothing and says so."""
    msgs = []
    for cli in (jmain, tmain):
        with pytest.raises(SystemExit) as e:
            cli.main(["convert-models"])
        msgs.append(e.value.code)
    assert msgs[1] == msgs[0] and "--src" in msgs[0]
    empty = tmp_path / "empty"
    os.makedirs(empty)
    assert tparse.convert_model_directory(str(empty), str(tmp_path / "o")) \
        == jparse.convert_model_directory(str(empty), str(tmp_path / "o")) \
        == []
