"""Text-format parsers for upstream model-grid files + npz converter
(port of base_tpu.grids.parse).

The reference loads its stellar-model grids from text files shipped in a
separate "models" download [upstream: base9/MsRgbModels/GenericMsModel.cpp,
base9/WdCoolingModels/*.cpp, base9/WdAtmosphereModels/
BergeronAtmosphereModel.cpp — SURVEY.md C5-C7, L0].  That data is not
available offline (SURVEY.md §0), so this module defines the ingestion
layer in two honest pieces:

1. **Parsers** for the grid text formats, written against the documented
   structure of the upstream files ([M]-confidence reconstruction per
   SURVEY.md §0 — re-verify field order against base-cpp in §7 step 0):

   * MS/RGB unified isochrone format (GenericMsModel-style): `#` comments;
     one filter-declaration line `%s <band names...>`; section markers
     `%f [Fe/H]=<v> ... Y=<v>` (new metallicity/helium cell) and
     `%a logAge=<v>` (new isochrone); data rows `eep mass mag_1 ... mag_B`.
   * WD cooling tracks: `%c <carbonicity>` (optional; families without a
     carbonicity axis omit it), `%m <wd mass>` (new track), rows
     `logAge logTeff logRadius` (ragged per track).
   * Bergeron photometric tables (`Table_DA` / `Table_DB`, the public
     bergeron/tables format): one header line of column names
     (`Teff  log g  ... U B V ...`), then numeric rows on a rectangular
     (Teff, logg) lattice.

2. **A converter** (`convert_model_directory`, CLI `convert-models`) that
   packs parsed grids into the dense `.npz` containers `grids/load.py`
   serves to the device — parse once on the host, interpolate forever
   on-chip.

Writers for each format are included so tests can round-trip synthetic
families through the real parse path, and so that the upstream data, once
at hand, can be diffed against them quickly.

The parsing runs in numpy on the host; the grids come back as the port's
`IsochroneGrid` / `WdCoolingGrid` / `WdAtmosphereGrid` on `device` (the CPU
unless asked otherwise).  The writers' output and the parse errors (types
and messages) are base_tpu's.
"""
from __future__ import annotations

import os
import re
from typing import Sequence

import numpy as np
import torch

from base_tpu_torch.grids import wd_atmosphere as wda
from base_tpu_torch.grids import wd_cooling as wdc
from base_tpu_torch.grids.filters import FILTERS
from base_tpu_torch.grids.isochrone import IsochroneGrid

_KV_RE = re.compile(r"([^\s=]+)\s*=\s*([-+0-9.eE]+)")


def _np(t) -> np.ndarray:
    """A grid array as numpy, wherever it lives."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _parse_kv(line: str) -> dict[str, float]:
    """Parse `key=value` pairs; `[Fe/H]=-1.0` keys map to `feh`."""
    out: dict[str, float] = {}
    for key, val in _KV_RE.findall(line):
        k = key.strip().lstrip("[").rstrip("]").lower()
        if k in ("fe/h", "feh"):
            k = "feh"
        elif k == "logage":
            k = "logage"
        out[k] = float(val)
    return out


# --------------------------------------------------------------------------
# MS/RGB isochrone grids
# --------------------------------------------------------------------------


def parse_ms_model(text: str, name: str = "", *,
                   device: torch.device | str = "cpu") -> IsochroneGrid:
    """Parse a unified MS/RGB isochrone model file into an IsochroneGrid.

    Isochrones are packed **EEP-aligned**: each data row's leading EEP
    number indexes its slot (offset by the global minimum EEP), so the
    2x2x2 corner blend in `derive_isochrone` matches equivalent
    evolutionary points across grid cells — the reference's EEP-matched
    interpolation [SURVEY.md C5], not positional alignment.
    """
    bands: list[str] = []
    # cell key (feh, y) -> age -> list of (eep, mass, mags)
    cells: dict[tuple[float, float], dict[float, list]] = {}
    cur_cell: dict[float, list] | None = None
    cur_iso: list | None = None

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("%s"):
            bands = line[2:].split()
            if not bands:
                raise ValueError(
                    f"{name or 'ms model'} line {lineno}: %s filter line "
                    f"declares no bands"
                )
            continue
        if line.startswith("%f"):
            kv = _parse_kv(line)
            if "feh" not in kv or "y" not in kv:
                raise ValueError(
                    f"{name or 'ms model'} line {lineno}: %f section needs "
                    f"[Fe/H]=<v> and Y=<v>, got {line!r}"
                )
            key = (kv["feh"], kv["y"])
            cur_cell = cells.setdefault(key, {})
            cur_iso = None
            continue
        if line.startswith("%a"):
            kv = _parse_kv(line)
            if "logage" not in kv:
                raise ValueError(
                    f"{name or 'ms model'} line {lineno}: %a section needs "
                    f"logAge=<v>, got {line!r}"
                )
            if cur_cell is None:
                raise ValueError(
                    f"{name or 'ms model'} line {lineno}: %a before any "
                    f"%f section"
                )
            cur_iso = cur_cell.setdefault(kv["logage"], [])
            continue
        if line.startswith("%"):
            raise ValueError(
                f"{name or 'ms model'} line {lineno}: unknown marker "
                f"{line.split()[0]!r} (expected %s/%f/%a)"
            )
        if cur_iso is None:
            raise ValueError(
                f"{name or 'ms model'} line {lineno}: data row before "
                f"%f/%a markers: {line!r}"
            )
        vals = line.split()
        if not bands:
            raise ValueError(
                f"{name or 'ms model'} line {lineno}: no %s filter line "
                f"before data rows"
            )
        if len(vals) != 2 + len(bands):
            raise ValueError(
                f"{name or 'ms model'} line {lineno}: row has {len(vals)} "
                f"fields, expected eep mass + {len(bands)} band mags"
            )
        try:
            cur_iso.append(
                (int(float(vals[0])), float(vals[1]),
                 np.array([float(v) for v in vals[2:]], np.float32))
            )
        except ValueError as e:
            raise ValueError(
                f"{name or 'ms model'} line {lineno}: non-numeric field "
                f"in data row {line!r} ({e})"
            ) from None

    if not cells:
        raise ValueError(
            f"{name or 'ms model'}: no isochrone sections found "
            f"(expected %f/%a markers)"
        )
    feh_axis = np.array(sorted({k[0] for k in cells}), np.float32)
    y_axis = np.array(sorted({k[1] for k in cells}), np.float32)
    ages = sorted({a for cell in cells.values() for a in cell})
    age_axis = np.array(ages, np.float32)
    return pack_eep_aligned(feh_axis, y_axis, age_axis, cells, bands, name,
                            device=device)


def pack_eep_aligned(
    feh_axis: np.ndarray,
    y_axis: np.ndarray,
    age_axis: np.ndarray,
    cells: dict,
    bands: Sequence[str],
    name: str = "",
    *,
    device: torch.device | str = "cpu",
) -> IsochroneGrid:
    """Pack {(feh,y): {age: [(eep, mass, mags)...]}} EEP-aligned.

    Slot index = eep - min(eep over the whole family); missing slots are
    masked invalid and padded with the nearest valid row's values (the
    pad values are never read through the validity mask, but keep
    `searchsorted` monotone for the mass->mags lookup).
    """
    all_eeps = [
        e
        for cell in cells.values()
        for rows in cell.values()
        for (e, _, _) in rows
    ]
    e0, e1 = min(all_eeps), max(all_eeps)
    F, Y, A, E, B = (
        len(feh_axis), len(y_axis), len(age_axis), e1 - e0 + 1, len(bands),
    )
    f_idx = {float(v): i for i, v in enumerate(feh_axis)}
    y_idx = {float(v): i for i, v in enumerate(y_axis)}
    a_idx = {float(v): i for i, v in enumerate(age_axis)}

    mass = np.zeros((F, Y, A, E), np.float32)
    mags = np.zeros((F, Y, A, E, B), np.float32)
    valid = np.zeros((F, Y, A, E), np.float32)
    agb_tip = np.zeros((F, Y, A), np.float32)
    for (feh, y), cell in cells.items():
        fi, yi = f_idx[float(np.float32(feh))], y_idx[float(np.float32(y))]
        for age, rows in cell.items():
            ai = a_idx[float(np.float32(age))]
            rows = sorted(rows)
            for eep, m, mg in rows:
                s = eep - e0
                mass[fi, yi, ai, s] = m
                mags[fi, yi, ai, s] = mg
                valid[fi, yi, ai, s] = 1.0
            agb_tip[fi, yi, ai] = max(m for (_, m, _) in rows)
            # Fill pad slots monotonically from the neighbouring valid rows.
            v = valid[fi, yi, ai] > 0.5
            idx = np.arange(E)
            nearest = np.interp(idx, idx[v], idx[v]).round().astype(int)
            mass[fi, yi, ai] = np.where(v, mass[fi, yi, ai],
                                        mass[fi, yi, ai][nearest])
            mags[fi, yi, ai] = np.where(v[:, None], mags[fi, yi, ai],
                                        mags[fi, yi, ai][nearest])
    return IsochroneGrid(
        feh=_t(feh_axis, device),
        y=_t(y_axis, device),
        age=_t(age_axis, device),
        mass=_t(mass, device),
        mags=_t(mags, device),
        valid=_t(valid, device),
        agb_tip=_t(agb_tip, device),
        bands=tuple(bands),
        name=name,
    )


def write_ms_model(path: str, grid: IsochroneGrid) -> None:
    """Write an IsochroneGrid in the MS text format (fixture/diff tool)."""
    mass = _np(grid.mass)
    mags = _np(grid.mags)
    valid = _np(grid.valid) > 0.5
    with open(path, "w") as f:
        f.write(f"# base-tpu MS model export: {grid.name}\n")
        f.write("%s " + " ".join(grid.bands) + "\n")
        for fi, feh in enumerate(_np(grid.feh)):
            for yi, y in enumerate(_np(grid.y)):
                f.write(f"%f [Fe/H]={feh:.6f} Y={y:.6f}\n")
                for ai, age in enumerate(_np(grid.age)):
                    f.write(f"%a logAge={age:.6f}\n")
                    for e in np.nonzero(valid[fi, yi, ai])[0]:
                        row = " ".join(
                            f"{v:.6f}" for v in mags[fi, yi, ai, e]
                        )
                        f.write(f"{e + 1} {mass[fi, yi, ai, e]:.6f} {row}\n")


# --------------------------------------------------------------------------
# WD cooling tracks
# --------------------------------------------------------------------------


def parse_wd_cooling(
    text: str, n_age: int = 64, name: str = "", *,
    device: torch.device | str = "cpu",
) -> wdc.WdCoolingGrid:
    """Parse WD cooling tracks; rectangularize onto a common log-age axis.

    Tracks are ragged in the file (each mass has its own age sampling, as
    in the upstream Wood/Montgomery tables [SURVEY.md C6]); each track is
    re-gridded host-side by monotone 1-D interpolation onto `n_age`
    uniform log-age nodes spanning the family's union range, clamped at
    track ends (the reference clamps cooling lookups to table edges too).
    """
    # carb -> mass -> list[(log_age, log_teff, log_radius)]
    tracks: dict[float, dict[float, list]] = {}
    cur_carb = None
    cur_track: list | None = None
    saw_carb = False
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        try:
            if line.startswith("%c"):
                cur_carb = float(line.split()[1])
                saw_carb = True
                cur_track = None
                continue
            if line.startswith("%m"):
                if cur_carb is None:
                    cur_carb = 0.5  # families without a carbonicity axis
                m = float(line.split()[1])
                cur_track = tracks.setdefault(cur_carb, {}).setdefault(m, [])
                continue
        except (IndexError, ValueError):
            raise ValueError(
                f"{name or 'wd cooling'} line {lineno}: marker needs one "
                f"numeric value, got {line!r}"
            ) from None
        if line.startswith("%"):
            raise ValueError(
                f"{name or 'wd cooling'} line {lineno}: unknown marker "
                f"{line.split()[0]!r} (expected %c/%m)"
            )
        if cur_track is None:
            raise ValueError(
                f"{name or 'wd cooling'} line {lineno}: data row before "
                f"%m marker: {line!r}"
            )
        try:
            vals = [float(v) for v in line.split()]
        except ValueError:
            raise ValueError(
                f"{name or 'wd cooling'} line {lineno}: non-numeric field "
                f"in row {line!r}"
            ) from None
        if len(vals) != 3:
            raise ValueError(
                f"{name or 'wd cooling'} line {lineno}: cooling row needs "
                f"logAge logTeff logRadius (3 fields), got {len(vals)}"
            )
        cur_track.append(tuple(vals))

    if not tracks:
        raise ValueError(
            f"{name or 'wd cooling'}: no cooling tracks found "
            f"(expected %m markers)"
        )
    carbs = sorted(tracks)
    mass_sets = [set(d) for d in tracks.values()]
    masses = sorted(set.intersection(*mass_sets))
    if not masses:
        raise ValueError("no common mass tracks across carbonicity sections")
    carb_axis = np.array(carbs, np.float32)
    mass_axis = np.array(masses, np.float32)
    lo = min(r[0] for d in tracks.values() for t in d.values() for r in t)
    hi = max(r[0] for d in tracks.values() for t in d.values() for r in t)
    age_axis = np.linspace(lo, hi, n_age).astype(np.float32)

    X, M, A = len(carb_axis), len(mass_axis), n_age
    log_teff = np.zeros((X, M, A), np.float32)
    log_radius = np.zeros((X, M, A), np.float32)
    for xi, c in enumerate(carbs):
        for mi, m in enumerate(masses):
            rows = sorted(tracks[c][m])
            a = np.array([r[0] for r in rows])
            te = np.array([r[1] for r in rows])
            ra = np.array([r[2] for r in rows])
            log_teff[xi, mi] = np.interp(age_axis, a, te)
            log_radius[xi, mi] = np.interp(age_axis, a, ra)
    if not saw_carb:
        carb_axis = carb_axis[:1]  # single degenerate plane
        log_teff, log_radius = log_teff[:1], log_radius[:1]
    return wdc.pack(carb_axis, mass_axis, age_axis, log_teff, log_radius,
                    name=name, device=device)


def write_wd_cooling(path: str, grid: wdc.WdCoolingGrid) -> None:
    carb = _np(grid.carb)
    log_teff, log_radius = _np(grid.log_teff), _np(grid.log_radius)
    with_carb = carb.shape[0] > 1
    with open(path, "w") as f:
        f.write(f"# base-tpu WD cooling export: {grid.name}\n")
        for xi, c in enumerate(carb):
            if with_carb:
                f.write(f"%c {c:.6f}\n")
            for mi, m in enumerate(_np(grid.mass)):
                f.write(f"%m {m:.6f}\n")
                for ai, a in enumerate(_np(grid.log_age)):
                    f.write(
                        f"{a:.6f} {log_teff[xi, mi, ai]:.6f}"
                        f" {log_radius[xi, mi, ai]:.6f}\n"
                    )


# --------------------------------------------------------------------------
# Bergeron atmosphere tables
# --------------------------------------------------------------------------


def _parse_bergeron_table(text: str, bands: Sequence[str]):
    """One Table_DA/Table_DB file -> (log_teff axis, log_g axis, mags)."""
    header: list[str] | None = None
    rows: list[list[float]] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        toks = line.replace("log g", "logg").split()
        if header is None:
            header = toks
            continue
        try:
            vals = [float(v) for v in toks]
        except ValueError:
            raise ValueError(
                f"Bergeron table line {lineno}: non-numeric field in data "
                f"row {line!r} (only one header line is allowed)"
            ) from None
        if len(vals) != len(header):
            raise ValueError(
                f"Bergeron table line {lineno}: row has {len(vals)} "
                f"fields, header declares {len(header)} columns"
            )
        rows.append(vals)
    if header is None or not rows:
        raise ValueError("empty Bergeron table (need a header + data rows)")
    cols = {c: i for i, c in enumerate(header)}
    if "Teff" not in cols or "logg" not in cols:
        raise ValueError(f"Bergeron header missing Teff/logg: {header}")
    missing = [b for b in bands if b not in cols]
    if missing:
        raise ValueError(f"Bergeron table missing bands {missing}")
    data = np.asarray(rows, np.float64)
    teff = np.unique(data[:, cols["Teff"]])
    logg = np.unique(data[:, cols["logg"]])
    T, G, B = len(teff), len(logg), len(bands)
    mags = np.full((T, G, B), np.nan, np.float32)
    ti = np.searchsorted(teff, data[:, cols["Teff"]])
    gi = np.searchsorted(logg, data[:, cols["logg"]])
    for bi, b in enumerate(bands):
        mags[ti, gi, bi] = data[:, cols[b]]
    if np.isnan(mags).any():
        # Rectangularize holes by nearest-Teff fill within each logg column.
        for g in range(G):
            col = mags[:, g, :]
            ok = ~np.isnan(col[:, 0])
            if not ok.any():
                raise ValueError(f"logg column {logg[g]} entirely missing")
            idx = np.arange(T)
            nearest = np.interp(idx, idx[ok], idx[ok]).round().astype(int)
            mags[:, g, :] = col[nearest]
    return np.log10(teff).astype(np.float32), logg.astype(np.float32), mags


def parse_bergeron(
    da_text: str, db_text: str, bands: Sequence[str], name: str = "bergeron",
    *, device: torch.device | str = "cpu",
) -> wda.WdAtmosphereGrid:
    """Combine DA + DB photometric tables into one WdAtmosphereGrid.

    The DB table is re-gridded onto the DA (log Teff, log g) axes by
    bilinear interpolation when the two lattices differ (the upstream DB
    grid is coarser [SURVEY.md C7])."""
    lt_a, lg_a, da = _parse_bergeron_table(da_text, bands)
    lt_b, lg_b, db = _parse_bergeron_table(db_text, bands)
    if lt_a.shape != lt_b.shape or not (
        np.allclose(lt_a, lt_b) and np.allclose(lg_a, lg_b)
    ):
        db = _regrid_bilinear(lt_b, lg_b, db, lt_a, lg_a)
    return wda.WdAtmosphereGrid(
        log_teff=_t(lt_a, device),
        log_g=_t(lg_a, device),
        mags=_t(np.stack([da, db], axis=0), device),
        bands=tuple(bands),
        name=name,
    )


def _regrid_bilinear(x, y, table, xq, yq):
    """np bilinear re-grid of table [X, Y, B] onto (xq, yq), edge-clamped."""
    out = np.empty((len(xq), len(yq), table.shape[-1]), np.float32)
    tmp = np.empty((len(xq), len(y), table.shape[-1]), np.float32)
    for j in range(len(y)):
        for b in range(table.shape[-1]):
            tmp[:, j, b] = np.interp(xq, x, table[:, j, b])
    for i in range(len(xq)):
        for b in range(table.shape[-1]):
            out[i, :, b] = np.interp(yq, y, tmp[i, :, b])
    return out


def write_bergeron_table(
    path: str, grid: wda.WdAtmosphereGrid, wd_type: int
) -> None:
    mags = _np(grid.mags[wd_type])
    with open(path, "w") as f:
        f.write("Teff logg " + " ".join(grid.bands) + "\n")
        for ti, lt in enumerate(_np(grid.log_teff)):
            for gi, lg in enumerate(_np(grid.log_g)):
                row = " ".join(f"{v:.5f}" for v in mags[ti, gi])
                f.write(f"{10.0 ** lt:.1f} {lg:.3f} {row}\n")


# --------------------------------------------------------------------------
# Directory conversion (the `convert-models` CLI)
# --------------------------------------------------------------------------

MS_EXTS = (".ms", ".iso", ".model")
WD_EXTS = (".wd", ".cool")


def convert_model_directory(
    src: str, dst: str, bands: Sequence[str] | None = None
) -> list[str]:
    """Convert a directory of upstream-format text grids into the packed
    `.npz` containers `grids/load.py` reads.

    Recognized inputs (by extension / filename):
      * `<family>.ms|.iso|.model`     MS/RGB unified isochrone file
      * `<family>.wd|.cool`           WD cooling tracks
      * `Table_DA` + `Table_DB`       Bergeron atmosphere pair
    Returns the list of npz files written.
    """
    from base_tpu_torch.grids.load import save_packed_isochrones

    os.makedirs(dst, exist_ok=True)
    written: list[str] = []
    da_path = db_path = None
    for fn in sorted(os.listdir(src)):
        p = os.path.join(src, fn)
        stem, ext = os.path.splitext(fn)
        if fn in ("Table_DA", "Table_DB") or stem in ("Table_DA", "Table_DB"):
            if "DA" in fn:
                da_path = p
            else:
                db_path = p
            continue
        if ext in MS_EXTS:
            grid = parse_ms_model(open(p).read(), name=stem)
            out = os.path.join(dst, f"{stem}.npz")
            save_packed_isochrones(out, grid)
            written.append(out)
        elif ext in WD_EXTS:
            grid = parse_wd_cooling(open(p).read(), name=stem)
            out = os.path.join(dst, f"wd_{stem}.npz")
            np.savez_compressed(
                out,
                carb=_np(grid.carb),
                mass=_np(grid.mass),
                log_age=_np(grid.log_age),
                log_teff=_np(grid.log_teff),
                log_radius=_np(grid.log_radius),
            )
            written.append(out)
    if da_path and db_path:
        if bands is None:
            # Band set = header ∩ known filters, DA file order.
            hdr = None
            for raw in open(da_path):
                line = raw.strip()
                if line and not line.startswith("#"):
                    hdr = line.replace("log g", "logg").split()
                    break
            bands = [c for c in (hdr or []) if c in FILTERS]
        grid = parse_bergeron(open(da_path).read(), open(db_path).read(),
                              bands)
        out = os.path.join(dst, "bergeron.npz")
        np.savez_compressed(
            out,
            log_teff=_np(grid.log_teff),
            log_g=_np(grid.log_g),
            mags=_np(grid.mags),
            bands=np.asarray(grid.bands),
        )
        written.append(out)
    return written
