"""Per-star sample-file writer for the post-processing tools.

The port's copy of base_tpu.io.samples (numpy only): callers pass numpy
arrays, so its files equal base_tpu's byte for byte.

Reference-shaped layout [upstream: sampleMass/ and sampleWDMass/ output
files — SURVEY.md E5, E6]: one row per posterior draw; per-star column
groups named `<field>_<starId>` in the header, so downstream tooling can
pick out a star by id.  Plain whitespace-separated text like every other
reference output.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np


def write_star_samples(
    path: str,
    ids: Sequence[str],
    columns: Mapping[str, np.ndarray],
    fmt: str = "%.6f",
) -> None:
    """Write per-(draw, star) sample columns.

    columns: field name -> [D, S] array; the header interleaves fields
    per star (`mass_1 massRatio_1 mass_2 massRatio_2 ...`) matching the
    reference's star-major grouping.
    """
    fields = list(columns.keys())
    arrays = [np.asarray(columns[f]) for f in fields]
    D, S = arrays[0].shape
    if len(ids) != S:
        raise ValueError(f"{len(ids)} ids for {S} star columns")
    for f, a in zip(fields, arrays):
        if a.shape != (D, S):
            raise ValueError(f"column {f} has shape {a.shape}, want {(D, S)}")

    header = " ".join(
        f"{f}_{ids[s]}" for s in range(S) for f in fields
    )
    # Interleave to [D, S * F] star-major.
    out = np.stack(arrays, axis=-1).reshape(D, S * len(fields))
    np.savetxt(path, out, fmt=fmt, header=header, comments="")


def read_star_samples(path: str) -> tuple[list[str], dict[str, np.ndarray]]:
    """Inverse of write_star_samples: returns (ids, field -> [D, S])."""
    with open(path) as f:
        names = f.readline().split()
    data = np.loadtxt(path, skiprows=1, ndmin=2)
    fields: list[str] = []
    ids: list[str] = []
    for n in names:
        f_, i_ = n.rsplit("_", 1)
        if f_ not in fields:
            fields.append(f_)
        if i_ not in ids:
            ids.append(i_)
    F, S = len(fields), len(ids)
    cube = data.reshape(data.shape[0], S, F)
    return ids, {f: cube[:, :, k] for k, f in enumerate(fields)}
