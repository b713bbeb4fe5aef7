"""SQLite backing store for chain output.

The port's copy of base_tpu.io.sqlite_store (numpy only): callers pass numpy
arrays, so its files equal base_tpu's byte for byte.

The reference's recent IO layer added an SQLite BackingStore alongside
the plain-text writers [upstream: base9/IO/ — SURVEY.md C14]; this is
the equivalent: the same records as the `.res` writer, one row per
(iteration, chain), in a `samples` table plus a `meta` key/value table,
so downstream analysis can query with SQL instead of parsing text.
"""
from __future__ import annotations

import sqlite3

import numpy as np

from base_tpu_torch.io.res import RES_COLUMNS

_SCHEMA = """
CREATE TABLE IF NOT EXISTS samples (
    iter INTEGER NOT NULL,
    chain INTEGER NOT NULL,
    {cols},
    logPost REAL NOT NULL,
    stage INTEGER NOT NULL,
    PRIMARY KEY (iter, chain)
);
CREATE TABLE IF NOT EXISTS meta (
    key TEXT PRIMARY KEY,
    value TEXT
);
"""


def write_res_sqlite(
    path: str,
    samples: np.ndarray,          # [N, P] or [N, C, P]
    logpost: np.ndarray,          # [N] or [N, C]
    stage: int = 3,
    meta: dict | None = None,
    columns: tuple | None = None,  # param names; default RES_COLUMNS[:P]
) -> None:
    samples = np.asarray(samples, np.float64)
    logpost = np.asarray(logpost, np.float64)
    if samples.ndim == 2:
        samples = samples[:, None, :]
        logpost = logpost[:, None]
    N, C, P = samples.shape
    names = tuple(columns) if columns is not None else RES_COLUMNS[:P]
    if len(names) != P:
        raise ValueError(f"{P} params but {len(names)} column names")
    cols = ", ".join(f'"{c}" REAL NOT NULL' for c in names)
    con = sqlite3.connect(path)
    try:
        con.executescript(_SCHEMA.format(cols=cols))
        rows = (
            (n, c, *samples[n, c].tolist(), float(logpost[n, c]), stage)
            for n in range(N)
            for c in range(C)
        )
        placeholders = ", ".join("?" * (P + 4))
        con.executemany(
            f"INSERT OR REPLACE INTO samples VALUES ({placeholders})", rows
        )
        for k, v in (meta or {}).items():
            con.execute(
                "INSERT OR REPLACE INTO meta VALUES (?, ?)", (k, str(v))
            )
        con.commit()
    finally:
        con.close()


def read_res_sqlite(path: str):
    """Returns (params [N*C, 9], logpost [N*C], chain [N*C], meta dict)."""
    con = sqlite3.connect(path)
    try:
        cur = con.execute("SELECT * FROM samples ORDER BY iter, chain")
        names = [d[0] for d in cur.description]
        data = np.asarray(cur.fetchall(), np.float64)
        meta = dict(con.execute("SELECT key, value FROM meta").fetchall())
    finally:
        con.close()
    n_par = len(names) - 4  # iter, chain, ..., logPost, stage
    params = np.zeros((data.shape[0], max(n_par, 9)), np.float32)
    params[:, :n_par] = data[:, 2 : 2 + n_par]
    return (
        params,
        data[:, 2 + n_par].astype(np.float32),
        data[:, 1].astype(np.int32),
        meta,
    )
