"""Reference-compatible `.phot` photometry file reader/writer.

The port's copy of base_tpu.io.phot (numpy only): callers pass numpy
arrays, so its files equal base_tpu's byte for byte.

Format per the reference IO layer [upstream: base9/IO/ phot reader —
SURVEY.md C14]: whitespace-separated text; header row names the columns;
per star: id, one magnitude column per filter, one sigma column per
filter (named `sig<Filter>`), then mass1, massRatio, stage, CMprior,
useDBI.  sigma < 0 marks a band unobserved.  Stage uses the reference
status codes (MSRG=1, WD=3, ... — constants.StarStatus).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from base_tpu_torch import constants as C


@dataclasses.dataclass
class PhotTable:
    """Host-side photometry table (numpy only)."""

    ids: list[str]
    bands: tuple[str, ...]
    mags: np.ndarray        # [S, B]
    sigmas: np.ndarray      # [S, B]; <= 0 unobserved
    mass1: np.ndarray       # [S] initial guess primary mass
    mass_ratio: np.ndarray  # [S]
    stage: np.ndarray       # [S] int status codes
    cm_prior: np.ndarray    # [S] cluster-membership prior
    use_dbi: np.ndarray     # [S] int: use during burn-in

    @property
    def n_stars(self) -> int:
        return self.mags.shape[0]

    def select(self, mask: np.ndarray) -> "PhotTable":
        """Row subset (e.g. by stage)."""
        idx = np.flatnonzero(mask)
        return PhotTable(
            ids=[self.ids[i] for i in idx],
            bands=self.bands,
            mags=self.mags[idx],
            sigmas=self.sigmas[idx],
            mass1=self.mass1[idx],
            mass_ratio=self.mass_ratio[idx],
            stage=self.stage[idx],
            cm_prior=self.cm_prior[idx],
            use_dbi=self.use_dbi[idx],
        )

    def select_bands(self, band_idx: np.ndarray, bands) -> "PhotTable":
        """Column subset: keep the bands at `band_idx` (the phot side of
        the dynamic filter-set intersection, SURVEY.md C13)."""
        return dataclasses.replace(
            self,
            bands=tuple(bands),
            mags=self.mags[:, band_idx],
            sigmas=self.sigmas[:, band_idx],
        )


TRAILING = ("mass1", "massRatio", "stage", "Cmprior", "useDBI")


def read_phot(path: str) -> PhotTable:
    """Parse a .phot file.  Band set = columns between `id` and the sigma
    block; tolerant of the id header being present or absent."""
    with open(path) as f:
        header = f.readline().split()
        rows = [line.split() for line in f if line.strip()]

    cols = list(header)
    if cols and cols[0] in ("id", "starId", "star"):
        cols = cols[1:]
    # Band columns run until the first sig* column.
    bands = []
    for c in cols:
        if c.startswith("sig"):
            break
        bands.append(c)
    n_b = len(bands)
    expect_sig = [f"sig{b}" for b in bands]
    got_sig = cols[n_b : 2 * n_b]
    if got_sig != expect_sig:
        raise ValueError(f"sigma columns {got_sig} != expected {expect_sig}")
    tail = cols[2 * n_b :]
    if tuple(tail[: len(TRAILING)]) != TRAILING:
        raise ValueError(f"trailing columns {tail} != {TRAILING}")

    n_cols_data = len(cols)
    has_id = all(len(r) == n_cols_data + 1 for r in rows)
    ids, data = [], []
    for i, r in enumerate(rows):
        if has_id:
            ids.append(r[0])
            data.append([float(x) for x in r[1:]])
        else:
            ids.append(str(i))
            data.append([float(x) for x in r])
    arr = np.asarray(data, np.float64)
    return PhotTable(
        ids=ids,
        bands=tuple(bands),
        mags=arr[:, :n_b].astype(np.float32),
        sigmas=arr[:, n_b : 2 * n_b].astype(np.float32),
        mass1=arr[:, 2 * n_b].astype(np.float32),
        mass_ratio=arr[:, 2 * n_b + 1].astype(np.float32),
        stage=arr[:, 2 * n_b + 2].astype(np.int32),
        cm_prior=arr[:, 2 * n_b + 3].astype(np.float32),
        use_dbi=arr[:, 2 * n_b + 4].astype(np.int32),
    )


def write_phot(path: str, table: PhotTable) -> None:
    """Write a sampler-ready .phot file in the reference layout."""
    bands = table.bands
    header = (
        ["id"]
        + list(bands)
        + [f"sig{b}" for b in bands]
        + list(TRAILING)
    )
    with open(path, "w") as f:
        f.write(" ".join(header) + "\n")
        for i in range(table.n_stars):
            row = [table.ids[i]]
            row += [f"{v:.6f}" for v in table.mags[i]]
            row += [f"{v:.6f}" for v in table.sigmas[i]]
            row += [
                f"{table.mass1[i]:.6f}",
                f"{table.mass_ratio[i]:.6f}",
                str(int(table.stage[i])),
                f"{table.cm_prior[i]:.6f}",
                str(int(table.use_dbi[i])),
            ]
            f.write(" ".join(row) + "\n")


def from_simulation(
    ids: Sequence[str] | None,
    bands: Sequence[str],
    mags: np.ndarray,
    sigmas: np.ndarray,
    mass1: np.ndarray | None = None,
    mass_ratio: np.ndarray | None = None,
    stage: np.ndarray | None = None,
    cm_prior: float | np.ndarray = 0.999,
    use_dbi: int | np.ndarray = 1,
) -> PhotTable:
    """Assemble a PhotTable from simulator outputs with defaults."""
    S = mags.shape[0]
    return PhotTable(
        ids=list(ids) if ids is not None else [str(i) for i in range(S)],
        bands=tuple(bands),
        mags=np.asarray(mags, np.float32),
        sigmas=np.asarray(sigmas, np.float32),
        mass1=np.asarray(
            mass1 if mass1 is not None else np.ones(S), np.float32
        ),
        mass_ratio=np.asarray(
            mass_ratio if mass_ratio is not None else np.zeros(S), np.float32
        ),
        stage=np.asarray(
            stage if stage is not None else np.full(S, C.StarStatus.MSRG),
            np.int32,
        ),
        cm_prior=np.broadcast_to(
            np.asarray(cm_prior, np.float32), (S,)
        ).copy(),
        use_dbi=np.broadcast_to(np.asarray(use_dbi, np.int32), (S,)).copy(),
    )
