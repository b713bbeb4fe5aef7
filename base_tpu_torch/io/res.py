"""Chain-output (`.res`) writers/readers, reference-compatible.

The port's copy of base_tpu.io.res (numpy only): callers pass numpy
arrays, so its files equal base_tpu's byte for byte.

The reference appends one whitespace-separated row per recorded sample:
logAge Y FeH modulus absorption [carbonicity ifmr...] logPost stage
[upstream: base9/IO/ main-chain BackingStore — SURVEY.md C14].  We write
the same layout (multi-chain runs interleave chains, with an extra
`chain` column when n_chains > 1) so reference-side analysis scripts
keep working, and provide a numpy reader for round-trips and the
sampleMass-style post-processors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from base_tpu_torch import constants as C

RES_COLUMNS = (
    "logAge", "Y", "FeH", "modulus", "absorption", "carbonicity",
    "ifmrIntercept", "ifmrSlope", "ifmrQuadCoef",
)


@dataclasses.dataclass
class ResTable:
    params: np.ndarray   # [N, 9] (or [N, C, 9] before flattening)
    logpost: np.ndarray  # [N]
    stage: np.ndarray    # [N] int (burn-in stage / main = 3)
    chain: np.ndarray | None = None  # [N] chain index for multi-chain


def write_res(
    path: str,
    samples: np.ndarray,          # [N, 9] or [N, Chains, 9]
    logpost: np.ndarray,          # [N] or [N, Chains]
    stage: int | np.ndarray = 3,
    include_ifmr: bool = True,
) -> None:
    samples = np.asarray(samples)
    logpost = np.asarray(logpost)
    multi = samples.ndim == 3
    n_par = 9 if include_ifmr else 6
    cols = list(RES_COLUMNS[:n_par]) + ["logPost", "stage"]
    if multi:
        cols.append("chain")
    with open(path, "w") as f:
        f.write(" ".join(cols) + "\n")
        if multi:
            N, Ch, _ = samples.shape
            st = np.broadcast_to(np.asarray(stage), (N,))
            for n in range(N):
                for c in range(Ch):
                    row = [f"{v:.6f}" for v in samples[n, c, :n_par]]
                    row += [f"{logpost[n, c]:.4f}", str(int(st[n])), str(c)]
                    f.write(" ".join(row) + "\n")
        else:
            N = samples.shape[0]
            st = np.broadcast_to(np.asarray(stage), (N,))
            for n in range(N):
                row = [f"{v:.6f}" for v in samples[n, :n_par]]
                row += [f"{logpost[n]:.4f}", str(int(st[n]))]
                f.write(" ".join(row) + "\n")


def read_res(path: str) -> ResTable:
    with open(path) as f:
        header = f.readline().split()
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    col = {c: i for i, c in enumerate(header)}
    n_par = 9 if "ifmrIntercept" in col else 6
    params = np.zeros((data.shape[0], C.NPARAMS), np.float32)
    for i, name in enumerate(RES_COLUMNS[:n_par]):
        params[:, i] = data[:, col[name]]
    return ResTable(
        params=params,
        logpost=data[:, col["logPost"]].astype(np.float32),
        stage=data[:, col["stage"]].astype(np.int32),
        chain=(
            data[:, col["chain"]].astype(np.int32) if "chain" in col else None
        ),
    )
