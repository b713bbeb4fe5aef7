"""Write tests/data/sbc_stars.npz: the 64 simulated data sets of
tests/test_calibration.py's three simulation-based calibration (SBC) tests,
as base_tpu makes them from JAX's threefry streams.

Two collections, each with its truths (`_draw_truths(default_rng(7))`):

- `ms_*`: `_make_batched_stars` (64 x 32 stars, 8 bands), shared by the
  adaptive-MH and the HMC test: simulate_cluster at PRNGKey(100 + r) with
  no binaries and min_mass 0.15, scatter_cluster at PRNGKey(200 + r) with
  limit_mag 33;
- `bin_*`: the binaries test's own draw (64 x 20 stars): a segment of the
  truth's binaries segment table (n_q 8) by categorical over its prior
  weights at PRNGKey(300 + r), a uniform point along it, then
  scatter_cluster at PRNGKey(400 + r) with limit_mag 33.

Magnitudes and sigmas are stored as float32, exactly as base_tpu hands
them to make_ms_stars, beside the truths, the keys and the band names.  A
machine without JAX (the card's) reads the data sets from this file.  The
builders below repeat tests/test_calibration.py's code, with base_tpu's
functions; that file stays as it is.  Runs under JAX on the CPU, from the
repository root (~1-2 min):

    python scripts/sbc_stars_from_jax.py [--out PATH]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from base_tpu.grids import filters as filt  # noqa: E402
from base_tpu.grids import synthetic  # noqa: E402
from base_tpu.grids.isochrone import derive_isochrone  # noqa: E402
from base_tpu.model import likelihood as lk  # noqa: E402
from base_tpu.sim.scatter import scatter_cluster  # noqa: E402
from base_tpu.sim.simulate import simulate_cluster  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "sbc_stars.npz")
# tests/test_calibration.py's constants.
R = 64
N_STARS, N_STARS_BIN, N_Q_BIN = 32, 20, 8
BASE = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
PRIOR_SIGMA = np.array([0.12, -1, 0.22, 0.25, 0.08, -1, -1, -1, -1],
                       np.float32)
CHECK = (0, 2, 3, 4)      # age, FeH, modulus, A_V (constants.Param)
TRUTH_SEED = 7
MS_SIM_KEY0, MS_SCATTER_KEY0 = 100, 200
BIN_DRAW_KEY0, BIN_SCATTER_KEY0 = 300, 400
LIMIT_MAG = 33.0


def small_grid():
    """tests/conftest.py's small_grid."""
    return synthetic.make_grid(
        feh_axis=np.linspace(-1.5, 0.3, 4),
        y_axis=np.linspace(0.24, 0.31, 3),
        age_axis=np.linspace(8.6, 10.1, 6),
        n_eep=48,
    )


def draw_truths(rng):
    """tests/test_calibration.py `_draw_truths`."""
    truths = np.tile(BASE, (R, 1))
    for p in CHECK:
        z = np.clip(rng.standard_normal(R), -2.5, 2.5)
        truths[:, p] += PRIOR_SIGMA[p] * z
    return truths


def ms_catalog(grid, truth, r: int):
    """Replica r of `_make_batched_stars`: (mags, sigmas) [32, B]."""
    cat = simulate_cluster(grid, jnp.asarray(truth), N_STARS,
                           jax.random.PRNGKey(MS_SIM_KEY0 + r),
                           percent_binary=0.0, min_mass=0.15)
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(MS_SCATTER_KEY0 + r),
                         limit_mag=LIMIT_MAG)
    return np.asarray(sc.mags, np.float32), np.asarray(sc.sigmas, np.float32)


def bin_catalog(grid, truth, r: int):
    """Replica r of the binaries test's `draw_from_density` then
    scatter_cluster: (mags, sigmas) [20, B]."""
    q_grid = jnp.linspace(0.0, 1.0, N_Q_BIN, dtype=jnp.float32)
    abs_coefs = jnp.asarray(filt.absorption_coefs(grid.bands))
    iso = derive_isochrone(grid, truth[2], truth[1], truth[0])
    table = lk.build_segment_table(iso, q_grid, truth[3], truth[4],
                                   abs_coefs, binaries=True)
    logits = jnp.where(table.mask, table.logw, -jnp.inf)
    k_seg, k_t = jax.random.split(jax.random.PRNGKey(BIN_DRAW_KEY0 + r))
    seg = jax.random.categorical(k_seg, logits, shape=(N_STARS_BIN,))
    t = jax.random.uniform(k_t, (N_STARS_BIN,))
    mags = (1.0 - t)[:, None] * table.lo[seg] + t[:, None] * table.hi[seg]
    sc = scatter_cluster(mags, jax.random.PRNGKey(BIN_SCATTER_KEY0 + r),
                         limit_mag=LIMIT_MAG)
    return np.asarray(sc.mags, np.float32), np.asarray(sc.sigmas, np.float32)


def collection(builder, grid, truths, replicas):
    """(mags, sigmas) [len(replicas), S, B] of `builder` over replicas."""
    pairs = [builder(grid, truths[r], r) for r in replicas]
    return (np.stack([m for m, _ in pairs]),
            np.stack([s for _, s in pairs]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    grid = small_grid()
    truths = draw_truths(np.random.default_rng(TRUTH_SEED))
    ms_mags, ms_sigmas = collection(ms_catalog, grid, truths, range(R))
    bin_mags, bin_sigmas = collection(bin_catalog, grid, truths, range(R))
    np.savez_compressed(
        args.out,
        source=np.array("tests/test_calibration.py: _draw_truths("
                        "default_rng(7)); ms: _make_batched_stars "
                        "(simulate_cluster PRNGKey(100 + r), percent_binary "
                        "0, min_mass 0.15; scatter_cluster PRNGKey(200 + r), "
                        "limit_mag 33); bin: draw_from_density (n_q 8, "
                        "PRNGKey(300 + r)), scatter_cluster PRNGKey(400 + r),"
                        " limit_mag 33"),
        bands=np.array(list(grid.bands)),
        truths=truths,
        truth_seed=np.int64(TRUTH_SEED),
        ms_keys=np.array([MS_SIM_KEY0, MS_SCATTER_KEY0]),
        bin_keys=np.array([BIN_DRAW_KEY0, BIN_SCATTER_KEY0]),
        ms_mags=ms_mags, ms_sigmas=ms_sigmas,
        bin_mags=bin_mags, bin_sigmas=bin_sigmas,
    )
    print(f"wrote {args.out}: ms {ms_mags.shape}, bin {bin_mags.shape}, "
          f"{int((ms_sigmas <= 0).sum() + (bin_sigmas <= 0).sum())} "
          f"unobserved bands")


if __name__ == "__main__":
    main()
