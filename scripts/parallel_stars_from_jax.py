"""Write tests/data/parallel_cluster_stars.npz: the catalog of the parallel
layer's CPU tests (tests/test_torch_parallel.py's `spawn_world`, the
`cluster_model` recipe of tests/test_parallel.py), as base_tpu makes it
from JAX's threefry streams: 50 stars at the truth, no binaries
(simulate_cluster at PRNGKey(21)), then scatter_cluster at PRNGKey(22)
with limit_mag 24.

Magnitudes and sigmas are stored as float32, exactly as base_tpu hands
them to make_ms_stars, beside the truth, the keys and the band names, so
that a test's spawned world can start on them without waiting for JAX;
tests/test_torch_parallel.py holds the file to base_tpu's builder bit for
bit on every run of its density world.  Runs under JAX on the CPU, from
the repository root (~10 s):

    python scripts/parallel_stars_from_jax.py [--out PATH]
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

from base_tpu.grids import synthetic  # noqa: E402
from base_tpu.sim.scatter import scatter_cluster  # noqa: E402
from base_tpu.sim.simulate import simulate_cluster  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "parallel_cluster_stars.npz")
TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.0, 0.0, 0.0], np.float32)
N_STARS, KEYS, LIMIT = 50, (21, 22), 24.0


def catalog(grid):
    """(mags, sigmas) [50, B] float32 of the recipe on `grid`
    (tests/conftest.py's small grid)."""
    cat = simulate_cluster(grid, jnp.asarray(TRUTH), N_STARS,
                           jax.random.PRNGKey(KEYS[0]), percent_binary=0.0)
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(KEYS[1]),
                         limit_mag=LIMIT)
    return np.asarray(sc.mags, np.float32), np.asarray(sc.sigmas, np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    grid = synthetic.make_grid(feh_axis=np.linspace(-1.5, 0.3, 4),
                               y_axis=np.linspace(0.24, 0.31, 3),
                               age_axis=np.linspace(8.6, 10.1, 6), n_eep=48)
    mags, sigmas = catalog(grid)
    np.savez_compressed(
        args.out,
        source=np.array("tests/test_torch_parallel.py spawn_world: "
                        "simulate_cluster PRNGKey(21), 50 stars, "
                        "percent_binary 0; scatter_cluster PRNGKey(22), "
                        "limit_mag 24"),
        bands=np.array(list(grid.bands)), truth=TRUTH, keys=np.array(KEYS),
        mags=mags, sigmas=sigmas)
    print(f"wrote {args.out}: {mags.shape}")


if __name__ == "__main__":
    main()
