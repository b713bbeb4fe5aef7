"""Write tests/data/smc_stars.npz: BASELINE config 5's catalog as base_tpu's
own SMC recipe makes it (benchmarks/smc_10k_tpu.py:48-56), at a star
count small enough for that recipe to run on a CPU.

The recipe: the synthetic grid at n_eep 64; simulate_cluster at the truth
with PRNGKey(0), every star a binary (percent_binary 1.0), min_mass 0.15;
scatter_cluster with PRNGKey(1), limit_mag 24, no censoring.  Magnitudes
and sigmas are stored as float32, exactly as base_tpu hands them to
make_ms_stars (cm_prior 0.99), beside the truth, the keys, the star count
and the band names.  A machine without JAX (the card's) reads the catalog
from this file: scripts/torch_smc_parity.py runs the port's copy of the
recipe on it, and base_tpu's script, run with SMC10K_STARS set to the same
count, simulates the same stars.  Runs under JAX on the CPU, from the
repository root (~10 s):

    python scripts/smc_stars_from_jax.py [--stars S] [--out PATH]
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

OUT = os.path.join(ROOT, "tests", "data", "smc_stars.npz")
# benchmarks/smc_10k_tpu.py's constants.
TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
N_EEP, KEYS, LIMIT, CM_PRIOR = 64, (0, 1), 24.0, np.float32(0.99)
# The star count: the most at which base_tpu's script, at upsample 1 and
# scripts/torch_smc_parity.py's replicates and particles, finishes on an
# 8-core CPU in about 15 minutes.
N_STARS = 3500


def catalog(n_stars: int):
    """(mags, sigmas) [n_stars, 8] float32 of smc_10k_tpu.py's recipe."""
    grid = synthetic.make_grid(n_eep=N_EEP)
    cat = simulate_cluster(grid, jnp.asarray(TRUTH), n_stars,
                           jax.random.PRNGKey(KEYS[0]), percent_binary=1.0,
                           min_mass=0.15)
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(KEYS[1]),
                         limit_mag=LIMIT, censor=False)
    return (np.asarray(sc.mags, np.float32),
            np.asarray(sc.sigmas, np.float32), grid.bands)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stars", type=int, default=N_STARS)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    mags, sigmas, bands = catalog(args.stars)
    np.savez_compressed(
        args.out,
        source=np.array(
            "benchmarks/smc_10k_tpu.py:48-56: synthetic.make_grid(n_eep=64); "
            "simulate_cluster PRNGKey(0), percent_binary 1.0, min_mass "
            "0.15; scatter_cluster PRNGKey(1), limit_mag 24, censor False"),
        bands=np.array(list(bands)), n_eep=np.int64(N_EEP),
        n_stars=np.int64(args.stars), truth=TRUTH, keys=np.array(KEYS),
        cm_prior=CM_PRIOR, mags=mags, sigmas=sigmas)
    print(f"wrote {args.out}: {mags.shape}, "
          f"{int((sigmas <= 0).sum())} unobserved bands")


if __name__ == "__main__":
    main()
