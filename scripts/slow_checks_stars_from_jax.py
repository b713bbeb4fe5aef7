"""Write tests/data/slow_checks_stars.npz: the catalogs of base_tpu's last
two slow checks, as base_tpu makes them from JAX's threefry streams.

- `mp_*`: tests/test_multipop.py's `two_pop_data` (the two-population
  HMC recovery, `test_multipop_hmc_ordered_recovery`): 80 stars, the
  first 48 simulated at Y_A = 0.25 (PRNGKey(51)), the other 32 at Y_B =
  0.31 (PRNGKey(52)), no binaries, then scatter_cluster at PRNGKey(53)
  with limit_mag 26;
- `vi_*`: tests/test_vi.py's `test_vi_on_cluster_posterior`: 48 stars at
  its truth (PRNGKey(61)), no binaries, scatter_cluster at PRNGKey(62)
  with limit_mag 24.

Magnitudes, sigmas and cm_prior (0.999, the stars' cluster-membership
prior) are stored as float32, exactly as base_tpu hands them to
make_ms_stars, beside the truths, the keys, the band names and
tests/conftest.py's small grid's axes.  A machine without JAX (the
card's) reads the catalogs from this file.  The builders below repeat
those tests' code with base_tpu's functions; the tests stay as they are.
Runs under JAX on the CPU, from the repository root (~10 s):

    python scripts/slow_checks_stars_from_jax.py [--out PATH]
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

from base_tpu import constants as C  # noqa: E402
from base_tpu.grids import synthetic  # noqa: E402
from base_tpu.sim.scatter import scatter_cluster  # noqa: E402
from base_tpu.sim.simulate import simulate_cluster  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "slow_checks_stars.npz")
# tests/conftest.py's small_grid.
GRID_AXES = dict(feh_axis=np.linspace(-1.5, 0.3, 4),
                 y_axis=np.linspace(0.24, 0.31, 3),
                 age_axis=np.linspace(8.6, 10.1, 6), n_eep=48)
CM_PRIOR = np.float32(0.999)
# tests/test_multipop.py: age, Y (unused), FeH, mod, Av, carb, ifmr...,
# Y_A, Y_B, lambda.
MP_TRUTH = np.array([9.2, 0.27, -0.7, 11.0, 0.2, 0.5, 0, 0, 0, 0.25, 0.31,
                     0.6], np.float32)
MP_N, MP_KEYS, MP_LIMIT = 80, (51, 52, 53), 26.0
# tests/test_vi.py.
VI_TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
VI_N, VI_KEYS, VI_LIMIT = 48, (61, 62), 24.0


def small_grid():
    return synthetic.make_grid(**GRID_AXES)


def mp_catalog(grid):
    """`two_pop_data`'s photometry: (mags, sigmas) [80, B] float32."""
    n_a = int(round(MP_TRUTH[11] * MP_N))
    pa = MP_TRUTH[:9].copy()
    pa[C.Param.YYY] = MP_TRUTH[9]
    pb = MP_TRUTH[:9].copy()
    pb[C.Param.YYY] = MP_TRUTH[10]
    cat_a = simulate_cluster(grid, jnp.asarray(pa), n_a,
                             jax.random.PRNGKey(MP_KEYS[0]),
                             percent_binary=0.0)
    cat_b = simulate_cluster(grid, jnp.asarray(pb), MP_N - n_a,
                             jax.random.PRNGKey(MP_KEYS[1]),
                             percent_binary=0.0)
    mags = np.concatenate([np.asarray(cat_a.mags), np.asarray(cat_b.mags)])
    sc = scatter_cluster(jnp.asarray(mags), jax.random.PRNGKey(MP_KEYS[2]),
                         limit_mag=MP_LIMIT)
    return np.asarray(sc.mags, np.float32), np.asarray(sc.sigmas, np.float32)


def vi_catalog(grid):
    """`test_vi_on_cluster_posterior`'s photometry: (mags, sigmas) [48, B]
    float32."""
    cat = simulate_cluster(grid, jnp.asarray(VI_TRUTH), VI_N,
                           jax.random.PRNGKey(VI_KEYS[0]),
                           percent_binary=0.0)
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(VI_KEYS[1]),
                         limit_mag=VI_LIMIT)
    return np.asarray(sc.mags, np.float32), np.asarray(sc.sigmas, np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    grid = small_grid()
    mp_mags, mp_sigmas = mp_catalog(grid)
    vi_mags, vi_sigmas = vi_catalog(grid)
    np.savez_compressed(
        args.out,
        source=np.array(
            "mp: tests/test_multipop.py two_pop_data (simulate_cluster "
            "PRNGKey(51) 48 stars at Y_A, PRNGKey(52) 32 at Y_B, "
            "percent_binary 0; scatter_cluster PRNGKey(53), limit_mag 26); "
            "vi: tests/test_vi.py test_vi_on_cluster_posterior "
            "(simulate_cluster PRNGKey(61) 48 stars, percent_binary 0; "
            "scatter_cluster PRNGKey(62), limit_mag 24)"),
        bands=np.array(list(grid.bands)),
        feh_axis=GRID_AXES["feh_axis"], y_axis=GRID_AXES["y_axis"],
        age_axis=GRID_AXES["age_axis"], n_eep=np.int64(GRID_AXES["n_eep"]),
        cm_prior=CM_PRIOR,
        mp_truth=MP_TRUTH, mp_keys=np.array(MP_KEYS),
        mp_mags=mp_mags, mp_sigmas=mp_sigmas,
        vi_truth=VI_TRUTH, vi_keys=np.array(VI_KEYS),
        vi_mags=vi_mags, vi_sigmas=vi_sigmas,
    )
    print(f"wrote {args.out}: mp {mp_mags.shape}, vi {vi_mags.shape}, "
          f"{int((mp_sigmas <= 0).sum() + (vi_sigmas <= 0).sum())} "
          f"unobserved bands")


if __name__ == "__main__":
    main()
