"""Write tests/data/golden_singlepop_stars.json: the 64-star catalog behind
tests/data/golden_singlepop.json, as base_tpu makes it from JAX's threefry
streams (tests/test_goldens.py's `golden_model`: simulate_cluster at key 77
with 30% binaries, scatter_cluster at key 78 with limit_mag 24).

A machine without JAX reads the catalog from this file instead: the
magnitudes and sigmas are stored as the shortest decimals that round back
to their float32 values (np.float32(float(v)) gives each exactly), beside
the band names, the truth and the keys.  Runs under JAX on the CPU, from
the repository root:

    python scripts/golden_stars_from_jax.py [--out PATH]
"""
import argparse
import json
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

OUT = os.path.join(ROOT, "tests", "data", "golden_singlepop_stars.json")
TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
N_STARS, SIM_KEY, SCATTER_KEY = 64, 77, 78
PERCENT_BINARY, LIMIT_MAG = 0.3, 24.0


def golden_grid():
    """The golden model's grid (tests/test_goldens.py)."""
    return synthetic.make_grid(
        feh_axis=np.linspace(-1.5, 0.3, 4),
        y_axis=np.linspace(0.24, 0.31, 3),
        age_axis=np.linspace(8.6, 10.1, 6),
        n_eep=48,
    )


def golden_catalog(grid=None):
    """(mags, sigmas) [64, B] float32 and the band names, as
    tests/test_goldens.py makes them."""
    grid = golden_grid() if grid is None else grid
    cat = simulate_cluster(grid, jnp.asarray(TRUTH), N_STARS,
                           jax.random.PRNGKey(SIM_KEY),
                           percent_binary=PERCENT_BINARY)
    sc = scatter_cluster(cat.mags, jax.random.PRNGKey(SCATTER_KEY),
                         limit_mag=LIMIT_MAG)
    return (np.asarray(sc.mags, np.float32),
            np.asarray(sc.sigmas, np.float32), list(grid.bands))


def _f32(v) -> float:
    """The shortest decimal that rounds back to float32 v."""
    return float(str(np.float32(v)))


def as_json(mags, sigmas, bands) -> dict:
    def rows(a):
        return [[_f32(v) for v in row] for row in a]

    return {
        "source": "tests/test_goldens.py golden_model: simulate_cluster "
                  "(PRNGKey(77), percent_binary 0.3) -> scatter_cluster "
                  "(PRNGKey(78), limit_mag 24.0)",
        "bands": bands,
        "truth": [_f32(v) for v in TRUTH],
        "n_stars": N_STARS,
        "simulate_key": SIM_KEY,
        "scatter_key": SCATTER_KEY,
        "percent_binary": PERCENT_BINARY,
        "limit_mag": LIMIT_MAG,
        "mags": rows(mags),
        "sigmas": rows(sigmas),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    mags, sigmas, bands = golden_catalog()
    doc = as_json(mags, sigmas, bands)
    back = np.asarray(doc["mags"], np.float32), np.asarray(doc["sigmas"],
                                                            np.float32)
    if not (np.array_equal(back[0], mags) and np.array_equal(back[1], sigmas)):
        raise AssertionError("the catalog does not round-trip through JSON")
    with open(args.out, "w") as fh:
        json.dump(doc, fh, indent=None, separators=(",", ":"))
        fh.write("\n")
    print(f"wrote {args.out}: {mags.shape[0]} stars x {len(bands)} bands, "
          f"{int((sigmas <= 0).sum())} unobserved bands")


if __name__ == "__main__":
    main()
