"""base_tpu's SMC recipe for BASELINE config 5, benchmarks/smc_10k_tpu.py,
run unchanged on the CPU, with its VI result and its particles kept so
that scripts/torch_smc_parity.py's summary can be made of them.

The script's own `main()` runs as it is (its settings from the
environment: SMC10K_STARS, SMC10K_UPSAMPLE, SMC10K_REPS,
SMC10K_PARTICLES) and prints its own lines; the wrappers below only keep
what its VI, its transform and its SMC runner return.  Afterwards the
particles and 65 536 draws of the VI family (PRNGKey(8)) go through the
transform into the parameters' own space, and the summary
(torch_smc_parity.parity_stats) is printed as one JSON line and written to
--out.  From the repository root, under JAX on the CPU:

    SMC10K_STARS=1000 SMC10K_UPSAMPLE=1 SMC10K_REPS=4 \\
        SMC10K_PARTICLES=256 python scripts/smc_parity_jax.py \\
        [--out chiprun_out/smc_parity_jax.json]

At SMC10K_STARS=S the script simulates the catalog of
tests/data/smc_stars.npz (scripts/smc_stars_from_jax.py) when that file
was written at S stars.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import smc_10k_tpu  # noqa: E402
import torch_smc_parity as tsp  # noqa: E402
from base_tpu.inference import smc as jsmc  # noqa: E402
from base_tpu.inference import vi as jvi  # noqa: E402
from base_tpu.model import posterior as jpost  # noqa: E402


def keep(module, name: str, store: dict, wrap_result=None):
    """Replace module.name by a wrapper that stores its result."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        if wrap_result is not None:
            out = wrap_result(out)
        store[name] = out
        return out

    setattr(module, name, wrapper)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "smc_parity_jax.json"))
    args = ap.parse_args()
    kept = {}

    def keep_runner(runner):
        def run(key):
            kept["smc"] = runner(key)
            return kept["smc"]
        return run

    keep(jvi, "run_vi_chunked", kept)
    keep(jpost, "default_transform", kept)
    keep(jsmc, "make_smc_chunked_runner", kept, keep_runner)
    t0 = time.perf_counter()
    smc_10k_tpu.main()
    wall = time.perf_counter() - t0
    tr, res = kept["default_transform"], kept["run_vi_chunked"]
    z_part, info = kept["smc"]
    forward = jax.jit(jax.vmap(tr.forward))
    xs = np.asarray(forward(z_part), np.float64)
    vi_xs = np.asarray(forward(jvi.sample_posterior(
        res, jax.random.PRNGKey(tsp.VI_DRAW_SEED), tsp.VI_DRAWS)), np.float64)
    n_rep = int(os.environ.get("SMC10K_REPS", "4"))
    out = dict(
        package="base_tpu", device=jax.default_backend(),
        stars=int(os.environ.get("SMC10K_STARS", "10000")),
        upsample=int(os.environ.get("SMC10K_UPSAMPLE", "4")), n_rep=n_rep,
        particles_per_rep=int(os.environ.get("SMC10K_PARTICLES", "1024")),
        vi_final_elbo=float(res.final_elbo), wall_s=wall,
        stages=int(info["n_stages"]), move_accept=float(info["accept"]),
        move_scale=float(info["move_scale"]),
        stats=tsp.parity_stats(xs, vi_xs, smc_10k_tpu.TRUTH, n_rep,
                               np.asarray(info["log_evidences"])))
    line = json.dumps(out)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
