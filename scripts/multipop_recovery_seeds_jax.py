"""base_tpu's two-population HMC recovery
(tests/test_multipop.py `test_multipop_hmc_ordered_recovery`) at other
seeds: how often a run at its settings misses its criteria.  The
reference's side of scripts/torch_slow_checks.py's `--seeds`.

For each S the run's keys are PRNGKey(S) (the init noise) and
PRNGKey(S + 1) (HMC); the test's own run is S = 60.  The catalog is
tests/data/slow_checks_stars.npz's (the test's photometry, bit for bit),
the model, settings and criteria are the test's (split R-hat < 1.05 on
age, [Fe/H], modulus, A_V, Y_A, Y_B and lambda: the test's six and A_V,
as the port's script holds them).  One JSON line a seed with each
criterion's verdict, the acceptance, the step size, split R-hat of each
parameter and each chain's share of draws that moved.  Runs under JAX on
the CPU, from the repository root (~1.5 min a seed):

    python scripts/multipop_recovery_seeds_jax.py S [S ...]
"""
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
from base_tpu.inference import diagnostics as diag  # noqa: E402
from base_tpu.inference.hmc import HMCConfig, run_hmc  # noqa: E402
from base_tpu.model import multipop as mp  # noqa: E402
from base_tpu.model.stardata import make_ms_stars  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data", "slow_checks_stars.npz")
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1, -1, -1, -1],
                       np.float32)
PARAMS = {"logAge": 0, "FeH": 2, "modulus": 3, "A_V": 4, "Y_A": 9,
          "Y_B": 10, "lambda": 11}


def main() -> None:
    seeds = [int(a) for a in sys.argv[1:]]
    grid = synthetic.make_grid(feh_axis=np.linspace(-1.5, 0.3, 4),
                               y_axis=np.linspace(0.24, 0.31, 3),
                               age_axis=np.linspace(8.6, 10.1, 6), n_eep=48)
    with np.load(DATA) as f:
        truth = f["mp_truth"]
        stars = make_ms_stars(f["mp_mags"], f["mp_sigmas"],
                              cm_prior=float(f["cm_prior"]))
    model = mp.make_multipop_model(grid, stars, truth.copy(), PRIOR_SIGMA,
                                   n_q=6, binaries=False)
    tr = mp.ordered_transform(model)
    fz = mp.make_logpost_z_fn(model, tr)
    z0 = tr.inverse(jnp.asarray(truth))
    cfg = HMCConfig(n_warmup=500, n_samples=500, l_max=16, n_windows=4,
                    dense_mass=True, free_mask=mp.free_mask(model))
    run = jax.jit(lambda z, k: run_hmc(fz, z, k, cfg))
    idx = list(PARAMS.values())
    for s in seeds:
        init = jnp.tile(z0[None, :], (8, 1))
        init = init + 0.01 * jax.random.normal(jax.random.PRNGKey(s),
                                               init.shape)
        zs, info = run(init, jax.random.PRNGKey(s + 1))
        xs = np.asarray(jax.vmap(jax.vmap(tr.forward))(zs))   # [N, C, 12]
        zz = np.asarray(zs)
        rhat = np.asarray(diag.split_rhat(jnp.asarray(xs[:, :, idx])))
        ya, yb = xs[:, :, 9], xs[:, :, 10]
        lam = xs[:, :, 11]
        accept = float(info["accept_prob"])
        crit = {"accept": accept > 0.5, "ordered": bool((yb > ya).all()),
                "Y_A": abs(ya.mean() - truth[9]) < 0.02,
                "Y_B": abs(yb.mean() - truth[10]) < 0.02,
                "lambda": abs(lam.mean() - truth[11])
                < max(4 * lam.std(), 0.15)}
        crit.update({f"rhat {n}": bool(r < 1.05)
                     for n, r in zip(PARAMS, rhat)})
        print(json.dumps(dict(
            seed=s, ok=all(crit.values()),
            misses=[k for k, v in crit.items() if not v],
            accept=accept, step_size=float(info["step_size"]),
            rhat={n: round(float(r), 4) for n, r in zip(PARAMS, rhat)},
            chain_moved=[round(float(m), 4) for m in
                         (zz[1:] != zz[:-1]).any(-1).mean(0)])),
            flush=True)


if __name__ == "__main__":
    main()
