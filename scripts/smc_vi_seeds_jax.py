"""Config 5's VI stage on base_tpu's stored catalog (tests/data/smc_stars.npz)
in both packages, on the CPU: how far does the fitted family move with the
noise stream alone?

The SMC summaries of scripts/torch_smc_parity.py divide each SMC sd by the
VI sd, so a difference between the packages' VI fits moves those ratios.
This script runs base_tpu's recipe VI (benchmarks/smc_10k_tpu.py:72-75,
full rank, 600 steps, n_mc 8, upsample --upsample) at several PRNG keys,
and the port's `vi.fit_vi` fed base_tpu's own draws at the first key
(jax.random.normal(k, (n_mc, P)) for k in jax.random.split(key, n_steps),
as tests/test_torch_vi_mh.py does at small size).  For each fit it prints
the final ELBO (the mean of the last 50 steps) and each free parameter's
sd in its own space (65 536 draws of the family through the transform)
and the fit (mu, scale), one JSON line each, and writes them all to
--out; scripts/torch_smc_parity.py --vi-from takes the first line's fit
as its SMC's starting family.  From the repository
root, under JAX on the CPU:

    python scripts/smc_vi_seeds_jax.py [--keys 5 6 7] [--upsample 1]
        [--out chiprun_out/smc_vi_seeds.json]
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_smc_parity as tsp  # noqa: E402
from base_tpu.grids import synthetic as jsyn  # noqa: E402
from base_tpu.inference import vi as jvi  # noqa: E402
from base_tpu.model import posterior as jpost  # noqa: E402
from base_tpu.model.stardata import make_ms_stars as jmake_stars  # noqa: E402
from base_tpu_torch.inference import vi as tvi  # noqa: E402
from base_tpu_torch.model import posterior as tpost  # noqa: E402

cs = tsp.cs


def summary(package, key, res, vi_xs, wall):
    sd = vi_xs.std(0)
    return dict(package=package, key=key, final_elbo=float(res.final_elbo),
                wall_s=wall, vi_sd={n: float(sd[i])
                                    for i, n in enumerate(tsp.FREE_NAMES)},
                mu=np.asarray(res.mu, np.float64).tolist(),
                scale=np.asarray(res.scale, np.float64).tolist())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, nargs="+", default=[5, 6, 7])
    ap.add_argument("--upsample", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "smc_vi_seeds.json"))
    args = ap.parse_args()
    mags, sigmas = tsp.load_catalog()
    jm = jpost.make_single_pop_model(
        jsyn.make_grid(n_eep=cs.N_EEP), jmake_stars(mags, sigmas,
                                                    cm_prior=0.99),
        prior_mean=cs.TRUTH, prior_sigma=cs.PRIOR_SIGMA, n_q=cs.N_Q,
        use_pallas=False, upsample=args.upsample)
    jtr = jpost.default_transform(jm)
    jfz = jpost.make_logpost_z_fn(jm, jtr)
    jz0 = jtr.inverse(jnp.asarray(cs.TRUTH))
    jcfg = jvi.VIConfig(**cs.VI_CFG5)
    forward = jax.jit(jax.vmap(jtr.forward))
    draw_key = jax.random.PRNGKey(tsp.VI_DRAW_SEED)
    lines = []
    for key in args.keys:
        t0 = time.perf_counter()
        res = jvi.run_vi_chunked(jfz, jz0, jax.random.PRNGKey(key), jcfg,
                                 chunk_steps=100)
        jax.block_until_ready(res.mu)
        wall = time.perf_counter() - t0
        xs = np.asarray(forward(jvi.sample_posterior(res, draw_key,
                                                     tsp.VI_DRAWS)))
        lines.append(summary("base_tpu", key, res, xs, wall))
        print(json.dumps(lines[-1]), flush=True)

    key = args.keys[0]
    noise = np.stack([np.asarray(jax.random.normal(k, (jcfg.n_mc, 9)))
                      for k in jax.random.split(jax.random.PRNGKey(key),
                                                jcfg.n_steps)])
    model, tr, _, z0 = cs.config5_model(mags, sigmas, torch.device("cpu"),
                                        args.upsample)
    t0 = time.perf_counter()
    res = tvi.fit_vi(tpost.make_logpost_z_fn(model, tr), z0,
                     torch.from_numpy(noise), tvi.VIConfig(**cs.VI_CFG5))
    wall = time.perf_counter() - t0
    with torch.no_grad():
        xs = tr.forward(tvi.sample_posterior(
            res, torch.Generator().manual_seed(tsp.VI_DRAW_SEED),
            tsp.VI_DRAWS)).double().numpy()
    lines.append(summary("base_tpu_torch on base_tpu's noise", key,
                         res, xs, wall))
    print(json.dumps(lines[-1]), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("".join(json.dumps(x) + "\n" for x in lines))


if __name__ == "__main__":
    main()
