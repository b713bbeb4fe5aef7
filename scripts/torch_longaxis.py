"""Config 5's long-axis recipe through the PyTorch/CUDA port
(base_tpu_torch) on one CUDA card: benchmarks/longaxis_10k_converged.py's
run, 10 000 stars, VI warm start into chunked dense HMC.

  1. the data: simulate_cluster (every star a binary, min_mass 0.15, on
     the synthetic grid with 64 EEPs), scatter_cluster (limit_mag 24, no
     censoring), make_ms_stars (cm_prior 0.99, sigma_model 0.01); the
     single-population model with n_q 8 at the given upsample, the
     kernels on the card;
  2. full-rank VI (vi.vi_warm_start: 600 steps, n_mc 8) for 16 chains:
     their start and the warmup's dense metric (inv_mass0);
  3. make_hmc_chunked_runner: 192 warmup transitions in 6 windows, 1024
     draws a chain in chunks of 24, l_max 24, step jitter, init_step 0.1,
     chain_chunk 8 (each density evaluation two calls of 8 rows).

Per upsample it prints one JSON line for the setup, one for VI and one
for HMC with the reference's keys (R-hat of the age and the largest of
the five live parameters, ESS of the age and per second, acceptance, step
size, the age's mean, sd and distance from the truth in sd), each
kernel's launches and the density calls; then whether the run met the
reference's convergence bar (R-hat of the age < 1.01, of all five
< 1.02).  It exits non-zero only on a fault: a non-finite draw, or a
kernel launched other than once per call of a block.  The last line is
the card's name and power limit.

    python3 scripts/torch_longaxis.py [--upsample 1 4] [--stars 10000]
        [--warmup 192] [--samples 1024]

from the repository root.  The data come from torch generators, so they
are not the reference's draws; compare posterior statistics.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

C, CHAIN_CHUNK, L_MAX, N_WINDOWS, CHUNK_DRAWS = 16, 8, 24, 6, 24
SIGMA_MODEL, N_Q, N_EEP = 0.01, 8, 64


def make_model(n_stars: int, upsample: int, dev):
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    grid = synthetic.make_grid(n_eep=N_EEP, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cat = simulate_cluster(grid, torch.as_tensor(cs.TRUTH), n_stars, gen,
                           percent_binary=1.0, min_mass=0.15)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0, censor=False)
    stars = make_ms_stars(sc.mags.numpy(), sc.sigmas.numpy(), cm_prior=0.99,
                          sigma_model=SIGMA_MODEL, device=dev)
    return post.make_single_pop_model(
        synthetic.make_grid(n_eep=N_EEP, device=dev), stars, cs.TRUTH,
        cs.PRIOR_SIGMA, n_q=N_Q, upsample=upsample, device=dev)


def run(n_stars: int, upsample: int, n_warmup: int, n_samples: int,
        dev) -> dict:
    from base_tpu_torch.inference import diagnostics as diag
    from base_tpu_torch.inference.driver import make_hmc_chunked_runner
    from base_tpu_torch.inference.hmc import HMCConfig, chain_blocks
    from base_tpu_torch.inference.vi import vi_warm_start
    from base_tpu_torch.model import posterior as post

    model = make_model(n_stars, upsample, dev)
    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    z0 = tr.inverse(torch.as_tensor(cs.TRUTH, device=dev))
    free = post.free_mask(model)
    print(json.dumps({"backend": "cuda", "stars": n_stars,
                      "upsample": upsample, "sigma_model": SIGMA_MODEL}),
          flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init, inv_mass0, res = vi_warm_start(
        fz, z0, torch.Generator(device=dev).manual_seed(5), C,
        free_mask=free)
    torch.cuda.synchronize()
    t_vi = time.perf_counter() - t0
    print(json.dumps({"vi_wall_s": t_vi,
                      "vi_elbo": float(res.final_elbo),
                      "vi_age_mu": float(tr.forward(res.mu)[0])}),
          flush=True)

    cfg = HMCConfig(n_warmup=n_warmup, n_samples=n_samples, l_max=L_MAX,
                    n_windows=N_WINDOWS, dense_mass=True, free_mask=free,
                    jitter_mode="step", chain_chunk=CHAIN_CHUNK,
                    init_step=0.1)
    f, rows = cs.counted_rows(fz)
    runner = make_hmc_chunked_runner(f, cfg, chunk_draws=CHUNK_DRAWS)
    cs.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    zs, info = runner(init, torch.Generator(device=dev).manual_seed(8),
                      inv_mass0=inv_mass0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = cs.launch_counts()
    blocks = chain_blocks(C, CHAIN_CHUNK)
    evals = cs.block_evaluations("longaxis", rows, C, CHAIN_CHUNK)

    xs = tr.forward(zs)
    finite = bool(torch.isfinite(xs).all())
    ess = float(diag.ess(xs[:, :, :1])[0])
    rhat = float(diag.split_rhat(xs[:, :, :1])[0])
    rhat5 = float(diag.split_rhat(xs[:, :, :5]).max())
    age = xs[..., 0].double()
    draws = int(zs.shape[0]) * C
    out = {
        "hmc_wall_s": dt, "total_wall_s": dt + t_vi, "draws": draws,
        "ess_age": ess, "ess_age_per_sec": ess / (dt + t_vi),
        "ess_per_draw": ess / draws,
        "accept": float(info["accept_prob"]),
        "step_size": float(info["step_size"]),
        "rhat_age": rhat, "rhat_max5": rhat5,
        "age_mean": float(age.mean()), "age_sd": float(age.std()),
        "age_truth_z": float((age.mean() - cs.TRUTH[0])
                             / max(float(age.std()), 1e-9)),
        "age_truth_quantile": float((age < float(cs.TRUTH[0])).double()
                                    .mean()),
        "grad_evals_per_sec": evals * C / dt,
        "star_evals_per_sec_M": evals * C * n_stars / dt / 1e6,
        "evaluations": evals, "blocks": blocks, "density_calls": len(rows),
        "ms_per_evaluation": 1e3 * dt / evals, "launches": counts,
        "finite": finite}
    print(json.dumps(out), flush=True)
    print(json.dumps({"converged": rhat < 1.01 and rhat5 < 1.02}),
          flush=True)
    if not finite:
        raise AssertionError(f"upsample {upsample}: non-finite draws")
    cs.check_one_launch_per_call(f"upsample {upsample}", counts, evals,
                                 blocks=blocks)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--upsample", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--stars", type=int, default=10_000)
    ap.add_argument("--warmup", type=int, default=192)
    ap.add_argument("--samples", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_longaxis: no CUDA device")
    from base_tpu_torch.ops import build

    build.library()
    dev = torch.device("cuda", 0)
    cs.log(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    for u in args.upsample:
        run(args.stars, u, args.warmup, args.samples, dev)
    print(cs.nvidia_smi())


if __name__ == "__main__":
    main()
