"""Config 5's SMC leg on the PyTorch/CUDA port (base_tpu_torch), summarised
so that it can be held beside base_tpu's run of the same recipe: is the
SMC posterior's under-dispersion the recipe's, or the port's?

The recipe is chip_smoke.py's phase 11 (BASELINE config 5,
benchmarks/smc_10k_tpu.py), imported from there: full-rank VI from the
truth (600 steps, n_mc 8), then tempered SMC (n_move 3, max_stages 30)
from the VI Gaussian inflated 2x, R replicates of P particles.  The
catalog is base_tpu's own at S stars (tests/data/smc_stars.npz, written
under JAX by scripts/smc_stars_from_jax.py), or with --stars 10000 phase
11's (the port's simulator, chip_smoke.make_data5).

For each free parameter it reports, with an uncertainty from the R
replicates: the SMC sd over the VI sd (the replicates' mean of their own
sd over the VI sd, and its standard error; VI's sd from 65 536 draws of
the fitted family), SMC's z = (mean - truth) / sd (the error of the mean
from the spread of the replicates' means; the mean itself is compared
too, since z's error leaves out the spread of the pooled sd it divides
by), and rep_spread (the sd of the replicates' means over the pooled sd;
its error s / sqrt(2 (R - 1))); and the log-evidence +- its repeat-run
SE.  scripts/smc_parity_jax.py writes
the same summary of base_tpu's run.  The packages agree on a figure when
their values differ by at most 3 of their combined standard errors,
sqrt(se_a^2 + se_b^2).

    python3 scripts/torch_smc_parity.py [--device cuda] [--stars 10000]
        [--upsample 1] [--reps 4] [--particles 256] [--block K]
        [--vi-from PATH] [--out chiprun_out/smc_parity_torch.json]
    python3 scripts/torch_smc_parity.py --compare A.json B.json

from the repository root.  On the card the density runs through the
kernels; `--device cpu` runs their plain versions, `--block` rows at a
time (a chain's row does not depend on its batch, so the blocks change
no result).  With --vi-from, SMC starts from base_tpu's own VI fit
(scripts/smc_vi_seeds_jax.py), so that the two packages' SMC legs are
compared from one starting family.  The summary is one JSON line, also
written to --out; the
last lines are the card's name and power limit (on the card) and the
run's walls.  --compare prints the table of two summaries and the
verdict by the 3-SE rule.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data", "smc_stars.npz")
FREE_NAMES = cs.NAMES5          # the five free cluster parameters
VI_DRAWS = 65_536
VI_DRAW_SEED = 8
AGREE_SE = 3.0


def _mean_se(v: np.ndarray) -> tuple[float, float]:
    return float(v.mean()), float(v.std(ddof=1) / math.sqrt(len(v)))


def parity_stats(xs: np.ndarray, vi_xs: np.ndarray, truth: np.ndarray,
                 n_rep: int, log_evidences: np.ndarray) -> dict:
    """The summary of an SMC run: particles xs [n_rep * N, 9]
    (replicate-major) and VI draws vi_xs [M, 9], both in the parameters'
    own space, and the replicates' log-evidences [n_rep]."""
    xr = xs.reshape(n_rep, -1, xs.shape[-1])
    pooled_sd = xs.std(0)
    rep_means = xr.mean(1)
    vi_sd = vi_xs.std(0)
    out = {}
    for i, name in enumerate(FREE_NAMES):
        ratio, ratio_se = _mean_se(xr[:, :, i].std(1) / vi_sd[i])
        mean_se = rep_means[:, i].std(ddof=1) / math.sqrt(n_rep)
        spread = float(rep_means[:, i].std() / max(pooled_sd[i], 1e-30))
        out[name] = dict(
            vi_sd=float(vi_sd[i]), smc_sd=float(pooled_sd[i]),
            smc_mean=float(xs[:, i].mean()), truth=float(truth[i]),
            sd_ratio=ratio, sd_ratio_se=ratio_se,
            sd_ratio_pooled=float(pooled_sd[i] / vi_sd[i]),
            z=float((xs[:, i].mean() - truth[i]) / max(pooled_sd[i], 1e-30)),
            z_se=float(mean_se / max(pooled_sd[i], 1e-30)),
            rep_spread=spread,
            rep_spread_se=spread / math.sqrt(2.0 * (n_rep - 1)))
    le = np.asarray(log_evidences, np.float64)
    out["log_evidence"] = dict(value=float(le.mean()),
                               se=float(le.std() / math.sqrt(n_rep)),
                               per_replicate=le.tolist())
    return out


def compare(a: dict, b: dict) -> dict:
    """{figure: (a, b, diff, combined se, agree)} of two summaries, and
    whether every figure agrees by the 3-SE rule."""
    rows = {}
    for name in FREE_NAMES:
        sa, sb = a["stats"][name], b["stats"][name]
        for key in ("sd_ratio", "z", "mean", "rep_spread"):
            if key == "mean":
                # The posterior mean itself, its error from the replicates
                # (z_se in the package's own pooled sd): z divides by that
                # sd, whose own spread between replicates z_se leaves out.
                va, vb = sa["smc_mean"], sb["smc_mean"]
                se = math.hypot(sa["z_se"] * sa["smc_sd"],
                                sb["z_se"] * sb["smc_sd"])
            else:
                va, vb = sa[key], sb[key]
                se = math.hypot(sa[f"{key}_se"], sb[f"{key}_se"])
            rows[f"{name}.{key}"] = (va, vb, va - vb, se,
                                     abs(va - vb) <= AGREE_SE * se)
    la, lb = a["stats"]["log_evidence"], b["stats"]["log_evidence"]
    se = math.hypot(la["se"], lb["se"])
    rows["log_evidence"] = (la["value"], lb["value"],
                            la["value"] - lb["value"], se,
                            abs(la["value"] - lb["value"]) <= AGREE_SE * se)
    return dict(rows=rows, agree=all(r[4] for r in rows.values()))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def load_catalog():
    """(mags, sigmas) [S, B] float32 of the stored catalog."""
    with np.load(DATA) as f:
        return f["mags"], f["sigmas"]


def blocked(fz, block: int | None):
    """fz evaluated `block` rows at a time (all at once when None)."""
    if block is None:
        return fz

    def f(z):
        return torch.cat([fz(z[i:i + block])
                          for i in range(0, z.shape[0], block)])

    return f


def vi_from(path: str, dev):
    """The VI fit on the first line of scripts/smc_vi_seeds_jax.py's
    output (base_tpu's, at its first key) as a VIResult on dev."""
    from base_tpu_torch.inference.vi import VIResult

    with open(path) as f:
        fit = json.loads(f.readline())

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return VIResult(mu=t(fit["mu"]), scale=t(fit["scale"]),
                    elbo_trace=t([]), final_elbo=t(fit["final_elbo"]))


def run(dev, mags, sigmas, upsample: int, n_rep: int, n_particles: int,
        block: int | None, vres=None) -> dict:
    """The recipe on (mags, sigmas) and its summary, walls and calls; with
    `vres`, SMC starts from that VI fit and the port's VI does not run."""
    from base_tpu_torch.inference.vi import sample_posterior
    from base_tpu_torch.model import posterior as post

    model, tr, free, z0 = cs.config5_model(mags, sigmas, dev, upsample)
    fz, calls = cs.counted(post.make_logpost_z_fn(model, tr))
    t0 = time.perf_counter()
    if vres is None:
        vres = cs.run_vi5(fz, z0)
    _sync(dev)
    vi_wall, vi_calls = time.perf_counter() - t0, calls[0]
    runner = cs.smc_runner5(blocked(fz, block), vres, z0, free, n_rep,
                            n_particles)
    t0 = time.perf_counter()
    z_part, info = runner(cs.smc_generator5(dev))
    _sync(dev)
    smc_wall = time.perf_counter() - t0
    with torch.no_grad():
        xs = tr.forward(z_part).double().cpu().numpy()
        vi_xs = tr.forward(sample_posterior(
            vres, torch.Generator(device=dev).manual_seed(VI_DRAW_SEED),
            VI_DRAWS)).double().cpu().numpy()
    if not bool((info["betas"][-1] >= 1.0).all()):
        raise AssertionError("an SMC replicate did not reach beta = 1")
    return dict(
        package="base_tpu_torch", device=str(dev),
        stars=int(mags.shape[0]), upsample=upsample, n_rep=n_rep,
        particles_per_rep=n_particles, vi_final_elbo=float(vres.final_elbo),
        vi_wall_s=vi_wall, vi_density_calls=vi_calls, smc_wall_s=smc_wall,
        smc_density_calls=calls[0] - vi_calls, stages=int(info["n_stages"]),
        move_accept=float(info["accept"]),
        move_scale=float(info["move_scale"]),
        posterior=cs.smc_posterior5(xs, n_rep),
        stats=parity_stats(xs, vi_xs, cs.TRUTH, n_rep,
                           info["log_evidences"].double().cpu().numpy()))


def print_compare(path_a: str, path_b: str) -> bool:
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    res = compare(a, b)
    print(f"{'figure':24s} {a['package']:>16s} {b['package']:>16s} "
          f"{'diff':>10s} {'comb. se':>10s}  3-SE rule")
    for key, (va, vb, d, se, ok) in res["rows"].items():
        print(f"{key:24s} {va:16.6g} {vb:16.6g} {d:10.4g} {se:10.4g}  "
              f"{'agree' if ok else 'DIFFER'}")
    print(json.dumps({"agree": res["agree"],
                      "differ": [k for k, r in res["rows"].items()
                                 if not r[4]]}))
    return res["agree"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stars", type=int, default=None,
                    help="10000: phase 11's catalog; default: the stored "
                         "catalog of base_tpu")
    ap.add_argument("--upsample", type=int, default=1)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--particles", type=int, default=256)
    ap.add_argument("--block", type=int, default=None,
                    help="density rows per call (default: all at once)")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "smc_parity_torch.json"))
    ap.add_argument("--vi-from", default=None, metavar="PATH",
                    help="start SMC from the VI fit in PATH "
                         "(scripts/smc_vi_seeds_jax.py's output)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    if args.compare:
        print_compare(*args.compare)
        return
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_smc_parity: no CUDA device")
        from base_tpu_torch.ops import build

        build.library()
    if args.stars is None:
        mags, sigmas = load_catalog()
        source = os.path.relpath(DATA, ROOT)
    elif args.stars == cs.N_STARS5:
        mags, sigmas = cs.make_data5()
        source = "chip_smoke.make_data5"
    else:
        raise SystemExit(f"--stars takes {cs.N_STARS5} (phase 11's "
                         f"catalog) or nothing (the stored one)")
    vres = vi_from(args.vi_from, dev) if args.vi_from else None
    res = run(dev, mags, sigmas, args.upsample, args.reps, args.particles,
              args.block, vres)
    res["catalog"] = source
    res["vi_from"] = args.vi_from
    line = json.dumps(res)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line)
    if dev.type == "cuda":
        print(cs.nvidia_smi())
    print(f"VI {res['vi_wall_s']:.1f} s ({res['vi_density_calls']} calls), "
          f"SMC {res['smc_wall_s']:.1f} s ({res['smc_density_calls']} "
          f"calls, {res['stages']} stages); wrote {args.out}")


if __name__ == "__main__":
    main()
