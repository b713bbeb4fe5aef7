"""Simulation-based calibration (SBC; Talts et al. 2018) of the PyTorch/CUDA
port (base_tpu_torch): tests/test_calibration.py's three checks, run on
base_tpu's own 64 data sets in one batched run each.

The data sets are tests/data/sbc_stars.npz (written under JAX by
scripts/sbc_stars_from_jax.py): their truths are drawn from the prior, and
under a calibrated sampler the posterior rank of each truth is uniform
over the replicas.  Each case builds one single-population model on all 64
star sets (stardata.stack_ms_stars; tests/conftest.py's small grid through
grids.synthetic), one chain a replica, chain r scored on set r, and runs
at base_tpu's settings:

- `mh`: adaptive MH 300 + 300 + 2000 (mh.run_adaptive_mh, which adapts
  every chain on its own), n_q 4, no binaries, draws thinned by 10;
- `hmc_binaries`: the binaries case (20 stars drawn from the density's own
  segment table, n_q 8), HMC 144 + 288, l_max 16, 3 windows, dense, draws
  thinned by 4;
- `hmc`: 32 stars, n_q 4, no binaries, HMC 192 + 384, same settings.

HMC runs with `replicas=64` (hmc.run_hmc): each replica adapts its own
step size and dense metric on its own chain, as base_tpu's vmap of
run_hmc over data sets does.

For each case and each of age, [Fe/H], modulus and A_V it prints the
chi-square of the ranks over 8 bins and their mean beside base_tpu's
criteria (chi-square < 24.32; 0.35 < mean rank < 0.65), then the case's
wall, its density evaluations and each kernel's launches, which are held
equal to the evaluations that run it (a fault otherwise).  Each case is
one JSON line; all of them are also written to chiprun_out/sbc.json.  The
last lines are the card's name and power limit and the verdict.  A case
that misses a criterion is reported, not re-seeded or lengthened: the
seeds are fixed here.

    python3 scripts/torch_sbc.py [--cases mh hmc_binaries hmc]
        [--device cuda] [--replicas 64]

from the repository root.  On the card every kernel runs through its CUDA
build; `--device cpu` runs the plain versions (tests/test_torch_sbc.py's
slow tests).  `--replicas` cuts the run to the first k data sets, for a
rehearsal; the criteria are base_tpu's at 64.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "tests", "data", "sbc_stars.npz")
# tests/conftest.py's small_grid.
GRID_AXES = dict(feh_axis=np.linspace(-1.5, 0.3, 4),
                 y_axis=np.linspace(0.24, 0.31, 3),
                 age_axis=np.linspace(8.6, 10.1, 6), n_eep=48)
# tests/test_calibration.py's constants.
R = 64
BASE = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
PRIOR_SIGMA = np.array([0.12, -1, 0.22, 0.25, 0.08, -1, -1, -1, -1],
                       np.float32)
CHECK = {"age": 0, "FeH": 2, "modulus": 3, "A_V": 4}
NBINS, CHI2_CRIT, MEAN_LO, MEAN_HI = 8, 24.32, 0.35, 0.65
FREE = (1, 1, 1, 1, 1, 0, 0, 0, 0)
STEP0_MH = np.array([0.04, 0.02, 0.05, 0.05, 0.03, 0, 0, 0, 0], np.float32)
# Each case's data collection, model, sampler settings, thinning and seed
# (the seeds are base_tpu's PRNGKeys of the same tests, as numbers for
# torch generators: the streams differ).
CASES = {
    "mh": dict(collection="ms", n_q=4, binaries=False, sampler="mh",
               settings=dict(n_stage1=300, n_stage2=300, n_main=2000),
               thin=10, seed=5),
    "hmc_binaries": dict(collection="bin", n_q=8, binaries=True,
                         sampler="hmc",
                         settings=dict(n_warmup=144, n_samples=288, l_max=16,
                                       n_windows=3, dense_mass=True,
                                       free_mask=FREE),
                         thin=4, seed=13),
    "hmc": dict(collection="ms", n_q=4, binaries=False, sampler="hmc",
                settings=dict(n_warmup=192, n_samples=384, l_max=16,
                              n_windows=3, dense_mass=True, free_mask=FREE),
                thin=4, seed=9),
}
KERNEL_NAMES = ("table_fwd", "table_bwd", "marglik_fwd", "marglik_bwd")


def load_sets(collection: str, replicas: int = R) -> dict:
    """The first `replicas` data sets of a collection ("ms" or "bin"):
    truths [k, 9], mags and sigmas [k, S, B] float32, bands."""
    with np.load(DATA) as f:
        return dict(truths=f["truths"][:replicas],
                    mags=f[f"{collection}_mags"][:replicas],
                    sigmas=f[f"{collection}_sigmas"][:replicas],
                    bands=[str(b) for b in f["bands"]])


# How far `sbc_model(..., moved_set=r)` moves set r's magnitudes (mag): the
# replica-independence checks.
MOVED_MAG = 0.05


def sbc_model(collection: str, n_q: int, binaries: bool, device,
              replicas: int = R, moved_set: int | None = None,
              sigma_model: float = 0.0):
    """(model on the stacked star sets, truths [k, 9]), as
    tests/test_calibration.py builds its frame model (cm_prior 0.999);
    with `moved_set`, that set's magnitudes moved by MOVED_MAG; with
    `sigma_model`, a model floor added to every sigma in quadrature (the
    kernel checks' well-conditioned inputs)."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars, stack_ms_stars

    sets = load_sets(collection, replicas)
    if moved_set is not None:
        sets["mags"] = sets["mags"].copy()
        sets["mags"][moved_set] += MOVED_MAG
    grid = synthetic.make_grid(**GRID_AXES, device=device)
    if list(grid.bands) != sets["bands"]:
        raise AssertionError(f"bands {sets['bands']} vs {grid.bands}")
    stars = stack_ms_stars([
        make_ms_stars(m, s, cm_prior=0.999, sigma_model=sigma_model,
                      device=device)
        for m, s in zip(sets["mags"], sets["sigmas"])])
    model = post.make_single_pop_model(
        grid, stars, prior_mean=BASE, prior_sigma=PRIOR_SIGMA, n_q=n_q,
        binaries=binaries, device=device)
    return model, sets["truths"]


def near_truths(truths: np.ndarray, k: int, seed: int) -> np.ndarray:
    """k points a set near its truth, [G * k, 9] float32, set-major: the
    five cluster parameters moved by about a posterior sd (0.03 in age,
    [Fe/H] and modulus, 0.005 in Y, 0.02 in A_V)."""
    x = np.repeat(truths, k, axis=0)
    x[:, :5] += np.random.default_rng(seed).normal(
        0, [0.03, 0.005, 0.03, 0.03, 0.02], (x.shape[0], 5))
    return x.astype(np.float32)


def rank_stats(samples: np.ndarray, truths: np.ndarray, thin: int) -> dict:
    """base_tpu's `_assert_uniform_ranks` for each checked parameter, as
    numbers: samples [n, k, 9] -> {name: chi2, mean_rank, counts, ok}."""
    k = truths.shape[0]
    thinned = samples[::thin]                            # [n', k, 9]
    out = {}
    for name, p in CHECK.items():
        ranks = (thinned[:, :, p] < truths[None, :, p]).mean(axis=0)
        counts = np.histogram(ranks, bins=NBINS, range=(0.0, 1.0 + 1e-9))[0]
        expected = k / NBINS
        chi2 = float(((counts - expected) ** 2 / expected).sum())
        mean = float(ranks.mean())
        out[name] = dict(chi2=chi2, mean_rank=mean,
                         counts=[int(c) for c in counts],
                         ok=bool(chi2 < CHI2_CRIT
                                 and MEAN_LO < mean < MEAN_HI))
    return out


def launch_counts() -> dict:
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    return {"table_fwd": tb.table_fwd_launches,
            "table_bwd": tb.table_bwd_launches,
            "marglik_fwd": ml.marglik_fwd_launches,
            "marglik_bwd": ml.marglik_bwd_launches}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_case(name: str, device, replicas: int = R) -> dict:
    """One SBC case on the first `replicas` data sets: its rank statistics,
    wall, density evaluations and kernel launches, and the draws
    (`samples` [n, k, 9], not printed)."""
    from base_tpu_torch.inference import hmc, mh
    from base_tpu_torch.model import posterior as post

    case = CASES[name]
    model, truths = sbc_model(case["collection"], case["n_q"],
                              case["binaries"], device, replicas)
    gen = torch.Generator(device=device).manual_seed(case["seed"])
    x0 = torch.as_tensor(truths, device=device)
    calls = [0]

    def counted(fn):
        def f(x):
            calls[0] += 1
            return fn(x)
        return f

    _sync(device)
    before = launch_counts()
    t0 = time.perf_counter()
    if case["sampler"] == "mh":
        f = counted(post.make_logpost_fn(model))
        xs, info = mh.run_adaptive_mh(f, x0, gen, STEP0_MH,
                                      mh.MHConfig(**case["settings"]))
        accept = float(info["accept_rate"].mean())
    else:
        tr = post.default_transform(model)
        fz = counted(post.make_logpost_z_fn(model, tr))
        zs, info = hmc.run_hmc(fz, tr.inverse(x0), gen,
                               hmc.HMCConfig(**case["settings"]),
                               replicas=replicas)
        xs = tr.forward(zs.reshape(-1, zs.shape[-1])).reshape(zs.shape)
        accept = float(info["accept_prob"])
    _sync(device)
    wall = time.perf_counter() - t0
    after = launch_counts()
    samples = xs.cpu().numpy()
    if not np.isfinite(samples).all():
        raise AssertionError(f"{name}: non-finite draws")
    launches = {k: after[k] - before[k] for k in KERNEL_NAMES}
    return dict(case=name, replicas=replicas, device=str(device),
                stars=int(model.stars.n_stars), n_q=case["n_q"],
                binaries=case["binaries"], seed=case["seed"],
                thin=case["thin"], draws=int(samples.shape[0]),
                wall_s=wall, evaluations=calls[0],
                ms_per_evaluation=1e3 * wall / calls[0], accept=accept,
                launches=launches,
                ranks=rank_stats(samples, truths, case["thin"]),
                samples=samples)


def check_launches(res: dict, cuda: bool) -> None:
    """Every kernel the case's density runs launched once an evaluation
    (MH: forwards only; kernels 1-2 only with binaries); none on the
    CPU."""
    n = res["evaluations"]
    want = {k: 0 for k in KERNEL_NAMES}
    if cuda:
        want["marglik_fwd"] = n
        want["table_fwd"] = n if res["binaries"] else 0
        if res["case"] != "mh":
            want["marglik_bwd"] = n
            want["table_bwd"] = n if res["binaries"] else 0
    if res["launches"] != want:
        raise AssertionError(f"{res['case']}: launches {res['launches']} "
                             f"against {want}")


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=R)
    args = ap.parse_args()
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("torch_sbc: no CUDA device (use --device cpu)")
    if cuda:
        from base_tpu_torch.ops import build

        t0 = time.perf_counter()
        build.library()
        print(f"kernel build + load: {time.perf_counter() - t0:.3f} s; "
              f"{torch.cuda.get_device_name(0)}", flush=True)
    results = []
    for name in args.cases:
        res = run_case(name, device, args.replicas)
        check_launches(res, cuda)
        res.pop("samples")
        results.append(res)
        print(json.dumps(res), flush=True)
        for p, st in res["ranks"].items():
            print(f"  {name:13s} {p:8s} chi2 {st['chi2']:6.2f} (< "
                  f"{CHI2_CRIT})  mean rank {st['mean_rank']:.4f} "
                  f"({MEAN_LO}-{MEAN_HI})  counts {st['counts']}  "
                  f"{'ok' if st['ok'] else 'MISS'}", flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    smi = nvidia_smi() if cuda else "cpu"
    with open(os.path.join(out, "sbc.json"), "w") as fh:
        json.dump({"cases": results, "card": smi}, fh, indent=1)
    print(smi)
    print(json.dumps({"sbc_ok": {r["case"]: all(s["ok"] for s in
                                                r["ranks"].values())
                                 for r in results},
                      "walls_s": {r["case"]: r["wall_s"] for r in results}}))


if __name__ == "__main__":
    main()
