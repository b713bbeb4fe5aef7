"""base_tpu's last two slow checks, held on the PyTorch/CUDA port
(base_tpu_torch), and the two-population recovery at config 4's full
width:

- `A`: tests/test_multipop.py `test_multipop_hmc_ordered_recovery`.  Its
  80-star two-population catalog (48 stars at Y_A = 0.25, 32 at Y_B =
  0.31), n_q 6, no binaries; HMC through the ordered (Y_A < Y_B)
  transform on 8 chains from the truth plus 0.01 N(0, 1) in z, 500 + 500
  transitions, l_max 16, 4 windows, dense metric, the model's free mask.
- `B`: the same recovery on chip_smoke.py's config-4 model (400 stars,
  every one a binary, n_q 8, upsample 4, 32 chains = 64 table chains):
  full-rank VI warm start (600 steps) from chip_smoke's START4, its draws
  and covariance into HMC at A's settings.  base_tpu never ran this case.
- `C`: tests/test_vi.py `test_vi_on_cluster_posterior`.  Its 48-star
  catalog, n_q 6, no binaries; VI (600 steps, n_mc 8, learning rate
  1e-2, mean-field) from the truth, then 500 draws of the fitted family.

The catalogs of A and C are tests/data/slow_checks_stars.npz (written
under JAX by scripts/slow_checks_stars_from_jax.py; the card's machine
has no JAX), on tests/conftest.py's small grid built by the port's
grids.synthetic.  The criteria are base_tpu's:

- A and B: acceptance > 0.5; Y_B > Y_A in every draw; the means of Y_A
  and Y_B within 0.02 of the truth; the mean of lambda within max(4 sd,
  0.15); split R-hat < 1.05 on age, [Fe/H], modulus, A_V, Y_A, Y_B and
  lambda (test_multipop.py's six, and A_V);
- C: every draw finite; the mean age within 0.15 of the truth.

Each case prints every criterion beside its limit, its wall, its density
evaluations, each kernel's launches (held equal to the evaluations that
run it: a fault otherwise) and every parameter's mean, sd, split R-hat
and ESS, as one JSON line and a table; all of them also go to
chiprun_out/slow_checks.json.  The last lines are the card's name and
power limit and the verdict.  The seeds are fixed here: a case that
misses is reported, not re-seeded or lengthened.

    python3 scripts/torch_slow_checks.py [--cases A B C] [--device cuda]
        [--seeds S ...]

from the repository root.  `--seeds` runs case A alone at each seed pair
(S, S + 1) instead, one summary line a seed: how often base_tpu's
criteria miss at its settings.  On the card every kernel runs through its CUDA
build; `--device cpu` runs the plain versions
(tests/test_torch_slow_checks.py's slow tests run A and C that way).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from torch_sbc import KERNEL_NAMES, _sync, launch_counts, nvidia_smi  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data", "slow_checks_stars.npz")
# tests/conftest.py's small_grid.
GRID_AXES = dict(feh_axis=np.linspace(-1.5, 0.3, 4),
                 y_axis=np.linspace(0.24, 0.31, 3),
                 age_axis=np.linspace(8.6, 10.1, 6), n_eep=48)
# tests/test_multipop.py's two_pop_data and tests/test_vi.py's model.
MP_PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1, -1, -1,
                           -1], np.float32)
VI_PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1],
                          np.float32)
N_Q = 6
# test_multipop_hmc_ordered_recovery's run and criteria.
N_CHAINS_A, INIT_SD = 8, 0.01
HMC = dict(n_warmup=500, n_samples=500, l_max=16, n_windows=4,
           dense_mass=True)
ACCEPT_MIN, Y_TOL, LAMBDA_SDS, LAMBDA_FLOOR, RHAT_MAX = 0.5, 0.02, 4, 0.15, \
    1.05
# Parameters whose split R-hat is held (index in the 12-vector).
RHAT_PARAMS = {"logAge": 0, "FeH": 2, "modulus": 3, "A_V": 4, "Y_A": 9,
               "Y_B": 10, "lambda": 11}
# test_vi_on_cluster_posterior's fit and criterion.
VI = dict(n_steps=600, n_mc=8, learning_rate=1e-2)
N_DRAWS_C, AGE_TOL_C = 500, 0.15
VI_PARAMS = {"logAge": 0, "FeH": 2, "modulus": 3, "A_V": 4}
# The seeds (base_tpu's PRNGKeys of the same tests, as numbers for torch
# generators: the streams differ; B's are phase 8c's).
SEEDS = {"A": dict(init=60, hmc=61), "B": dict(vi=3, hmc=5),
         "C": dict(vi=63, draws=64)}
# The density checks' points (tests/test_torch_slow_checks_data.py and
# the card tests): the truth, then points moved about a posterior sd in
# the sampled dims, Y_B down (its truth, 0.31, is the grid's hull).
PARITY_SD = {0: 0.03, 2: 0.03, 3: 0.03, 4: 0.02, 9: 0.003, 10: -0.003,
             11: 0.05}


def parity_points(truth, n: int = 3, seed: int = 0) -> np.ndarray:
    """[n, P] float32: the truth [P], then n - 1 points near it."""
    rng = np.random.default_rng(seed)
    p = np.tile(np.asarray(truth, np.float32), (n, 1))
    for i, sd in PARITY_SD.items():
        if i < p.shape[1]:
            step = np.abs(rng.normal(0.0, abs(sd), n - 1))
            p[1:, i] += np.where(sd < 0, -step, rng.choice([-1, 1], n - 1)
                                 * step)
    return p.astype(np.float32)


def load_catalog(name: str) -> dict:
    """Catalog "mp" (case A) or "vi" (case C): mags, sigmas [S, B]
    float32, cm_prior, truth, bands."""
    with np.load(DATA) as f:
        return dict(mags=f[f"{name}_mags"], sigmas=f[f"{name}_sigmas"],
                    truth=f[f"{name}_truth"], cm_prior=float(f["cm_prior"]),
                    bands=[str(b) for b in f["bands"]])


def _stars_and_grid(name: str, device):
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model.stardata import make_ms_stars

    cat = load_catalog(name)
    grid = synthetic.make_grid(**GRID_AXES, device=device)
    if list(grid.bands) != cat["bands"]:
        raise AssertionError(f"bands {cat['bands']} vs {grid.bands}")
    stars = make_ms_stars(cat["mags"], cat["sigmas"],
                          cm_prior=cat["cm_prior"], device=device)
    return grid, stars, cat["truth"]


def mp_model(device):
    """(case A's two-population model, its truth [12])."""
    from base_tpu_torch.model import multipop as mp

    grid, stars, truth = _stars_and_grid("mp", device)
    return mp.make_multipop_model(grid, stars, truth, MP_PRIOR_SIGMA,
                                  n_q=N_Q, binaries=False,
                                  device=device), truth


def vi_model(device):
    """(case C's single-population model, its truth [9])."""
    from base_tpu_torch.model import posterior as post

    grid, stars, truth = _stars_and_grid("vi", device)
    return post.make_single_pop_model(grid, stars, prior_mean=truth,
                                      prior_sigma=VI_PRIOR_SIGMA, n_q=N_Q,
                                      binaries=False, device=device), truth


def check_launches(label: str, launches: dict, evaluations: int,
                   binaries: bool, cuda: bool) -> None:
    """Kernels 3-4 launched once an evaluation (value and gradient), and
    kernels 1-2 too where the model has binaries; none on the CPU."""
    want = dict.fromkeys(KERNEL_NAMES, 0)
    if cuda:
        for k in KERNEL_NAMES:
            if binaries or k.startswith("marglik"):
                want[k] = evaluations
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} for "
                             f"{evaluations} evaluations (want {want})")


class Counted:
    """A density with a call counter and the kernel launches since
    `start()`."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, z):
        self.calls += 1
        return self.fn(z)

    def start(self, device) -> None:
        _sync(device)
        self.calls, self.before, self.t0 = 0, launch_counts(), \
            time.perf_counter()

    def stop(self, device) -> dict:
        _sync(device)
        wall = time.perf_counter() - self.t0
        after = launch_counts()
        return dict(wall_s=wall, evaluations=self.calls,
                    launches={k: after[k] - self.before[k]
                              for k in KERNEL_NAMES})


def posterior_table(xs: torch.Tensor, params: dict, truth) -> dict:
    """{name: mean, sd, truth, split R-hat, ESS} over draws xs [N, C, P]
    of the parameters `params` ({name: index})."""
    from base_tpu_torch.inference import diagnostics as diag

    idx = list(params.values())
    sub = xs[:, :, idx].double()
    rhat = diag.split_rhat(sub).tolist()
    ess = diag.ess(sub).tolist()
    flat = sub.reshape(-1, len(idx))
    return {n: dict(mean=float(flat[:, j].mean()),
                    sd=float(flat[:, j].std(correction=0)),
                    truth=float(truth[i]), rhat=rhat[j], ess=ess[j])
            for j, (n, i) in enumerate(params.items())}


def criterion(name: str, value: float, limit: str, ok: bool) -> dict:
    return dict(name=name, value=value, limit=limit, ok=bool(ok))


def recovery_criteria(xs: np.ndarray, truth, accept: float,
                      post: dict) -> list:
    """test_multipop_hmc_ordered_recovery's criteria on draws xs [N, C,
    12] (numpy, float32 as base_tpu's)."""
    from base_tpu_torch.model import multipop as mp

    ya, yb = xs[:, :, mp.MP_YYA], xs[:, :, mp.MP_YYB]
    lam = xs[:, :, mp.MP_LAMBDA]
    gap = float((yb - ya).min())
    d_ya = abs(float(ya.mean()) - float(truth[mp.MP_YYA]))
    d_yb = abs(float(yb.mean()) - float(truth[mp.MP_YYB]))
    d_lam = abs(float(lam.mean()) - float(truth[mp.MP_LAMBDA]))
    lam_lim = max(LAMBDA_SDS * float(lam.std()), LAMBDA_FLOOR)
    out = [criterion("accept", accept, f"> {ACCEPT_MIN}",
                     accept > ACCEPT_MIN),
           criterion("min(Y_B - Y_A)", gap, "> 0", gap > 0),
           criterion("|mean Y_A - truth|", d_ya, f"< {Y_TOL}", d_ya < Y_TOL),
           criterion("|mean Y_B - truth|", d_yb, f"< {Y_TOL}", d_yb < Y_TOL),
           criterion("|mean lambda - truth|", d_lam,
                     f"< max({LAMBDA_SDS} sd, {LAMBDA_FLOOR}) = "
                     f"{lam_lim:.4f}", d_lam < lam_lim)]
    for n in RHAT_PARAMS:
        r = post[n]["rhat"]
        out.append(criterion(f"split R-hat {n}", r, f"< {RHAT_MAX}",
                             r < RHAT_MAX))
    return out


def run_recovery(model, truth, init: torch.Tensor, gen: torch.Generator,
                 inv_mass0=None) -> dict:
    """HMC at test_multipop_hmc_ordered_recovery's settings (HMC) through
    the ordered transform from `init` [C, 12] with the metric `inv_mass0`
    (the unit metric if None), in one chunk of the driver's runner; its
    criteria, posterior table, wall, evaluations, launches and each
    chain's share of draws that moved."""
    from base_tpu_torch.inference.driver import make_hmc_chunked_runner
    from base_tpu_torch.inference.hmc import HMCConfig
    from base_tpu_torch.model import multipop as mp

    dev = init.device
    tr = mp.ordered_transform(model)
    fz = Counted(mp.make_logpost_z_fn(model, tr))
    cfg = HMCConfig(**HMC, free_mask=mp.free_mask(model))
    runner = make_hmc_chunked_runner(fz, cfg, chunk_draws=cfg.n_samples)
    fz.start(dev)
    zs, info = runner(init, gen, inv_mass0=inv_mass0)
    res = fz.stop(dev)
    xs = tr.forward(zs)                                  # [N, C, 12]
    if not bool(torch.isfinite(xs).all()):
        raise AssertionError("non-finite HMC draws")
    accept = float(info["accept_prob"])
    post = posterior_table(xs, RHAT_PARAMS, truth)
    # Each chain's share of draws that moved: a chain stuck where every
    # trajectory is rejected shows as 0.
    moved = (zs[1:] != zs[:-1]).any(-1).double().mean(0)
    res.update(chains=int(init.shape[0]), draws=int(xs.shape[0]),
               accept=accept, step_size=float(info["step_size"]),
               chain_moved=[round(float(m), 4) for m in moved],
               posterior=post,
               criteria=recovery_criteria(xs.cpu().numpy(), truth, accept,
                                          post))
    return res


def case_a(device, seeds: dict | None = None) -> dict:
    """base_tpu's two-population recovery on its own catalog (`seeds`:
    {"init", "hmc"}, SEEDS["A"] by default)."""
    from base_tpu_torch.model import multipop as mp

    seeds = seeds or SEEDS["A"]
    model, truth = mp_model(device)
    z0 = mp.ordered_transform(model).inverse(
        torch.as_tensor(truth, device=device))
    init = z0.expand(N_CHAINS_A, -1) + INIT_SD * torch.randn(
        N_CHAINS_A, z0.shape[0], device=device,
        generator=torch.Generator(device=device).manual_seed(seeds["init"]))
    res = run_recovery(model, truth, init, torch.Generator(
        device=device).manual_seed(seeds["hmc"]))
    res.update(stars=int(model.stars.n_stars), binaries=False)
    return res


def seed_sweep(device, seeds) -> list:
    """Case A at other seed pairs (s, s + 1) (init noise, HMC): how often
    a run at base_tpu's settings misses its criteria (the fixed run is
    SEEDS["A"]'s; scripts/multipop_recovery_seeds_jax.py sweeps base_tpu
    alike).  One JSON line a seed."""
    out = []
    for s in seeds:
        res = case_a(device, dict(init=s, hmc=s + 1))
        row = dict(seed=s, ok=all(c["ok"] for c in res["criteria"]),
                   misses=[c["name"] for c in res["criteria"]
                           if not c["ok"]],
                   accept=res["accept"], step_size=res["step_size"],
                   rhat={n: round(p["rhat"], 4)
                         for n, p in res["posterior"].items()},
                   chain_moved=res["chain_moved"], wall_s=res["wall_s"])
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def case_b(device) -> dict:
    """The recovery on chip_smoke's config-4 model at full width, from
    phase 8c's VI warm start."""
    import chip_smoke as cs
    from base_tpu_torch.inference.vi import vi_warm_start
    from base_tpu_torch.model import multipop as mp

    model = cs.make_model4(cs.make_data4(), device)
    tr = mp.ordered_transform(model)
    fz = Counted(mp.make_logpost_z_fn(model, tr))
    z0 = tr.inverse(torch.as_tensor(cs.START4, device=device))
    fz.start(device)
    init, inv_mass0, vres = vi_warm_start(
        fz, z0, torch.Generator(device=device).manual_seed(SEEDS["B"]["vi"]),
        cs.N_CHAINS4, free_mask=mp.free_mask(model))
    vi_res = fz.stop(device)
    check_launches("B: VI", vi_res["launches"], vi_res["evaluations"],
                   model.binaries, device.type == "cuda")
    res = run_recovery(model, cs.TRUTH4, init, torch.Generator(
        device=device).manual_seed(SEEDS["B"]["hmc"]), inv_mass0=inv_mass0)
    res.update(stars=int(model.stars.n_stars), binaries=model.binaries,
               upsample=model.upsample, table_chains=2 * cs.N_CHAINS4,
               vi=dict(vi_res, final_elbo=float(vres.final_elbo)))
    return res


def case_c(device) -> dict:
    """base_tpu's VI check on its own catalog."""
    from base_tpu_torch.inference import vi
    from base_tpu_torch.model import posterior as post

    model, truth = vi_model(device)
    tr = post.default_transform(model)
    fz = Counted(post.make_logpost_z_fn(model, tr))
    z0 = tr.inverse(torch.as_tensor(truth, device=device))
    fz.start(device)
    fit = vi.run_vi(fz, z0, torch.Generator(device=device).manual_seed(
        SEEDS["C"]["vi"]), vi.VIConfig(**VI))
    res = fz.stop(device)
    zs = vi.sample_posterior(fit, torch.Generator(
        device=device).manual_seed(SEEDS["C"]["draws"]), N_DRAWS_C)
    xs = tr.forward(zs)                                   # [500, 9]
    finite = bool(torch.isfinite(xs).all())
    d_age = abs(float(xs[:, 0].double().mean()) - float(truth[0]))
    res.update(stars=int(model.stars.n_stars), binaries=False,
               draws=N_DRAWS_C, final_elbo=float(fit.final_elbo),
               posterior=posterior_table(xs[:, None], VI_PARAMS, truth),
               criteria=[criterion("all draws finite", float(finite),
                                   "1", finite),
                         criterion("|mean age - truth|", d_age,
                                   f"< {AGE_TOL_C}", d_age < AGE_TOL_C)])
    return res


CASES = {"A": case_a, "B": case_b, "C": case_c}


def run_case(name: str, device) -> dict:
    """One case on `device`, its launches checked."""
    device = torch.device(device)
    res = CASES[name](device)
    check_launches(name, res["launches"], res["evaluations"],
                   res["binaries"], device.type == "cuda")
    res.update(case=name, device=str(device), seeds=SEEDS[name],
               ok=all(c["ok"] for c in res["criteria"]))
    return res


def print_case(res: dict) -> None:
    print(json.dumps(res), flush=True)
    print(f"case {res['case']}: wall {res['wall_s']:.3f} s, "
          f"{res['evaluations']} evaluations, launches {res['launches']}")
    if "chain_moved" in res:
        print(f"  each chain's share of draws that moved: "
              f"{res['chain_moved']}")
    for c in res["criteria"]:
        print(f"  {c['name']:24s} {c['value']:.6g} ({c['limit']}) "
              f"{'ok' if c['ok'] else 'MISS'}")
    for n, p in res["posterior"].items():
        print(f"  {n:8s} mean {p['mean']:.5f} sd {p['sd']:.5f} truth "
              f"{p['truth']:.4f} R-hat {p['rhat']:.4f} ESS {p['ess']:.1f}")
    sys.stdout.flush()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=list(CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", nargs="+", type=int, default=None,
                    help="instead of the cases: case A at seed pairs "
                         "(s, s + 1), one line each")
    args = ap.parse_args()
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("torch_slow_checks: no CUDA device (use --device "
                         "cpu)")
    if cuda:
        from base_tpu_torch.ops import build

        t0 = time.perf_counter()
        build.library()
        print(f"kernel build + load: {time.perf_counter() - t0:.3f} s; "
              f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}",
              flush=True)
    if args.seeds:
        rows = seed_sweep(device, args.seeds)
        print(nvidia_smi() if cuda else "cpu")
        print(json.dumps({"case_A_seeds_ok": {r["seed"]: r["ok"]
                                              for r in rows}}))
        return
    results = []
    for name in args.cases:
        res = run_case(name, device)
        results.append(res)
        print_case(res)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    smi = nvidia_smi() if cuda else "cpu"
    with open(os.path.join(out, "slow_checks.json"), "w") as fh:
        json.dump({"cases": results, "card": smi}, fh, indent=1)
    print(smi)
    print(json.dumps({"slow_checks_ok": {r["case"]: r["ok"]
                                         for r in results},
                      "walls_s": {r["case"]: r["wall_s"] for r in results}}))


if __name__ == "__main__":
    main()
