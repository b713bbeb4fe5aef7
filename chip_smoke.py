"""Smoke run of the PyTorch/CUDA port (base_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from base_tpu_torch/csrc (nvcc, sm_90a,
into base_tpu_torch/_build/) and drives the config-1 main path of bench.py
through the port: a 100-star simulated cluster with binaries and the field
mixture, its log posterior and gradient, and dense-metric HMC over 64
chains with step-size jitter and l_max 48.  Phases:

1. the device, the toolchain and the kernel build time;
2. each of the four kernels against its plain PyTorch version on the card,
   at the bench shapes (T = 504, N = 512) and the upsample-4 shapes
   (T = 2016, N = 2024), with the tolerances asserted;
3. log_post and its gradient on 64 chains, kernels on the card against the
   plain path on the CPU, and two card runs compared bit for bit;
4. HMC through make_hmc_chunked_runner, with every kernel's launch count
   taken over this phase alone;
5. each kernel's time against its plain version (CUDA events).

The last line is one JSON object with "ok", "device"; the line before it
is the card's name and power limit from nvidia-smi, and the one before
that the per-kernel JSON.  Without a CUDA device it exits non-zero before
printing any result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32)
FREE = (1, 1, 1, 1, 1, 0, 0, 0, 0)
N_CHAINS, N_STARS, N_EEP, N_Q = 64, 100, 64, 8

# Kernel vs plain on identical inputs: forward max abs error (log-marginals
# only where the value is > -200, where float32 has real precision), and
# gradients after scaling by the plain gradient's max.
FWD_TOL = 1e-4
GRAD_TOL = 1e-3
# The marginal's float32 floor: at the bench shapes segments span alpha ~
# 8e3, and gamma - beta^2/alpha cancels ~7e3 down to O(10), so every float32
# evaluation of the formula (kernel, plain on the card, plain on the CPU)
# sits ~1.5e-3 from a float64 one, forward and backward.  The marginal
# kernels are held to MARGLIK_TOL against the plain version and against
# the plain version run in float64.
MARGLIK_TOL = 5e-3
# Whole density, kernels on the card vs plain path on the CPU: different
# sum orders and FMA contraction on magnitudes ~20 with sigmas ~0.01.
DENSITY_REL_TOL = 1e-4     # |d log_post| / max(1, |log_post|)
DENSITY_GRAD_TOL = 2e-3    # per-chain max |d grad| / max |grad|

KERNELS = {
    "table_fwd": ("base_tpu_torch/csrc/table.cu",
                  "base_tpu/ops/pallas_table.py:83"),
    "table_bwd": ("base_tpu_torch/csrc/table.cu",
                  "base_tpu/ops/pallas_table.py:93"),
    "marglik_fwd": ("base_tpu_torch/csrc/marglik.cu",
                    "base_tpu/ops/pallas_marglik.py:174"),
    "marglik_bwd": ("base_tpu_torch/csrc/marglik.cu",
                    "base_tpu/ops/pallas_marglik.py:217"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def make_data():
    """Config-1 photometry (bench.py:70-94) through the port's simulator
    and noise model, on the CPU from fixed seeds."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    grid = synthetic.make_grid(n_eep=N_EEP, device="cpu")
    gen = torch.Generator().manual_seed(0)
    cat = simulate_cluster(grid, torch.as_tensor(TRUTH), N_STARS, gen,
                           percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    return sc.mags.numpy(), sc.sigmas.numpy()


def make_model(data, device, upsample=1):
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars

    grid = synthetic.make_grid(n_eep=N_EEP, device=device)
    stars = make_ms_stars(*data, cm_prior=0.99, device=device)
    return post.make_single_pop_model(grid, stars, TRUTH, PRIOR_SIGMA,
                                      n_q=N_Q, upsample=upsample,
                                      device=device)


def chain_points(model, spread: float, seed: int) -> torch.Tensor:
    """[C, 9] unconstrained points: chain 0 at the truth, the rest
    scattered around it in the free dims."""
    from base_tpu_torch.model import posterior as post

    tr = post.default_transform(model)
    dev = tr.lo.device
    z0 = tr.inverse(torch.as_tensor(TRUTH, device=dev))
    gen = torch.Generator().manual_seed(seed)
    noise = spread * torch.randn(N_CHAINS, 9, generator=gen).to(dev)
    noise[0] = 0.0
    return z0 + noise * torch.as_tensor(FREE, dtype=torch.float32,
                                        device=dev)


def kernel_inputs(model, z):
    """The kernels' inputs as the main path builds them at points z."""
    from base_tpu_torch.grids.isochrone import (derive_isochrone,
                                                upsample_isochrone)
    from base_tpu_torch.model import likelihood as lk
    from base_tpu_torch.model import posterior as post

    x = post.default_transform(model).forward(z)
    base = derive_isochrone(model.grid, x[:, 2], x[:, 1], x[:, 0])
    iso = upsample_isochrone(base, model.upsample)
    args = (iso, model.q_grid, x[:, 3], x[:, 4], model.abs_coefs)
    table_in = lk.fused_table_inputs(*args, sec_iso=base)
    table = lk.build_segment_table_fused(*args, sec_iso=base)
    st = model.stars
    marg_in = (st.obs_mags, st.inv_var, st.log_norm, table.lo, table.hi,
               table.logw, table.mask.float())
    return table_in, marg_in


def grad_errs(names, got, want) -> tuple[float, float, str]:
    """(max abs error, max scaled error, per-output report) over the
    gradient outputs; scaled = abs error / max |plain output|."""
    abs_e, scaled, report = 0.0, 0.0, []
    for n, a, b in zip(names, got, want):
        e = float((a - b).abs().max())
        s = e / max(float(b.abs().max()), 1e-30)
        abs_e, scaled = max(abs_e, e), max(scaled, s)
        report.append(f"{n} {e:.2e}/{s:.2e}")
    return abs_e, scaled, " ".join(report)


def check_kernels(model, z, label: str) -> dict:
    """Each kernel against its plain version on the same CUDA inputs;
    returns {kernel: max abs error} and raises past the tolerances."""
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    table_in, marg_in = kernel_inputs(model, z)
    gen = torch.Generator(device=z.device).manual_seed(7)
    abs_errs, checked = {}, {}

    comb_k = tb.table_fwd_cuda(*table_in)
    comb_p = tb.table_fwd_plain(*table_in)
    abs_errs["table_fwd"] = checked["table_fwd"] = float(
        (comb_k - comb_p).abs().max())
    g = torch.randn(comb_p.shape, generator=gen, device=z.device)
    abs_errs["table_bwd"], checked["table_bwd"], report = grad_errs(
        ("dapp1", "dm2", "dlit", "dsecT", "dxl", "dinv_dl", "dxr",
         "dinv_dr"),
        tb.table_bwd_cuda(*table_in, g), tb.table_bwd_plain(*table_in, g))
    log(f"  [{label}] table N={comb_p.shape[2]}: fwd max|err| "
        f"{checked['table_fwd']:.3e}; bwd abs/scaled {report}")

    out_k = ml.marglik_fwd_cuda(*marg_in)
    out_p = ml.marglik_fwd_plain(*marg_in)
    marg64 = tuple(t.double() for t in marg_in)
    out_64 = ml.marglik_fwd_plain(*marg64)
    sel = out_p > -200
    abs_errs["marglik_fwd"] = checked["marglik_fwd"] = float(
        (out_k - out_p).abs()[sel].max())
    f64 = {"marglik_fwd": (float((out_k - out_64).abs()[sel].max()),
                           float((out_p - out_64).abs()[sel].max()))}
    gs = torch.randn(out_p.shape, generator=gen, device=z.device)
    bwd_k = ml.marglik_bwd_cuda(*marg_in, out_p, gs)
    bwd_p = ml.marglik_bwd_plain(*marg_in, out_p, gs)
    bwd_64 = ml.marglik_bwd_plain(*marg64, out_64, gs.double())
    names = ("dlo", "dhi", "dlogw")
    abs_errs["marglik_bwd"], checked["marglik_bwd"], report = grad_errs(
        names, bwd_k, bwd_p)
    f64["marglik_bwd"] = (grad_errs(names, bwd_k, bwd_64)[1],
                          grad_errs(names, bwd_p, bwd_64)[1])
    log(f"  [{label}] marglik T={marg_in[3].shape[1]}: fwd max|err| "
        f"{checked['marglik_fwd']:.3e} ({int(sel.sum())}/{sel.numel()} "
        f"values > -200); bwd abs/scaled {report}")
    for name, (k64, p64) in f64.items():
        log(f"  [{label}] {name} vs float64: kernel {k64:.3e}, "
            f"plain float32 {p64:.3e}")
        if not k64 <= MARGLIK_TOL:
            raise AssertionError(f"{name} [{label}]: {k64:.3e} from float64")

    for name, err in checked.items():
        tol = (MARGLIK_TOL if name.startswith("marglik")
               else FWD_TOL if name.endswith("fwd") else GRAD_TOL)
        if not err <= tol:
            raise AssertionError(f"{name} [{label}]: error {err:.3e} > {tol}")
    return abs_errs


def check_density(model_gpu, model_cpu, z) -> None:
    """log_post + gradient: card kernels vs the CPU plain path, then two
    card runs bit for bit."""
    from base_tpu_torch.inference.hmc import value_and_grad
    from base_tpu_torch.model import posterior as post

    def vg(model):
        return value_and_grad(post.make_logpost_z_fn(
            model, post.default_transform(model)))

    lp_g, g_g = vg(model_gpu)(z)
    lp_c, g_c = vg(model_cpu)(z.cpu())
    rel = ((lp_g.cpu() - lp_c).abs() / lp_c.abs().clamp_min(1.0)).max()
    gerr = ((g_g.cpu() - g_c).abs().amax(1)
            / g_c.abs().amax(1).clamp_min(1e-30)).max()
    log(f"  log_post [{lp_c.min():.3f}, {lp_c.max():.3f}]: max rel err "
        f"{rel:.3e}, max abs err {(lp_g.cpu() - lp_c).abs().max():.3e}; "
        f"gradient scaled err {gerr:.3e}")
    if not (torch.isfinite(lp_g).all() and torch.isfinite(g_g).all()):
        raise AssertionError("non-finite density or gradient on the card")
    if not (rel <= DENSITY_REL_TOL and gerr <= DENSITY_GRAD_TOL):
        raise AssertionError("card density disagrees with the CPU path")
    lp2, g2 = vg(model_gpu)(z)
    same = torch.equal(lp_g, lp2) and torch.equal(g_g, g2)
    log(f"  two card runs bit-identical: {same}")
    if not same:
        raise AssertionError("card density + gradient not deterministic")


def launch_counts() -> dict:
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    return {"table_fwd": tb.table_fwd_launches,
            "table_bwd": tb.table_bwd_launches,
            "marglik_fwd": ml.marglik_fwd_launches,
            "marglik_bwd": ml.marglik_bwd_launches}


def reset_launch_counts() -> None:
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    tb.table_fwd_launches = tb.table_bwd_launches = 0
    ml.marglik_fwd_launches = ml.marglik_bwd_launches = 0


def run_hmc(model) -> dict:
    """The main path: chunked dense-metric HMC on the card."""
    from base_tpu_torch.inference import diagnostics as diag
    from base_tpu_torch.inference.driver import make_hmc_chunked_runner
    from base_tpu_torch.inference.hmc import HMCConfig
    from base_tpu_torch.model import posterior as post

    cfg = HMCConfig(n_warmup=128, n_samples=128, l_max=48, n_windows=4,
                    dense_mass=True, free_mask=FREE, jitter_mode="step")
    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    dev = tr.lo.device
    z0 = tr.inverse(torch.as_tensor(TRUTH, device=dev))
    init = z0 + 0.02 * torch.randn(
        N_CHAINS, 9, generator=torch.Generator().manual_seed(2)).to(dev)
    runner = make_hmc_chunked_runner(fz, cfg, chunk_draws=64)
    gen = torch.Generator(device=dev).manual_seed(4)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs, info = runner(init, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    xs = tr.forward(zs)                                  # [N, C, 9]
    accept = float(info["accept_prob"])
    evals = (cfg.n_warmup + cfg.n_samples) * cfg.l_max * N_CHAINS
    res = dict(
        wall_s=wall,
        evals_per_s=evals / wall,
        accept=accept,
        step_size=float(info["step_size"]),
        ess_age=float(diag.ess(xs[:, :, :1])[0]),
        rhat_age=float(diag.split_rhat(xs[:, :, :1])[0]),
        mean_age=float(xs[:, :, 0].mean()),
        sd_age=float(xs[:, :, 0].std()),
        launches=counts,
    )
    log("  " + json.dumps(res))
    if not torch.isfinite(zs).all():
        raise AssertionError("non-finite HMC samples")
    if not 0.0 < accept < 1.0:
        raise AssertionError(f"acceptance {accept} outside (0, 1)")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    # The simulated truth is recovered: age within 0.15 dex (posterior sd
    # ~0.03 at 100 stars) and the chains mixed.
    if not (abs(res["mean_age"] - TRUTH[0]) < 0.15 and res["rhat_age"] < 1.1):
        raise AssertionError("HMC posterior misses the simulated truth")
    return res


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def time_kernels(model, z) -> dict:
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    table_in, marg_in = kernel_inputs(model, z)
    comb = tb.table_fwd_plain(*table_in)
    g = torch.ones_like(comb)
    out = ml.marglik_fwd_plain(*marg_in)
    gs = torch.ones_like(out)
    return {
        "table_fwd": time_pair(lambda: tb.table_fwd_cuda(*table_in),
                               lambda: tb.table_fwd_plain(*table_in)),
        "table_bwd": time_pair(lambda: tb.table_bwd_cuda(*table_in, g),
                               lambda: tb.table_bwd_plain(*table_in, g)),
        "marglik_fwd": time_pair(lambda: ml.marglik_fwd_cuda(*marg_in),
                                 lambda: ml.marglik_fwd_plain(*marg_in)),
        "marglik_bwd": time_pair(
            lambda: ml.marglik_bwd_cuda(*marg_in, out, gs),
            lambda: ml.marglik_bwd_plain(*marg_in, out, gs)),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA device")
    from base_tpu_torch.ops import build

    # 1. Device, toolchain, kernel build.
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"nvidia-smi: {smi}")
    log(f"device: {kind}; torch {torch.__version__}; CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.3f} s "
        f"({build.library_path().name})")
    ptxas = build.library_path().with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                log("  " + line.strip())

    dev = torch.device("cuda", 0)
    data = make_data()
    model = make_model(data, dev)
    model_up4 = make_model(data, dev, upsample=4)

    # 2. Kernels vs their plain versions, bench and upsample-4 shapes.
    log("phase 2: kernels vs plain on the card")
    z = chain_points(model, 0.05, seed=1)
    errs = check_kernels(model, z, "bench")
    errs_up4 = check_kernels(model_up4, z, "upsample 4")
    worst = {k: max(errs[k], errs_up4[k]) for k in errs}

    # 3. Density parity against the CPU plain path, and determinism.
    log("phase 3: log_post + gradient, card vs CPU")
    check_density(model, make_model(data, "cpu"), z)

    # 4. HMC, the main path.
    log("phase 4: chunked HMC, 64 chains, dense metric, l_max 48")
    hmc_res = run_hmc(model)

    # 5. Kernel times vs plain at the bench shapes.
    log("phase 5: times at the bench shapes (CUDA events)")
    times = time_kernels(model, z)
    from base_tpu_torch.inference.hmc import value_and_grad
    from base_tpu_torch.model import posterior as post

    vg = value_and_grad(post.make_logpost_z_fn(model,
                                               post.default_transform(model)))
    density_ms = cuda_ms(lambda: vg(z))
    log(f"  log_post + gradient, {N_CHAINS} chains: {density_ms:.3f} ms")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = times[name]
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=hmc_res["launches"][name],
                            max_abs_err=worst[name], ms=ms,
                            plain_ms=plain_ms))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
