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
5. each kernel's time against its plain version (CUDA events) at both
   shapes, beside its bound: the larger of the operations it needs over the
   card's FP32 peak and the bytes it must move over the HBM rate, counted
   from this run's inputs by the formulas in `kernel_work`;
6. one torch.profiler pass over a few density + gradient calls at each
   shape: the device's busy share and each kernel's share of device time.

The last line is one JSON object with "ok", "device"; the line before it
is the card's name and power limit from nvidia-smi, and the one before
that the per-kernel JSON.  Without a CUDA device it exits non-zero before
printing any result.  It imports nothing of JAX.

    python3 chip_smoke.py --times-only [--root DIR]

runs phases 1 and 5 alone and prints the per-kernel JSON; with --root it
times the base_tpu_torch found under DIR (another checkout), so that two
versions can be compared on one card in one call.
"""
from __future__ import annotations

import argparse
import json
import math
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
# Device function names of each kernel in a profiler trace (kernel 2 was
# one `table_bwd_kernel` before its redesign; --root may time that form).
KERNEL_SYMBOLS = {
    "table_fwd": ("table_fwd_kernel",),
    "table_bwd": ("table_bwd_kernel", "table_bwd_node_kernel",
                  "table_bwd_axis_kernel"),
    "marglik_fwd": ("marglik_fwd_kernel",),
    "marglik_bwd": ("marglik_bwd_kernel",),
}
# Published H100 SXM peaks (dense FP32 outside the tensor cores, HBM3).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


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


def _dev_us(event) -> float:
    """Device time (us) of a profiler key-average entry."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def _kernel_events(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, symbols, reps: int = 20) -> float | None:
    """The kernel's own time on the card per call (ms): torch.profiler's
    mean device time per launch of each kernel named in `symbols`, summed
    over them.  None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_dev_us(e) / e.count for e in _kernel_events(prof)
             if e.count and any(sym in e.key for sym in symbols))
    return us / 1e3 if us > 0 else None


def time_pair(name, kernel, plain) -> tuple[float, float, float | None]:
    """(kernel ms, plain ms, kernel device ms): CUDA events over 20 calls,
    in the order plain, kernel, kernel, plain; then the profiler's device
    time of the kernel alone."""
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    return (0.5 * (k1 + k2), 0.5 * (p1 + p2),
            device_ms(kernel, KERNEL_SYMBOLS[name]))


def time_kernels(model, z) -> dict:
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    table_in, marg_in = kernel_inputs(model, z)
    comb = tb.table_fwd_plain(*table_in)
    g = torch.ones_like(comb)
    out = ml.marglik_fwd_plain(*marg_in)
    gs = torch.ones_like(out)
    return {
        "table_fwd": time_pair("table_fwd",
                               lambda: tb.table_fwd_cuda(*table_in),
                               lambda: tb.table_fwd_plain(*table_in)),
        "table_bwd": time_pair("table_bwd",
                               lambda: tb.table_bwd_cuda(*table_in, g),
                               lambda: tb.table_bwd_plain(*table_in, g)),
        "marglik_fwd": time_pair("marglik_fwd",
                                 lambda: ml.marglik_fwd_cuda(*marg_in),
                                 lambda: ml.marglik_fwd_plain(*marg_in)),
        "marglik_bwd": time_pair(
            "marglik_bwd",
            lambda: ml.marglik_bwd_cuda(*marg_in, out, gs),
            lambda: ml.marglik_bwd_plain(*marg_in, out, gs)),
    }


def kernel_work(model, z) -> dict:
    """{kernel: (flops, bytes)} that each kernel needs on the main path's
    inputs at points z.  Bytes: each input read once, each output written
    once (float32; scratch not counted).  Flops are counted by hand from
    csrc/ (an FMA is 2, a transcendental or a division 1) and, where the
    work depends on the data, over what these inputs need: the table
    kernels over the (node, axis entry) pairs with a non-zero hat weight or
    factor, the marginal kernels over the unmasked segments."""
    from base_tpu_torch.ops import table as tb

    table_in, marg_in = kernel_inputs(model, z)
    app1, m2, _, secT = table_in[:4]
    C, B, N = app1.shape
    E2 = secT.shape[2]
    w, up, dn = tb._weights(m2, *table_in[4:])
    nnz = int(((w != 0) | (up * (1 - up) != 0) | (dn * (1 - dn) != 0))
              .sum())
    S = marg_in[0].shape[0]
    T = marg_in[3].shape[1]
    live = S * int((marg_in[6] > 0.5).sum())        # (chain, star, segment)
    f = 4                                           # bytes per float
    table_io = f * (C * B * N + 2 * C * N + C * B * E2 + 4 * C * E2)
    marg_in_bytes = f * (2 * S * B + S + 2 * C * T * B + 2 * C * T)
    return {
        # Per non-zero entry: 2 ramps + 2 smoothsteps + weight (18), B FMAs;
        # per (node, band): 2 exp, the flux sum, log (8).
        "table_fwd": (nnz * (18 + 2 * B) + 8 * C * B * N,
                      table_io + f * C * B * N),
        # Per non-zero entry: the weight and mags2 again (18 + 2B), dm2
        # (22 + 2B), the node sums (38 + 4B); per (node, band) 15.
        "table_bwd": (nnz * (78 + 8 * B) + 15 * C * B * N,
                      table_io + f * C * B * N + table_io),
        # Per live element: band contraction 11B, core_width and
        # phi_interval_scaled ~100, online update 5.
        "marglik_fwd": (live * (11 * B + 105), marg_in_bytes + f * C * S),
        # Per live element: the forward's 11B + 100, moments and softmax
        # weight ~38, the cotangents 14B.
        "marglik_bwd": (live * (25 * B + 138),
                        marg_in_bytes + f * 2 * C * S
                        + f * (2 * C * T * B + C * T)),
    }


def bound(flops: int, nbytes: int) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops = flops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"


def density_fn(model):
    """log_post + gradient of the model's chains at unconstrained points."""
    from base_tpu_torch.inference.hmc import value_and_grad
    from base_tpu_torch.model import posterior as post

    return value_and_grad(post.make_logpost_z_fn(
        model, post.default_transform(model)))


def device_shares(model, z, label: str, wall_ms: float,
                  calls: int = 5) -> dict:
    """One torch.profiler pass over `calls` density + gradient calls:
    device time per call over `wall_ms` (the call's time without the
    profiler, CUDA events) as the device's busy share, and each kernel's
    share of device time.  Empty when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    vg = density_fn(model)
    for _ in range(2):
        vg(z)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            vg(z)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = _kernel_events(prof)
    busy = sum(_dev_us(e) for e in kernels)
    if busy <= 0:
        log(f"  [{label}] profiler saw no device time: shares not measured")
        return {}
    res = dict(
        label=label,
        wall_ms_per_call=wall_ms,
        wall_ms_per_call_profiled=wall_us / calls / 1e3,
        device_ms_per_call=busy / calls / 1e3,
        busy_share=busy / calls / 1e3 / wall_ms,
        device_kernels_per_call=sum(e.count for e in kernels) / calls,
        kernel_share={
            name: sum(_dev_us(e) for e in kernels
                      if any(sym in e.key for sym in syms)) / busy
            for name, syms in KERNEL_SYMBOLS.items()},
    )
    log("  device shares " + json.dumps(res))
    return res


def density_walls(models: dict, z) -> dict:
    """{label: ms per log_post + gradient call} (CUDA events)."""
    walls = {}
    for label, model in models.items():
        vg = density_fn(model)
        walls[label] = cuda_ms(lambda: vg(z))
        log(f"  log_post + gradient [{label}], {N_CHAINS} chains: "
            f"{walls[label]:.3f} ms")
    return walls


def kernel_report(model, model_up4, z) -> dict:
    """Phase 5: {kernel: times at both shapes, bound, bound_by, share}."""
    times = time_kernels(model, z)
    times_up4 = time_kernels(model_up4, z)
    work = kernel_work(model, z)
    work_up4 = kernel_work(model_up4, z)
    report = {}
    for name in KERNELS:
        ms, plain_ms, dev = times[name]
        ms4, plain_ms4, dev4 = times_up4[name]
        bound_ms, bound_by = bound(*work[name])
        bound_up4, by_up4 = bound(*work_up4[name])
        # Share of bound: over the kernel's own device time where the
        # profiler gives it (back-to-back calls of a short kernel measure
        # the host's dispatch), else over the event time.
        share = bound_ms / (dev or ms)
        share4 = bound_up4 / (dev4 or ms4)
        report[name] = dict(
            ms=ms, plain_ms=plain_ms, device_ms=dev, flops=work[name][0],
            bytes=work[name][1], bound_ms=bound_ms, bound_by=bound_by,
            roofline_share=share, ms_up4=ms4, plain_ms_up4=plain_ms4,
            device_ms_up4=dev4, bound_ms_up4=bound_up4, bound_by_up4=by_up4,
            roofline_share_up4=share4)
        log(f"  {name}: kernel {ms:.4f} ms, device {dev} ms (upsample 4: "
            f"{ms4:.4f}, device {dev4}); plain {plain_ms:.4f} ms "
            f"({plain_ms4:.4f}); bound {bound_ms:.5f} ms by {bound_by} "
            f"({bound_up4:.5f} by {by_up4}); share of bound {share:.4f} "
            f"({share4:.4f})")
    return report


def setup(root: str | None):
    """Phase 1: device, toolchain, kernel build; the config-1 models at
    the bench and upsample-4 shapes and the phase-2 chain points."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA device")
    if root is not None:
        sys.path.insert(0, root)
    from base_tpu_torch.ops import build

    smi = nvidia_smi()
    log(f"nvidia-smi: {smi}")
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__};"
        f" CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.3f} s "
        f"({build.library_path()})")
    ptxas = build.library_path().with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "Used" in line or "Compiling entry" in line:
                log("  " + line.strip())
    dev = torch.device("cuda", 0)
    data = make_data()
    model = make_model(data, dev)
    model_up4 = make_model(data, dev, upsample=4)
    return data, model, model_up4, chain_points(model, 0.05, seed=1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times-only", action="store_true",
                    help="phases 1 and 5 only: build and time the kernels")
    ap.add_argument("--root", default=None,
                    help="time the base_tpu_torch of this checkout instead")
    args = ap.parse_args()
    data, model, model_up4, z = setup(args.root)
    models = {"bench": model, "upsample 4": model_up4}

    if args.times_only:
        log("phase 5: kernel times (CUDA events) and bounds")
        report = kernel_report(model, model_up4, z)
        density_walls(models, z)
        print(json.dumps({"kernels": report}))
        return

    # 2. Kernels vs their plain versions, bench and upsample-4 shapes.
    log("phase 2: kernels vs plain on the card")
    errs = check_kernels(model, z, "bench")
    errs_up4 = check_kernels(model_up4, z, "upsample 4")
    worst = {k: max(errs[k], errs_up4[k]) for k in errs}

    # 3. Density parity against the CPU plain path, and determinism.
    log("phase 3: log_post + gradient, card vs CPU")
    check_density(model, make_model(data, "cpu"), z)

    # 4. HMC, the main path.
    log("phase 4: chunked HMC, 64 chains, dense metric, l_max 48")
    hmc_res = run_hmc(model)

    # 5. Kernel times vs plain and vs their bounds, at both shapes.
    log("phase 5: kernel times (CUDA events) and bounds")
    report = kernel_report(model, model_up4, z)
    walls = density_walls(models, z)

    # 6. Device busy share and kernel shares of device time.
    log("phase 6: torch.profiler, density + gradient")
    for label, m in models.items():
        device_shares(m, z, label, walls[label])

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = report[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=hmc_res["launches"][name], max_abs_err=worst[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            roofline_share=r["roofline_share"], ms_up4=r["ms_up4"],
            device_ms=r["device_ms"], device_ms_up4=r["device_ms_up4"]))
        if not all(math.isfinite(kernels[-1][k]) for k in
                   ("ms", "plain_ms", "bound_ms", "ms_up4")):
            raise AssertionError(f"{name}: a time is not finite")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
