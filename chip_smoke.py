"""Smoke run of the PyTorch/CUDA port (base_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from base_tpu_torch/csrc (nvcc, sm_90a,
into base_tpu_torch/_build/) and drives the port's paths.
Config 1 is the main path of bench.py: a 100-star simulated cluster with
binaries and the field mixture, its log posterior and gradient, and
dense-metric HMC over 64 chains with step-size jitter and l_max 48.
Phases:

1. the device, the toolchain and the kernel build time;
2. each of the four kernels against its plain PyTorch version on the card,
   at the bench shapes (T = 504, N = 512) and the upsample-4 shapes
   (T = 2016, N = 2024), with the tolerances asserted;
3. log_post and its gradient on 64 chains, kernels on the card against the
   plain path on the CPU, and two card runs compared bit for bit;
4. HMC through make_hmc_chunked_runner (48 + 32 draws), with every
   kernel's launch count taken over this phase alone;
5. each kernel's time against its plain version (CUDA events) at both
   shapes, and its device time (`device_ms`: CUDA events around launches
   queued behind a sleep kernel), beside its bound: the larger of the
   operations it needs over the card's FP32 peak and the bytes it must
   move over the HBM rate, counted from this run's inputs by the formulas
   in `kernel_work`;
6. one torch.profiler pass over a few density + gradient calls at each
   shape: the device's busy share and each kernel's share of device time.

Config 3 (BASELINE.json config 3, benchmarks/wd_ifmr_tpu.py's settings) is
the white-dwarf path: 512 simulated stars of which ~40 are WDs, a tunable
linear IFMR, eight free parameters, upsample 4 and 96 precursor-mass nodes,
16 chains.  Its WD marginal runs through kernels 3 and 4 on a concatenated
DA + DB segment table (T = 190), so they launch twice per evaluation.
Phases 7a-7e (`run_config3`): 7a kernels 3 and 4 against their plain
versions at its MS and WD shapes, a fully masked WD chain among them; 7b
log_post and its gradient, card against CPU, and bit for bit; 7c chunked
HMC, 24 + 8 draws (launches counted over this phase alone); 7d
sample_wd_masses on thinned draws against the simulated ZAMS masses; 7e
the density's wall and device time per call, its busy share, and kernels
3 and 4 at the WD shapes against their bound.

Config 4 (BASELINE.json config 4, benchmarks/multipop_tpu.py's settings)
is the two-population helium-spread path: 400 stars, 60% at Y_A = 0.25 and
40% at Y_B = 0.30, every one a binary, twelve parameters through the
ordered (Y_A < Y_B) transform, 32 chains.  Both populations run in one pass
of the density on a doubled chain axis, so each kernel launches once per
evaluation on 64 table chains.  Phases 8a-8e (`run_config4`): 8a the four
kernels against their plain versions at its shapes (S = 400, T = 2016, 64
table chains), and the folded launch against two per-population launches
bit for bit; 8b log_post and its gradient, card against CPU, bit for bit,
and the label swap (Y_A, Y_B, lambda) -> (Y_B, Y_A, 1 - lambda); 8c
vi_warm_start, then chunked HMC from its draws and covariance, with every
kernel's launches held equal to the density evaluations; 8d adaptive MH on
64 chains; 8e the density's wall and device time per call, its busy
share, the folded pass against two passes, and the four kernels at the
config-4 shapes against their bound.

Phase 9 is config 1 under NUTS (benchmarks/nuts_vs_hmc_tpu.py's settings,
`run_nuts_config1`): phase 4's model and 64 chains, dense metric, the flat
dims pinned, max_depth 7, 128 + 48 draws through make_nuts_chunked_runner;
every leaf one density call on all chains, every kernel's launches held
equal to the density calls, split R-hat of the age < 1.1 and its mean
within 4 sd of the truth, beside phase 4's HMC.

Config 2 (BASELINE.json config 2, benchmarks/field_membership_tpu.py's
settings, `run_config2`) is field-star membership: 200 members, every one a
binary, plus 40 uniform-CMD field stars at membership priors 0.9 / 0.3,
upsample 4.  Phase 10a: chunked HMC on 32 chains (32 + 8 draws), launches
equal to the density calls; 10b: sample_ms_masses on every 16th draw, the
membership posterior of 8 draws against the CPU plain path, and the
members-vs-field AUC (>= 0.95).

Config 5's single-card leg (BASELINE.json config 5,
benchmarks/smc_10k_tpu.py's recipe, `run_config5`) is 10 000 stars at
upsample 4.  Phase 11a: full-rank VI, 600 steps; 11b: tempered SMC from the
VI Gaussian inflated 2x, 2 replicates x 512 particles (the benchmark runs
4 x 1024) folded into 1024 rows a density call, n_move 3, max_stages 30:
kernels 1 and 3 once per call, kernels 2 and 4 only in VI, every replicate
at beta = 1, the log-evidence +- SE, the age within AGE_TOL5 (0.03 dex)
of the truth, the peak memory; 11c: kernels 1 and 3 against plain on 4 of the 1024 rows
at S = 10 000 (the plain [rows, S, T, B] tensors hold 0.65 GB a row),
kernels 2 and 4 on VI's 8 rows (kernel 4's plain version on 2), and their
times beside their bounds at both shapes.  11d (`run_longaxis5`) is config
5's long-axis path (benchmarks/longaxis_10k_converged.py's recipe, cut to
16 + 8 transitions): 16 chains from 11a's VI draws, the warmup metric
from its covariance, dense HMC with step jitter, l_max 24 and chain_chunk
8, so each density evaluation is two calls of 8 rows and every kernel
launches twice an evaluation (held exactly, the evaluations counted from
the calls' rows); finite draws, acceptance > 0; the run with chain_chunk
against the run without over 2 transitions from one generator state (bit
for bit, else within CHUNK_REL_TOL; it prints which held); kernels 1-4
against plain on a block of its final draws; one call's peak memory and
time with chain_chunk and without, and the age beside 11a's and 11b's.

Phase 12 (`run_cli`) drives the port's CLI, `base_tpu_torch.tools.main`,
in-process (so the wrappers' launch counters see it) at the widths of
conf/base9.yaml: 100 stars, 30% binaries, UBVRIJHK, nMassRatio 16, upsample
4, 64 chains, dense metric, cut in depth (16 + 16 draws a chain, lMax
24).  12a: simulate -> scatter; the model the CLI builds from that
.phot (n_q 16, upsample 4, 4 WDs) at its 64 chains, each kernel against
its plain version (kernels 3-4 on the MS and the WD tables), and log_post
+ gradient on 16 of those chains against the CPU plain path; single-pop
--metrics, every kernel's launches held to the density calls the CLI
counted (kernels 3-4 once per segment table: twice with the simulated
WDs), 1024 finite .res rows, the age within 4 sd of the truth; 12b:
sample-mass; 12c: make-cmd on the card and through `python -m
base_tpu_torch.tools.main make-cmd --device cpu` in a subprocess, within
CMD_TOL; 12d: run_hmc_checkpointed on the CLI's model
interrupted after chunk 1 and resumed, bit for bit against an
uninterrupted run, the CUDA generator's state included.

Phase 13 (`run_wide`) is the wide band set through the grid ingest.  13a:
the port's writers put upstream-format text grids in a directory
(conf/base9.yaml's MS family on its synthetic axis spans in all 29 bands of
grids/filters.py, carbonicity-resolved WD cooling tracks, Bergeron DA/DB
tables in the same bands); `python -m base_tpu_torch.tools.main
convert-models --src --dst` packs them (subprocess); a table is read back
through io.native (the library must load: no numpy fallback) and rows go
out through its AsyncWriter.  13b: simulate -> scatter -> single-pop
--metrics at conf/base9.yaml's widths on those grids with B = 29, cut to
16 + 16 draws a chain; the CLI's model checked as in 12a (kernels 1-4
against plain at B = 29 on its 64 chains, density against the CPU on 16);
every kernel's launches held to the density calls (kernels 3m/4m never),
the age within 4 sd of the truth; kernels 1-4 timed at B = 29 beside their bounds.
13c: the matmul form (kernels 3m and 4m, `fused_log_marginals(...,
matmul=True)`) against its plain version (MARGLIK_TOL) and the float64
residual form at the bench shapes (B = 8) and on 13b's MS table (B = 29),
64 chains at each of MM_SEEDS, with kernels 3 and 4 (the residual form) in
their place as a control that must fail the same gate; its own path
(value + gradient calls, launches counted over it alone), and the device
ms of both forms at both widths beside their bounds.

Phase 14 (`run_parallel`) is the parallel layer, base_tpu_torch.parallel.
14a: a world of one in this process (NCCL, by the backend rule), mesh 1
x 1 on cuda:0: local_logpost_fn's value and gradient on phase 4's model
and chains equal the unsharded card density bit for bit, its kernels
launched once a call; run_hmc_sharded (phase 4's settings, l_max 8, 16 +
16) equals run_hmc given the chain-shard-0 generator, bit for bit, with
every kernel's launches equal to the density calls.  14c: simulate ->
scatter -> `single-pop --mesh 1,2 --metrics` at phase 12's settings (the
CLI spawns two ranks on the card), 1024 finite rows, the age within 4 sd
of the truth.  14b: two ranks spawned on the one card (gloo: they share
it), at meshes (1, 2) and (2, 1): the sharded density and gradient
against the unsharded card density (SHARD_VALUE_RTOL, and
SHARD_GRAD_RTOL / SHARD_GRAD_ATOL: tests/test_parallel.py's bounds) on
config 1 with 100 stars and with 99 (padded to 100), the value at config
5's 10 000 stars on 1024 rows and the gradient on 8; sharded HMC on
config 1 (each rank's launches equal to its density calls, every chain
moving, the recorded logposts the unsharded density at the draws, the
age within 4 sd, the two ranks' draws bit-identical); and at (1, 2) the
CLI model's sharded checkpointed HMC interrupted after chunk 1 and
resumed, bit for bit against an uninterrupted run.  Each run prints its
backend, world size, wall and density calls per second.

Phase 15 (`run_golden`) holds the port to base_tpu's pinned posterior
(tests/data/golden_singlepop.json, tests/test_goldens.py): the golden
model (64 stars that base_tpu simulated from JAX's streams, read from
tests/data/golden_singlepop_stars.json; the conftest small grid's axes,
E = 48; n_q 8) built with the port's API (`golden_model`).  15a: log_post
at the truth within GOLDEN_RTOL (1e-4) of the golden 871.7948 and within
DENSITY_REL_TOL of the CPU plain path; kernels 1-4 against their plain
versions on 64 chains of this model, and the density and gradient on 16
of them against the CPU.  15b: test_goldens.py's adaptive MH (4 chains,
400 + 400 + 2000 steps, its step0), kernels 1 and 3 launched once a
density call; each free parameter's mean and sd held to the golden's by
test_goldens.py:70-77's rule, beside the accept rate (golden 0.427),
split R-hat, ESS and a z against the golden mean (reported only).  15c:
the main path's HMC (run_hmc: 64 chains, dense metric, step jitter,
l_max 48, N_WARMUP15 + N_SAMPLES15), every kernel launched once a density
call, held to the golden by the same rule, with split R-hat, ESS and z
for each free parameter.

Phase 16 (`run_sbc`) is the simulation-based calibration (SBC) path,
the port's counterpart of base_tpu's vmap over data sets
(tests/test_calibration.py; scripts/torch_sbc.py runs its three checks
whole): models over base_tpu's 64 SBC data sets (tests/data/sbc_stars.npz)
as star sets, one chain a set.  16a: kernels 3-4 over star sets against
their plain versions (MARGLIK_TOL) at G = C = 64 (32 stars, no binaries)
and at G = 8 with 8 chains a set (20 stars, binaries, n_q 8), against
one-set launches on a set's chains and at G = 1 against the one-set
kernel, both bit for bit; their times beside the one-set form's and their
bound.  16b: the stacked density against the CPU plain path.  16c:
run_hmc(replicas=64) on the binaries model (N_WARMUP16 + N_SAMPLES16,
l_max L_MAX16) and adaptive MH on the MS model (MH16), each run again with
one set's stars moved: finite draws, one launch of each kernel the path
runs per evaluation, and every other replica's draws bit for bit the
same.  Phases 12a's, 13b's and 14c's single-pop runs take l_max 24
(conf/base9.yaml's 48 until phase 16 joined).

Every profiler pass (phases 6, 7e and 8e) is padded with idle host time
(PROFILE_PAD_S) and must hold the records of at least 99% of the launches
that the kernel wrappers counted in it.

Each phase's wall is logged as it ends (`PhaseClock`).

The last line is one JSON object with "ok", "device"; the line before it
is the card's name and power limit from nvidia-smi, and the one before
that the per-kernel JSON (config 3's launches and WD-shape numbers,
config 4's launches and times at its shapes, the launches of phases 9, 10,
11a-11b, 11d (`launches_config5_longaxis`), 12 (`launches_cli`) and 13
(`launches_wide`), the times and bounds at
config 5's SMC and VI shapes and at B = 29 (`b29`), as extra fields;
kernels 3m and 4m have rows of their own; `launches_parallel`: phase
14's HMC; `launches_golden`: phase 15's MH and HMC; `launches_sbc`:
phase 16c's HMC and MH; kernels 3-4's `sbc`: 16a's times at the SBC
shapes), before that the `sbc` JSON of phase 16 with every phase's wall,
the `golden` JSON of phase 15, the `parallel` JSON of phase 14, the `wide`
JSON of
phase 13, and before that the `cli` JSON of phase 12 (each tool's wall,
single-pop's samples/s, evals/s, density calls and ESS/s of the age).
Without a CUDA device it exits non-zero before printing any result.  It
imports nothing of JAX.

    python3 chip_smoke.py --times-only [--root DIR]

runs phases 1, 5 and 6 alone and prints the density calls' JSON (phase
6's profiler pass: wall and device ms per call, device kernels per call)
and the per-kernel JSON; with --root it
times the base_tpu_torch found under DIR (another checkout), so that two
versions can be compared on one card in one call.  With --save-outputs
PATH it also saves kernels 1 and 4's inputs and outputs at both shapes,
and with --against PATH it runs this checkout's kernels 1 and 4 on the
saved inputs and reports whether the outputs are bit-identical.

Phase 5 also reports kernel 4's skip rules on these inputs: the share of
(chain, star, 32-segment group) pairs the group rule marks, the share of
live elements the element rule marks, and the share of pairs in which no
element needs the full path.
"""
from __future__ import annotations

import argparse
import dataclasses
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
# Phase 4's run: 64 + 64 transitions until phase 15 joined (split R-hat of
# the age 1.036 after 64 draws on an H100).
N_WARMUP_MAIN, N_SAMPLES_MAIN = 48, 32

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
# The matmul form of kernels 3 and 4 (fused_log_marginals(..., matmul=True),
# base_tpu's `_abg_matmul` branch of `_fwd_kernel` and the five products of
# `_bwd_kernel`'s): no main path takes it, phase 13c drives it alone.
MM_KERNELS = {
    "marglik_mm_fwd": ("base_tpu_torch/csrc/marglik_mm.cu",
                       "base_tpu/ops/pallas_marglik.py:107"),
    "marglik_mm_bwd": ("base_tpu_torch/csrc/marglik_mm.cu",
                       "base_tpu/ops/pallas_marglik.py:261"),
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


def chain_points(model, spread: float, seed: int, truth=TRUTH,
                 n_chains: int = N_CHAINS, free=FREE) -> torch.Tensor:
    """[C, 9] unconstrained points: chain 0 at the truth, the rest
    scattered around it in the free dims."""
    from base_tpu_torch.model import posterior as post

    tr = post.default_transform(model)
    dev = tr.lo.device
    z0 = tr.inverse(torch.as_tensor(truth, device=dev))
    gen = torch.Generator().manual_seed(seed)
    noise = spread * torch.randn(n_chains, 9, generator=gen).to(dev)
    noise[0] = 0.0
    return z0 + noise * torch.as_tensor(free, dtype=torch.float32,
                                        device=dev)


def transform(model):
    """The model's sampling transform: default_transform for a single
    population, the ordered (Y_A < Y_B) transform for two."""
    from base_tpu_torch.model import multipop as mp
    from base_tpu_torch.model import posterior as post

    if isinstance(model, mp.MultiPopModel):
        return mp.ordered_transform(model)
    return post.default_transform(model)


def logpost_z_fn(model):
    """The model's density at unconstrained points, z [C, P] -> [C]."""
    from base_tpu_torch.model import multipop as mp
    from base_tpu_torch.model import posterior as post

    mod = mp if isinstance(model, mp.MultiPopModel) else post
    return mod.make_logpost_z_fn(model, transform(model))


def model_rows(model, z):
    """The 9-parameter rows [R, 9] that one pass of the density evaluates
    at unconstrained points z [C, P]: the chains (R = C), or for two
    populations both of them folded on the chain axis (R = 2C, rows :C at
    Y_A and C: at Y_B)."""
    from base_tpu_torch.model import multipop as mp

    x = transform(model).forward(z)
    return mp.population_params(x) if isinstance(model, mp.MultiPopModel) \
        else x


def kernel_inputs(model, z):
    """The kernels' inputs as the main path builds them at points z."""
    from base_tpu_torch.grids.isochrone import (derive_isochrone,
                                                upsample_isochrone)
    from base_tpu_torch.model import likelihood as lk

    x = model_rows(model, z)
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


def chain_block(marg_in, c0: int, c1: int) -> tuple:
    """Kernels 3-4's inputs for chains c0..c1-1: the tables' rows and, for
    star sets ([G, S, B]: chain c on set c // (C // G); c0 and c1 on set
    boundaries), those chains' sets."""
    C = marg_in[3].shape[0]
    stars = marg_in[:3]
    if marg_in[0].ndim == 3:
        k = C // marg_in[0].shape[0]
        if c0 % k or (c1 < C and c1 % k):
            raise ValueError(f"chains {c0}..{c1} split a star set of {k}")
        stars = tuple(t[c0 // k:-(-c1 // k)] for t in stars)
    return (*stars, *(t[c0:c1] for t in marg_in[3:]))


def block_step(marg_in, per_block: float) -> int:
    """Chains a block so that a [block, S, T, B] tensor holds about
    `per_block` elements, a whole number of star sets."""
    S, B = marg_in[0].shape[-2:]
    C, T = marg_in[3].shape[:2]
    k = C // marg_in[0].shape[0] if marg_in[0].ndim == 3 else 1
    return max(1, int(per_block // (S * T * B * k))) * k


def plain_blocks(fn, marg_in, *per_chain):
    """A plain marginal version `fn` on blocks of chains of `marg_in`
    (with `per_chain` tensors, such as out and g, cut alike), its outputs
    joined along the chain axis: the float64 residual form holds [C, S, T,
    B] tensors, 0.11 GB a chain at B = 29 and T = 5056."""
    step = block_step(marg_in, PLAIN_BLOCK_BYTES / 8)
    outs = []
    for c0 in range(0, marg_in[3].shape[0], step):
        rows = slice(c0, c0 + step)
        outs.append(fn(*chain_block(marg_in, c0, c0 + step),
                       *(t[rows] for t in per_chain)))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def check_marglik(marg_in, label: str) -> dict:
    """Kernels 3 and 4 against their plain versions (and the plain version
    in float64) on the same CUDA inputs; returns ({kernel: max abs error},
    {kernel: checked error}) and raises past MARGLIK_TOL."""
    from base_tpu_torch.ops import marglik as ml

    gen = torch.Generator(device=marg_in[0].device).manual_seed(7)
    abs_errs, checked = {}, {}
    out_k = ml.marglik_fwd_cuda(*marg_in)
    out_p = plain_blocks(ml.marglik_fwd_plain, marg_in)
    marg64 = tuple(t.double() for t in marg_in)
    out_64 = plain_blocks(ml.marglik_fwd_plain, marg64)
    sel = out_p > -200
    abs_errs["marglik_fwd"] = checked["marglik_fwd"] = float(
        (out_k - out_p).abs()[sel].max())
    f64 = {"marglik_fwd": (float((out_k - out_64).abs()[sel].max()),
                           float((out_p - out_64).abs()[sel].max()))}
    gs = torch.randn(out_p.shape, generator=gen, device=out_p.device)
    bwd_k = ml.marglik_bwd_cuda(*marg_in, out_p, gs)
    bwd_p = plain_blocks(ml.marglik_bwd_plain, marg_in, out_p, gs)
    bwd_64 = plain_blocks(ml.marglik_bwd_plain, marg64, out_64, gs.double())
    names = ("dlo", "dhi", "dlogw")
    abs_errs["marglik_bwd"], checked["marglik_bwd"], report = grad_errs(
        names, bwd_k, bwd_p)
    f64["marglik_bwd"] = (grad_errs(names, bwd_k, bwd_64)[1],
                          grad_errs(names, bwd_p, bwd_64)[1])
    C, T = marg_in[3].shape[:2]
    sets = f" G={marg_in[0].shape[0]}" if marg_in[0].ndim == 3 else ""
    log(f"  [{label}] marglik C={C}{sets} S={marg_in[0].shape[-2]} T={T}: "
        f"fwd "
        f"max|err| {checked['marglik_fwd']:.3e} ({int(sel.sum())}/"
        f"{sel.numel()} values > -200); bwd abs/scaled {report}")
    for name, (k64, p64) in f64.items():
        log(f"  [{label}] {name} vs float64: kernel {k64:.3e}, "
            f"plain float32 {p64:.3e}")
        if not k64 <= MARGLIK_TOL:
            raise AssertionError(f"{name} [{label}]: {k64:.3e} from float64")
    # A chain with no live segment: exactly NEG_INF + log_norm, and no
    # gradient at all.
    dead = (marg_in[6] <= 0.5).all(1)
    if dead.any():
        ln = (ml.chain_rows(marg_in[2], C) if marg_in[2].ndim == 2
              else marg_in[2].expand(C, -1))
        if not torch.equal(out_k[dead], ml.NEG_INF + ln[dead]):
            raise AssertionError(f"[{label}] masked chain's marginal")
        if not all(bool((d[dead] == 0).all()) for d in bwd_k):
            raise AssertionError(f"[{label}] masked chain's gradient")
        log(f"  [{label}] {int(dead.sum())} chain(s) with every segment "
            f"masked: marginal NEG_INF + log_norm, gradients exactly 0")
    for name, err in checked.items():
        if not err <= MARGLIK_TOL:
            raise AssertionError(f"{name} [{label}]: error {err:.3e} > "
                                 f"{MARGLIK_TOL}")
    return abs_errs


def isochrone_dense(grid, feh, y, age):
    """derive_isochrone's blend through einsums over every node of the grid
    (its form until the 27-corner window replaced it): (mass, mags,
    agb_tip), a reference for the window form."""
    from base_tpu_torch.ops import interp as iops

    wf = iops.hat_weight_matrix(grid.feh, feh[:, None])[:, 0]
    wy = iops.hat_weight_matrix(grid.y, y[:, None])[:, 0]
    wa = iops.hat_weight_matrix(grid.age, age[:, None])[:, 0]
    w3 = wf[:, :, None, None] * wy[:, None, :, None] * wa[:, None, None, :]
    wv3 = w3[..., None] * grid.valid
    return (torch.einsum("cfya,fyae->ce", w3, grid.mass),
            torch.einsum("cfyae,fyaeb->ceb", wv3, grid.mags)
            / wv3.sum(dim=(1, 2, 3)).clamp_min(1e-12)[..., None],
            torch.einsum("cfya,fya->c", w3, grid.agb_tip))


def table_fwd_dense(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr):
    """Kernel 1's function through the dense products over every base-axis
    entry (secT @ W): a reference independent of the window rule that the
    kernels and their plain versions share."""
    from base_tpu_torch.ops import table as tb

    w, _, _ = tb._weights(m2N, xl, inv_dl, xr, inv_dr)
    f1 = torch.exp(-tb.LN10_04 * app1N)
    f2 = litN * torch.exp(-tb.LN10_04 * (secT @ w))
    return -tb.INV_LN10_04 * torch.log(f1 + f2)


def table_bwd_dense(app1N, m2N, litN, secT, xl, inv_dl, xr, inv_dr, g):
    """Kernel 2's cotangents through the dense products (secT @ W and its
    three transposed products), as table_fwd_dense."""
    from base_tpu_torch.ops import table as tb

    w, up, dn = tb._weights(m2N, xl, inv_dl, xr, inv_dr)
    f1 = torch.exp(-tb.LN10_04 * app1N)
    f2m = torch.exp(-tb.LN10_04 * (secT @ w))
    F = f1 + litN * f2m
    dmags2 = g * litN * f2m / F                          # [C, B, N]
    dW = secT.transpose(1, 2) @ dmags2                   # [C, E2, N]
    dup = dW * (6.0 * up * (1.0 - up))
    ddn = dW * (6.0 * dn * (1.0 - dn))
    return (g * f1 / F, (dup * inv_dl - ddn * inv_dr).sum(1, keepdim=True),
            (g * (-tb.INV_LN10_04) * f2m / F).sum(1, keepdim=True),
            dmags2 @ w.transpose(1, 2),
            (dup * (-inv_dl)).sum(2, keepdim=True),
            (dup * (m2N - xl)).sum(2, keepdim=True),
            (ddn * inv_dr).sum(2, keepdim=True),
            (ddn * (xr - m2N)).sum(2, keepdim=True))


def check_kernels(model, z, label: str) -> dict:
    """Each kernel against its plain version on the same CUDA inputs, and
    kernels 1-2 against the dense products too; returns {kernel: max abs
    error} and raises past the tolerances."""
    from base_tpu_torch.ops import table as tb

    table_in, marg_in = kernel_inputs(model, z)
    gen = torch.Generator(device=z.device).manual_seed(7)
    abs_errs, checked = {}, {}

    comb_k = tb.table_fwd_cuda(*table_in)
    comb_p = tb.table_fwd_plain(*table_in)
    abs_errs["table_fwd"] = checked["table_fwd"] = float(
        (comb_k - comb_p).abs().max())
    checked["table_fwd vs dense"] = float(
        (comb_k - table_fwd_dense(*table_in)).abs().max())
    g = torch.randn(comb_p.shape, generator=gen, device=z.device)
    names = ("dapp1", "dm2", "dlit", "dsecT", "dxl", "dinv_dl", "dxr",
             "dinv_dr")
    bwd_k = tb.table_bwd_cuda(*table_in, g)
    abs_errs["table_bwd"], checked["table_bwd"], report = grad_errs(
        names, bwd_k, tb.table_bwd_plain(*table_in, g))
    _, checked["table_bwd vs dense"], report_d = grad_errs(
        names, bwd_k, table_bwd_dense(*table_in, g))
    log(f"  [{label}] table N={comb_p.shape[2]}: fwd max|err| "
        f"{checked['table_fwd']:.3e}; bwd abs/scaled {report}")
    log(f"  [{label}] table vs the dense products: fwd max|err| "
        f"{checked['table_fwd vs dense']:.3e}; bwd abs/scaled {report_d}")
    for name, err in checked.items():
        tol = FWD_TOL if "fwd" in name else GRAD_TOL
        if not err <= tol:
            raise AssertionError(f"{name} [{label}]: error {err:.3e} > {tol}")
    abs_errs.update(check_marglik(marg_in, label))
    return abs_errs


def check_density(model_gpu, model_cpu, z) -> None:
    """log_post + gradient: card kernels vs the CPU plain path, then two
    card runs bit for bit."""
    lp_g, g_g = density_fn(model_gpu)(z)
    lp_c, g_c = density_fn(model_cpu)(z.cpu())
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
    lp2, g2 = density_fn(model_gpu)(z)
    same = torch.equal(lp_g, lp2) and torch.equal(g_g, g2)
    log(f"  two card runs bit-identical: {same}")
    if not same:
        raise AssertionError("card density + gradient not deterministic")


def _counter_module(name: str):
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    return tb if name.startswith("table") else ml


def launch_counts(names=tuple(KERNELS)) -> dict:
    """{kernel: launches its wrapper counted since the last reset}."""
    return {n: getattr(_counter_module(n), f"{n}_launches") for n in names}


def reset_launch_counts() -> None:
    for n in (*KERNELS, *MM_KERNELS):
        setattr(_counter_module(n), f"{n}_launches", 0)


def counted(fn):
    """fn with a call counter: (wrapped, [calls])."""
    calls = [0]

    def f(*args):
        calls[0] += 1
        return fn(*args)

    return f, calls


def counted_rows(fn):
    """fn with a record of the rows of every call: (wrapped, [rows of
    each call])."""
    rows = []

    def f(z):
        rows.append(int(z.shape[0]))
        return fn(z)

    return f, rows


def check_one_launch_per_call(label: str, counts: dict, calls: int,
                              kernels=tuple(KERNELS),
                              blocks: int = 1) -> None:
    """Raise unless each of `kernels` launched `blocks` times per density
    evaluation (`calls` of them; blocks > 1 with a sampler's chain_chunk,
    whose evaluations run in blocks of rows), and every other kernel
    never."""
    want = {k: (calls * blocks if k in kernels else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} for {calls} "
                             f"density evaluations of {blocks} block(s) "
                             f"(want {want})")


def block_evaluations(label: str, rows: list, n_rows: int,
                      chunk: int | None) -> int:
    """The density evaluations behind the recorded calls `rows` (each
    call's row count) of a sampler on n_rows chains under chain_chunk
    `chunk`: raises unless every call held one block's rows
    (hmc.chain_blocks) and the calls make whole evaluations; returns
    their number."""
    from base_tpu_torch.inference.hmc import chain_blocks

    blocks = chain_blocks(n_rows, chunk)
    per_call = n_rows // blocks
    if not rows or set(rows) != {per_call} or len(rows) % blocks:
        raise AssertionError(f"{label}: density calls of {sorted(set(rows))}"
                             f" rows ({len(rows)} calls), want {per_call} "
                             f"rows a call in evaluations of {blocks}")
    return len(rows) // blocks


def run_hmc(model, truth=TRUTH, n_chains: int = N_CHAINS, free=FREE,
            n_warmup: int = 64, n_samples: int = 64, n_windows: int = 4,
            rhat_max: float | None = 1.1, report=(0,), init=None,
            inv_mass0=None, init_step: float = 0.05, seed: int = 4):
    """The main path: chunked dense-metric HMC on the card, l_max 48 and
    step jitter, through the model's transform, from `init` [C, P]
    (unconstrained; by default near the truth) with the metric
    `inv_mass0`.  Returns (results, constrained draws [n_samples, C, P]);
    the launches are counted over the run alone, beside the density
    evaluations.  Asserts finite draws, an acceptance in (0, 1), every
    kernel launched, the age within 0.15 dex of the truth and (with
    rhat_max) split R-hat of the age below it.  ESS, split R-hat and the
    posterior mean and sd beside the truth are reported for the
    parameters in `report`."""
    from base_tpu_torch.inference import diagnostics as diag
    from base_tpu_torch.inference.driver import make_hmc_chunked_runner
    from base_tpu_torch.inference.hmc import HMCConfig
    from base_tpu_torch.model.multipop import MP_PARAM_NAMES

    cfg = HMCConfig(n_warmup=n_warmup, n_samples=n_samples, l_max=48,
                    n_windows=n_windows, dense_mass=True, free_mask=free,
                    jitter_mode="step", init_step=init_step)
    tr = transform(model)
    fz, evals = counted(logpost_z_fn(model))
    dev = model.grid.device
    if init is None:
        z0 = tr.inverse(torch.as_tensor(truth, device=dev))
        init = z0 + 0.02 * torch.randn(
            n_chains, z0.shape[0],
            generator=torch.Generator().manual_seed(2)).to(dev)
    runner = make_hmc_chunked_runner(fz, cfg, chunk_draws=64)
    gen = torch.Generator(device=dev).manual_seed(seed)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs, info = runner(init, gen, inv_mass0=inv_mass0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()

    xs = tr.forward(zs)                                  # [N, C, P]
    accept = float(info["accept_prob"])
    names = [MP_PARAM_NAMES[i] for i in report]
    ess = diag.ess(xs[:, :, list(report)])
    rhat = diag.split_rhat(xs[:, :, list(report)])
    res = dict(
        wall_s=wall,
        evals=evals[0],
        calls_per_s=evals[0] / wall,
        evals_per_s=evals[0] * n_chains / wall,     # chain evaluations
        accept=accept,
        step_size=float(info["step_size"]),
        ess={n: float(v) for n, v in zip(names, ess)},
        rhat={n: float(v) for n, v in zip(names, rhat)},
        posterior={n: dict(mean=float(xs[:, :, i].mean()),
                           sd=float(xs[:, :, i].std()),
                           truth=float(truth[i]))
                   for n, i in zip(names, report)},
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
    # ~0.03 at 100 stars) and, where asked, the chains mixed.
    if not abs(float(xs[:, :, 0].mean()) - truth[0]) < 0.15:
        raise AssertionError("HMC posterior misses the simulated truth")
    if rhat_max is not None and not res["rhat"]["logAge"] < rhat_max:
        raise AssertionError(f"split R-hat of age {res['rhat']['logAge']:.3f}")
    return res, xs


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


# Idle host time around the work of every profiler session: short
# sessions without it lost their kernel records as the process aged, padded
# ones kept them (scripts/torch_profiler_probe.py; PERF.md section 6).
PROFILE_PAD_S = 1.0


def profiled(work):
    """torch.profiler (CPU and CUDA) around `work()`, padded by
    PROFILE_PAD_S of idle host time on each side; returns the profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        work()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    return prof


# Cycles of torch.cuda._sleep that hold the stream while the host enqueues
# the launches that device_ms times behind it (~25 ms at 2 GHz).
SLEEP_CYCLES = 50_000_000


def device_ms(fn, reps: int = 20) -> float:
    """The kernel's own time on the card per call (ms): CUDA events around
    `reps` calls enqueued behind a sleep kernel, so that they run back to
    back and the host's dispatch stays out of the time (which holds the
    kernels' device time and the device's gap between launches).  Raises
    unless the host enqueued every call before the sleep ended.  A
    profiler session per kernel measured this too, but late in a run one
    such session recorded no kernel at all (PERF.md section 6)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ev[2].record()
    host_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].synchronize()
    sleep_ms = ev[0].elapsed_time(ev[1])
    if not host_ms < 0.8 * sleep_ms:
        raise AssertionError(f"enqueueing {reps} calls took {host_ms:.2f} ms"
                             f" of a {sleep_ms:.2f} ms sleep")
    return ev[1].elapsed_time(ev[2]) / reps


def time_pair(kernel, plain, reps: int = 20,
              plain_reps: int | None = None) -> tuple[float, float, float]:
    """(kernel ms, plain ms, kernel device ms): CUDA events over `reps`
    calls (`plain_reps` of the plain version, by default as many), in the
    order plain, kernel, kernel, plain; then the kernel's device time
    (device_ms)."""
    plain_reps = plain_reps or reps
    p1 = cuda_ms(plain, plain_reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, plain_reps)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2), device_ms(kernel, reps)


def time_marglik(marg_in, plain_reps: int | None = None) -> dict:
    """Kernels 3 and 4 timed against their plain versions (time_pair)."""
    from base_tpu_torch.ops import marglik as ml

    out = ml.marglik_fwd_plain(*marg_in)
    gs = torch.ones_like(out)
    return {
        "marglik_fwd": time_pair(lambda: ml.marglik_fwd_cuda(*marg_in),
                                 lambda: ml.marglik_fwd_plain(*marg_in),
                                 plain_reps=plain_reps),
        "marglik_bwd": time_pair(
            lambda: ml.marglik_bwd_cuda(*marg_in, out, gs),
            lambda: ml.marglik_bwd_plain(*marg_in, out, gs),
            plain_reps=plain_reps),
    }


def time_kernels(model, z, plain_reps: int | None = None) -> dict:
    """time_pair of kernels 1-4 at the main path's inputs at points z
    (`plain_reps` calls of each plain version; by default 20)."""
    from base_tpu_torch.ops import table as tb

    table_in, marg_in = kernel_inputs(model, z)
    comb = tb.table_fwd_plain(*table_in)
    g = torch.ones_like(comb)
    return {
        "table_fwd": time_pair(lambda: tb.table_fwd_cuda(*table_in),
                               lambda: tb.table_fwd_plain(*table_in),
                               plain_reps=plain_reps),
        "table_bwd": time_pair(lambda: tb.table_bwd_cuda(*table_in, g),
                               lambda: tb.table_bwd_plain(*table_in, g),
                               plain_reps=plain_reps),
        **time_marglik(marg_in, plain_reps),
    }


def skip_shares(marg_in) -> dict | None:
    """Kernel 4's skip rules (ops.marglik.marglik_bwd_group_skip and
    marglik_bwd_skip) on these inputs, as the kernel applies them: the
    (chain, star, 32-segment group)s with a live segment (`pairs`) and
    those the group rule marks before any band contraction; then, in the
    pairs it leaves, the live elements that the element rule marks after
    the contraction (`contracted`) and those it keeps (`kept`, the full
    path).  Shares: of pairs marked by the group rule, of live elements
    marked by the element rule alone, and of pairs in which the element
    rule keeps none.  None for a checkout without the rules."""
    from base_tpu_torch.ops import marglik as ml

    if not hasattr(ml, "marglik_bwd_group_skip"):
        return None
    S = marg_in[0].shape[-2]
    C, T = marg_in[3].shape[:2]
    # Blocks of chains, so that the plain [C, S, T, B] tensors stay near
    # 2^28 elements (one chain a block at S = 10 000, T = 2016).
    step = block_step(marg_in, 2**28)
    n = dict(live=0, pairs=0, pairs_marked=0, contracted=0, kept=0,
             marked=0, need_pairs=0)
    for c0 in range(0, C, step):
        blk = chain_block(marg_in, c0, c0 + step)
        out = ml.marglik_fwd_plain(*blk)
        skip = ml.marglik_bwd_skip(*blk, out)
        gskip = ml.marglik_bwd_group_skip(*blk, out)
        live = (blk[6] > 0.5)[:, None, :].expand_as(skip)
        Cb = skip.shape[0]
        pad = torch.zeros((Cb, S, gskip.shape[2] * 32 - T),
                          dtype=torch.bool, device=skip.device)

        def groups(x):
            return torch.cat([x, pad], -1).reshape(Cb, S, -1, 32).any(-1)

        in_pair = ~gskip.repeat_interleave(32, -1)[..., :T]
        need = live & ~skip
        n["live"] += int(live.sum())
        n["pairs"] += int(groups(live).sum())
        n["pairs_marked"] += int(gskip.sum())
        n["contracted"] += int((live & in_pair & skip).sum())
        n["kept"] += int((need & in_pair).sum())
        n["marked"] += int(skip.sum())
        n["need_pairs"] += int(groups(need).sum())
    pairs, n_live = max(n["pairs"], 1), max(n["live"], 1)
    return dict(
        live=n["live"], pairs=n["pairs"], pairs_marked=n["pairs_marked"],
        contracted=n["contracted"], kept=n["kept"],
        group_rule_share=n["pairs_marked"] / pairs,
        element_share=n["marked"] / n_live,
        warp_skip_share=1.0 - n["need_pairs"] / pairs)


def _marglik_sizes(marg_in) -> tuple[int, int, int]:
    """(live (chain, star, segment) elements, bytes of the forward, bytes
    of the backward): each input read once, each output written once (the
    stars of every star set)."""
    S, B = marg_in[0].shape[-2:]
    C, T = marg_in[3].shape[:2]
    f = 4                                           # bytes per float
    inputs = f * (2 * marg_in[0].numel() + marg_in[2].numel()
                  + 2 * C * T * B + 2 * C * T)
    return (S * int((marg_in[6] > 0.5).sum()), inputs + f * C * S,
            inputs + f * 2 * C * S + f * (2 * C * T * B + C * T))


def marglik_work(marg_in, bwd: bool = True) -> dict:
    """{kernel: (flops, bytes)} of kernels 3 and 4 on these inputs (see
    kernel_work), with kernel 4's dense count and its skip shares; kernel
    3's alone without `bwd`."""
    B = marg_in[0].shape[-1]
    live, fwd_bytes, marg_bwd_bytes = _marglik_sizes(marg_in)
    # Per live element: band contraction 11B, core_width and
    # phi_interval_scaled ~100, online update 5.
    fwd = (live * (11 * B + 105), fwd_bytes)
    if not bwd:
        return {"marglik_fwd": fwd}
    skips = skip_shares(marg_in)
    return {
        "marglik_fwd": fwd,
        # Per (group, star) pair with a live segment: the group rule,
        # 20B + 10.  Per element the group rule leaves: the band
        # contraction 11B and the element rule 20, and where that keeps
        # it, the forward's 100, moments and softmax weight ~38 and the
        # cotangents 14B.
        # (A checkout without the rules is counted as below.)
        "marglik_bwd": ((skips["pairs"] * (20 * B + 10)
                         + skips["contracted"] * (11 * B + 20)
                         + skips["kept"] * (25 * B + 158)) if skips
                        else live * (25 * B + 138), marg_bwd_bytes),
        # Every live element at the full cost, the count from before the
        # skip rules, so that older bounds stay comparable.
        "marglik_bwd_dense": (live * (25 * B + 138), marg_bwd_bytes),
        "marglik_bwd_skip": skips,
    }


def kernel_work(model, z, bwd: bool = True) -> dict:
    """{kernel: (flops, bytes)} that each kernel needs on the main path's
    inputs at points z.  Bytes: each input read once, each output written
    once (float32; scratch not counted).  Flops are counted by hand from
    csrc/ (an FMA is 2, a transcendental or a division 1) and, where the
    work depends on the data, over what these inputs need: the table
    kernels over the (node, axis entry) pairs with a non-zero hat weight or
    factor, the marginal kernels over the unmasked segments, and kernel 4's
    full path over the elements its skip rule keeps."""
    return table_work(kernel_inputs(model, z), bwd)


def table_work(inputs, bwd: bool = True) -> dict:
    """kernel_work on the kernels' inputs (table_in, marg_in)."""
    from base_tpu_torch.ops import table as tb

    table_in, marg_in = inputs
    app1, m2, _, secT = table_in[:4]
    C, B, N = app1.shape
    E2 = secT.shape[2]
    w, up, dn = tb._weights(m2, *table_in[4:])
    nnz = int(((w != 0) | (up * (1 - up) != 0) | (dn * (1 - dn) != 0))
              .sum())
    f = 4                                           # bytes per float
    table_io = f * (C * B * N + 2 * C * N + C * B * E2 + 4 * C * E2)
    return {
        # Per non-zero entry: 2 ramps + 2 smoothsteps + weight (18), B FMAs;
        # per (node, band): 2 exp, the flux sum, log (8).
        "table_fwd": (nnz * (18 + 2 * B) + 8 * C * B * N,
                      table_io + f * C * B * N),
        # Per non-zero entry: the weight and mags2 again (18 + 2B), dm2
        # (22 + 2B), the node sums (38 + 4B); per (node, band) 15.
        "table_bwd": (nnz * (78 + 8 * B) + 15 * C * B * N,
                      table_io + f * C * B * N + table_io),
        **marglik_work(marg_in, bwd),
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

    return value_and_grad(logpost_z_fn(model))


def device_shares(model, z, label: str, wall_ms: float,
                  calls: int = 5) -> dict:
    """One torch.profiler pass over `calls` density + gradient calls:
    device time per call over `wall_ms` (the call's time without the
    profiler, CUDA events) as the device's busy share, and each kernel's
    share of device time.  Raises unless the profiler recorded at least
    99% of the launches that the kernel wrappers counted in the pass, for
    each of the four kernels (`recorded`: the share it recorded)."""
    vg = density_fn(model)
    for _ in range(2):
        vg(z)
    walls = []

    def work():
        t0 = time.perf_counter()
        for _ in range(calls):
            vg(z)
        torch.cuda.synchronize()
        walls.append(1e6 * (time.perf_counter() - t0))

    before = launch_counts()
    prof = profiled(work)
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    wall_us = walls[0]
    kernels = _kernel_events(prof)
    busy = sum(_dev_us(e) for e in kernels)
    # Records per wrapper launch (kernel 2 is two device kernels).
    recorded = {name: sum(e.count for e in kernels
                          if any(sym in e.key for sym in syms))
                / max(launched[name] * (2 if name == "table_bwd" else 1), 1)
                for name, syms in KERNEL_SYMBOLS.items()}
    log(f"  [{label}] profiler recorded {recorded} of the launches "
        f"{launched}")
    if busy <= 0 or not all(0.99 <= r <= 1.0 for r in recorded.values()):
        raise AssertionError(f"[{label}] the profiler missed launches")
    res = dict(
        recorded=recorded,
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


def profiler_ms(shares: dict, name: str) -> float:
    """A kernel's device time per density call in a device_shares pass."""
    return shares["kernel_share"][name] * shares["device_ms_per_call"]


def density_walls(models: dict, z) -> dict:
    """{label: ms per log_post + gradient call} (CUDA events)."""
    walls = {}
    for label, model in models.items():
        vg = density_fn(model)
        walls[label] = cuda_ms(lambda: vg(z))
        log(f"  log_post + gradient [{label}], {z.shape[0]} chains: "
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
        # Share of bound: over the kernel's device time (back-to-back
        # calls of a short kernel measure the host's dispatch).
        share = bound_ms / dev
        share4 = bound_up4 / dev4
        report[name] = dict(
            ms=ms, plain_ms=plain_ms, device_ms=dev, flops=work[name][0],
            bytes=work[name][1], bound_ms=bound_ms, bound_by=bound_by,
            roofline_share=share, ms_up4=ms4, plain_ms_up4=plain_ms4,
            device_ms_up4=dev4, bound_ms_up4=bound_up4, bound_by_up4=by_up4,
            roofline_share_up4=share4)
        if name == "marglik_bwd":
            report[name].update(
                bound_ms_dense=bound(*work["marglik_bwd_dense"])[0],
                bound_ms_dense_up4=bound(*work_up4["marglik_bwd_dense"])[0],
                skip=work["marglik_bwd_skip"],
                skip_up4=work_up4["marglik_bwd_skip"])
            log(f"  marglik_bwd skip rule: bench {json.dumps(report[name]['skip'])}"
                f"; upsample 4 {json.dumps(report[name]['skip_up4'])}; "
                f"bound with every live element at full cost "
                f"{report[name]['bound_ms_dense']:.5f} ms "
                f"({report[name]['bound_ms_dense_up4']:.5f})")
        log(f"  {name}: kernel {ms:.4f} ms, device {dev} ms (upsample 4: "
            f"{ms4:.4f}, device {dev4}); plain {plain_ms:.4f} ms "
            f"({plain_ms4:.4f}); bound {bound_ms:.5f} ms by {bound_by} "
            f"({bound_up4:.5f} by {by_up4}); share of bound {share:.4f} "
            f"({share4:.4f})")
    return report


# Config 3 (BASELINE.json config 3, benchmarks/wd_ifmr_tpu.py:45-107): a
# cluster whose heavy stars are WDs, fitted in all eight WD-model dims with a
# tunable linear IFMR, then per-WD precursor masses and cooling ages drawn
# from the posterior (sampleWDMass).
TRUTH3 = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.7, 0.08, 0.0],
                  np.float32)
PRIOR_SIGMA3 = np.array([-1, -1, 0.3, 0.2, 0.1, 0.1, 0.3, 0.15, -1],
                        np.float32)
N_CHAINS3, N_STARS3, N_MZ3, UPSAMPLE3 = 16, 512, 96, 4
# A short run (the benchmark takes 768 + 3072): one density + gradient call
# of config 3 takes 25-48 ms on the card, host-bound (the host varies), so
# 32 x 48 calls (halved when phases 9-11 joined, the warmup cut from 32 to
# 24 when phase 11d did, the draws from 16 to 8 when phase 15 did; 16 + 8
# left accept 0.29 where 24 + 16 had 0.83) keep the whole script well
# inside its time limit.
N_WARMUP3, N_SAMPLES3 = 24, 8


def make_data3():
    """Config-3 photometry through the port's simulator (WD branch, linear
    IFMR, 10% DB, 30% binaries) and noise model, on the CPU from fixed
    seeds: ((MS mags, sigmas), (WD mags, sigmas), the WDs' true ZAMS
    masses)."""
    from base_tpu_torch import constants as C
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.grids.wd_atmosphere import synthetic_bergeron
    from base_tpu_torch.grids.wd_cooling import synthetic_wd_cooling
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    grid = synthetic.make_grid(n_eep=N_EEP, device="cpu")
    gen = torch.Generator().manual_seed(10)
    cat = simulate_cluster(
        grid, torch.as_tensor(TRUTH3), N_STARS3, gen, percent_binary=0.3,
        wd_cooling=synthetic_wd_cooling(device="cpu"),
        wd_atm=synthetic_bergeron(device="cpu"), ifmr_kind="linear",
        percent_db=0.1)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    wd = (cat.stage == C.StarStatus.WD).numpy()
    mags, sig = sc.mags.numpy(), sc.sigmas.numpy()
    return ((mags[~wd], sig[~wd]), (mags[wd], sig[wd]),
            cat.mass1.numpy()[wd])


def make_model3(data3, device):
    """The config-3 model (wd_ifmr_tpu.py:74-83): n_q 8, upsample 4, 96
    precursor nodes, linear IFMR, 10% DB."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.grids.wd_atmosphere import synthetic_bergeron
    from base_tpu_torch.grids.wd_cooling import synthetic_wd_cooling
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars

    ms, wd, _ = data3
    return post.make_single_pop_model(
        synthetic.make_grid(n_eep=N_EEP, device=device),
        make_ms_stars(*ms, cm_prior=0.99, device=device), TRUTH3,
        PRIOR_SIGMA3, n_q=N_Q,
        wd_cooling=synthetic_wd_cooling(device=device),
        wd_atm=synthetic_bergeron(device=device),
        wd_stars=make_ms_stars(*wd, cm_prior=0.99, device=device),
        n_mz=N_MZ3, ifmr_kind="linear", p_db=0.1, upsample=UPSAMPLE3,
        device=device)


def config3_points(model) -> torch.Tensor:
    """[16, 9] unconstrained points around the config-3 truth in its free
    dims; the last chain's IFMR intercept is -3 Msun, which leaves every
    WD node invalid (a fully masked WD table)."""
    from base_tpu_torch import constants as C
    from base_tpu_torch.model import posterior as post

    tr = post.default_transform(model)
    z = chain_points(model, 0.05, seed=11, truth=TRUTH3,
                     n_chains=N_CHAINS3, free=post.free_mask(model))
    x = tr.forward(z)
    x[-1, C.Param.IFMR_INTERCEPT] = -3.0
    return tr.inverse(x)


def wd_marglik_inputs(model, z):
    """Kernels 3 and 4's inputs on the WD branch at points z, as log_post
    builds them (model.wd)."""
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model import wd

    x = post.default_transform(model).forward(z)
    mags, _, valid = wd.wd_model_mags(model.grid, model.wd_cooling,
                                      model.wd_atm, x, model.mz_grid,
                                      model.ifmr_kind)
    table = wd.wd_segment_table(mags, valid, model.mz_grid, x[:, 3], x[:, 4],
                                model.abs_coefs, model.p_db)
    st = model.wd_stars
    return (st.obs_mags, st.inv_var, st.log_norm, table.lo.contiguous(),
            table.hi.contiguous(), table.logw.contiguous(),
            table.mask.float())


def wd_conditionals(model, xs, true_zams) -> dict:
    """sampleWDMass on every 64th posterior draw (wd_ifmr_tpu.py:245-265):
    wall time, and the per-WD posterior-mean ZAMS mass against the
    simulated truth (RMSE, and the share within 2.5 sd + 0.05 Msun)."""
    from base_tpu_torch.model import conditionals as cond

    draws = xs.reshape(-1, 9)[::64].contiguous()
    gen = torch.Generator(device=draws.device).manual_seed(9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cond.sample_wd_masses(model, draws, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    zm = out.zams_mass.double().cpu().numpy()
    err = zm.mean(0) - true_zams
    cover = np.abs(err) < 2.5 * zm.std(0) + 0.05
    res = dict(draws=int(draws.shape[0]), wds=int(zm.shape[1]), wall_s=wall,
               zams_mass_rmse=float(np.sqrt((err ** 2).mean())),
               zams_mass_cover_2p5sd=float(cover.mean()),
               wd_mass_mean=float(out.wd_mass.mean()),
               db_share=float(out.is_db.float().mean()),
               p_member_mean=float(out.p_member.mean()))
    log("  sample_wd_masses " + json.dumps(res))
    if not all(bool(torch.isfinite(t).all()) for t in
               (out.zams_mass, out.wd_mass, out.log_cool_age, out.log_marg)):
        raise AssertionError("non-finite WD conditionals")
    return res


def run_config3(dev, baseline=None) -> dict:
    """Config 3's phases, after config 1's: (a) kernels 3 and 4 against
    their plain versions at the MS and WD shapes, a fully masked WD chain
    among them; (b) log_post + gradient, card against the CPU plain path,
    and twice bit for bit; (c) chunked dense-metric HMC, the launches
    counted over this phase alone; (d) sample_wd_masses on thinned draws;
    (e) the density's wall and device time per call, the busy share, and
    kernels 3 and 4 at the WD shapes against their bound.  `baseline`, a
    (model, points) pair of config 1, is timed beside config 3's density
    in (e)."""
    from base_tpu_torch.model import posterior as post

    data3 = make_data3()
    model = make_model3(data3, dev)
    log(f"config 3: {data3[0][0].shape[0]} MS stars, {data3[1][0].shape[0]}"
        f" WDs, {N_CHAINS3} chains, free {post.free_mask(model)}")
    z = config3_points(model)

    log("phase 7a: kernels 3 and 4 vs plain at the config-3 shapes")
    _, ms_in = kernel_inputs(model, z)
    wd_in = wd_marglik_inputs(model, z)
    errs = {"ms": check_marglik(ms_in, "config 3 MS"),
            "wd": check_marglik(wd_in, "config 3 WD")}

    log("phase 7b: log_post + gradient, card vs CPU")
    check_density(model, make_model3(data3, "cpu"), z)

    log(f"phase 7c: chunked HMC, {N_CHAINS3} chains, dense metric, "
        f"l_max 48, 6 windows, {N_WARMUP3} + {N_SAMPLES3} draws")
    hmc, xs = run_hmc(model, TRUTH3, N_CHAINS3, post.free_mask(model),
                      n_warmup=N_WARMUP3, n_samples=N_SAMPLES3, n_windows=6,
                      rhat_max=None, report=(0, 6, 7))

    log("phase 7d: sample_wd_masses")
    cond = wd_conditionals(model, xs, data3[2])

    log("phase 7e: density time and kernels 3 and 4 at the WD shapes")
    wall = density_walls({"config 3": model}, z)["config 3"]
    if baseline is not None:
        density_walls({"config 1, upsample 4": baseline[0]}, baseline[1])
    shares = device_shares(model, z, "config 3", wall)
    times = time_marglik(wd_in)
    work = marglik_work(wd_in)
    wd_kernels = {}
    for name, (ms, plain_ms, dev_ms) in times.items():
        bound_ms, bound_by = bound(*work[name])
        wd_kernels[name] = dict(
            ms_wd=ms, plain_ms_wd=plain_ms, device_ms_wd=dev_ms,
            bound_ms_wd=bound_ms, bound_by_wd=bound_by,
            max_abs_err_wd=errs["wd"][name],
            max_abs_err_config3_ms=errs["ms"][name])
        log(f"  {name} at the WD shapes: kernel {ms:.4f} ms, device "
            f"{dev_ms} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.6f} ms "
            f"by {bound_by}")
    log("  marglik_bwd skip rule at the WD shapes: "
        + json.dumps(work["marglik_bwd_skip"]))
    return dict(hmc=hmc, conditionals=cond, wall_ms=wall, shares=shares,
                wd_kernels=wd_kernels)


# Config 4 (BASELINE.json config 4, benchmarks/multipop_tpu.py:25-73): a
# two-population helium-spread cluster (NGC 2808-style), 60% of its stars at
# Y_A = 0.25 and 40% at Y_B = 0.30, fitted in twelve dims through the ordered
# (Y_A < Y_B) transform after a full-rank VI warm start.  Both populations
# go through one pass of the density on a doubled chain axis, so 32 chains
# are 64 table chains.
TRUTH4 = np.concatenate([TRUTH, [0.25, 0.30, 0.6]]).astype(np.float32)
START4 = np.concatenate([TRUTH, [0.26, 0.29, 0.5]]).astype(np.float32)
PRIOR_MEAN4 = np.concatenate([TRUTH, [0.25, 0.30, 0.5]]).astype(np.float32)
PRIOR_SIGMA4 = np.concatenate([PRIOR_SIGMA, [-1, -1, -1]]).astype(np.float32)
N_CHAINS4, N_STARS4, UPSAMPLE4 = 32, 400, 4
# A short run (the benchmark takes 256 + 1024 draws; halved from 128 + 64
# when phases 9-11 joined, the warmup halved again when phase 12 did (the
# VI warm start hands HMC its draws and metric), and the draws when phase
# 14 did and again when phase 15 did).
N_WARMUP4, N_SAMPLES4 = 32, 8
# Reference-parity MH (bench_baseline.py:229-231): 64 chains.
N_CHAINS_MH4 = 64
STEP_MH4 = np.zeros(12, np.float32)
STEP_MH4[[0, 2, 3, 4]] = (0.02, 0.005, 0.005, 0.002)
STEP_MH4[[9, 10, 11]] = (0.002, 0.002, 0.02)


def make_data4():
    """Config-4 photometry through the port's simulator (every star a
    binary, masses from 0.15 Msun) and noise model (no censoring), on the
    CPU from fixed seeds: 240 stars at Y_A, then 160 at Y_B."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    grid = synthetic.make_grid(n_eep=N_EEP, device="cpu")
    gen = torch.Generator().manual_seed(20)
    n_a = int(round(N_STARS4 * TRUTH4[11]))
    mags = []
    for y, n in ((TRUTH4[9], n_a), (TRUTH4[10], N_STARS4 - n_a)):
        p = TRUTH.copy()
        p[1] = y
        mags.append(simulate_cluster(grid, torch.as_tensor(p), n, gen,
                                     percent_binary=1.0, min_mass=0.15).mags)
    sc = scatter_cluster(torch.cat(mags), gen, limit_mag=24.0, censor=False)
    return sc.mags.numpy(), sc.sigmas.numpy()


def make_model4(data4, device):
    """The config-4 model (multipop_tpu.py:59-69): n_q 8, upsample 4,
    priors on FeH, modulus and A_V."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import multipop as mp
    from base_tpu_torch.model.stardata import make_ms_stars

    return mp.make_multipop_model(
        synthetic.make_grid(n_eep=N_EEP, device=device),
        make_ms_stars(*data4, cm_prior=0.99, device=device), PRIOR_MEAN4,
        PRIOR_SIGMA4, n_q=N_Q, upsample=UPSAMPLE4, device=device)


def config4_points(model) -> torch.Tensor:
    """[32, 12] unconstrained points (ordered transform): chain 0 at the
    truth, the rest scattered around it in the free dims."""
    from base_tpu_torch.model import multipop as mp

    tr = mp.ordered_transform(model)
    dev = tr.base.lo.device
    z0 = tr.inverse(torch.as_tensor(TRUTH4, device=dev))
    gen = torch.Generator().manual_seed(21)
    noise = 0.05 * torch.randn(N_CHAINS4, 12, generator=gen).to(dev)
    noise[0] = 0.0
    return z0 + noise * torch.as_tensor(mp.free_mask(model), device=dev)


def check_fold(table_in, marg_in, n_chains: int) -> None:
    """Each kernel on the folded inputs (2C table chains) against the same
    kernel on rows :C and C: alone: the outputs bit for bit."""
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    gen = torch.Generator(device=marg_in[0].device).manual_seed(8)
    comb = tb.table_fwd_cuda(*table_in)
    g = torch.randn(comb.shape, generator=gen, device=comb.device)
    dtab = tb.table_bwd_cuda(*table_in, g)
    out = ml.marglik_fwd_cuda(*marg_in)
    gs = torch.randn(out.shape, generator=gen, device=out.device)
    dmarg = ml.marglik_bwd_cuda(*marg_in, out, gs)
    same = dict.fromkeys(KERNELS, True)
    for sl in (slice(0, n_chains), slice(n_chains, 2 * n_chains)):
        t_in = tuple(t[sl].contiguous() for t in table_in)
        m_in = marg_in[:3] + tuple(t[sl].contiguous() for t in marg_in[3:])
        same["table_fwd"] &= torch.equal(tb.table_fwd_cuda(*t_in), comb[sl])
        same["table_bwd"] &= all(
            torch.equal(a, b[sl]) for a, b in
            zip(tb.table_bwd_cuda(*t_in, g[sl].contiguous()), dtab))
        same["marglik_fwd"] &= torch.equal(ml.marglik_fwd_cuda(*m_in),
                                           out[sl])
        same["marglik_bwd"] &= all(
            torch.equal(a, b[sl]) for a, b in
            zip(ml.marglik_bwd_cuda(*m_in, out[sl].contiguous(),
                                    gs[sl].contiguous()), dmarg))
    log(f"  folded launch (C = {2 * n_chains}) vs two launches of C = "
        f"{n_chains}, bit-identical: {same}")
    if not all(same.values()):
        raise AssertionError("a folded launch differs from the per-"
                             "population launches")


def check_label_swap(model, z) -> None:
    """Swapping (Y_A, Y_B) with lambda -> 1 - lambda leaves log_post
    unchanged (rtol 1e-6)."""
    from base_tpu_torch.model import multipop as mp

    x = mp.ordered_transform(model).forward(z)
    xs = torch.cat([x[:, :9], x[:, [mp.MP_YYB, mp.MP_YYA]],
                    1.0 - x[:, mp.MP_LAMBDA, None]], dim=1)
    lp, lp_s = mp.log_post(model, x), mp.log_post(model, xs)
    rel = float(((lp_s - lp).abs() / lp.abs().clamp_min(1.0)).max())
    log(f"  label swap: max rel change of log_post {rel:.3e}")
    if not rel <= 1e-6:
        raise AssertionError("log_post is not label-symmetric on the card")


def run_multipop_hmc(model) -> dict:
    """Phase 8c: vi_warm_start (full rank, 600 steps), then run_hmc
    through the ordered transform from its draws and covariance; in each,
    every kernel's launches held equal to the density evaluations."""
    from base_tpu_torch.inference.vi import vi_warm_start
    from base_tpu_torch.model import multipop as mp

    free = mp.free_mask(model)
    dev = model.grid.device
    fz, evals = counted(logpost_z_fn(model))
    z0 = transform(model).inverse(torch.as_tensor(START4, device=dev))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    init, inv_mass0, vres = vi_warm_start(
        fz, z0, torch.Generator(device=dev).manual_seed(3), N_CHAINS4,
        free_mask=free)
    torch.cuda.synchronize()
    vi_wall, vi_launches = time.perf_counter() - t0, launch_counts()

    report = (0, 2, 3, 4, mp.MP_YYA, mp.MP_YYB, mp.MP_LAMBDA)
    res, xs = run_hmc(model, TRUTH4, N_CHAINS4, free, N_WARMUP4, N_SAMPLES4,
                      rhat_max=None, report=report, init=init,
                      inv_mass0=inv_mass0, init_step=0.1, seed=5)
    res.update(vi_wall_s=vi_wall, vi_evals=evals[0],
               vi_final_elbo=float(vres.final_elbo),
               vi_launches=vi_launches)
    log("  VI: " + json.dumps({k: res[k] for k in (
        "vi_wall_s", "vi_evals", "vi_final_elbo", "vi_launches")}))
    check_one_launch_per_call("VI", vi_launches, evals[0])
    check_one_launch_per_call("HMC", res["launches"], res["evals"])
    if not bool((xs[..., mp.MP_YYB] > xs[..., mp.MP_YYA]).all()):
        raise AssertionError("a draw has Y_B <= Y_A")
    if not 0.6 <= res["accept"] <= 0.99:
        raise AssertionError(f"acceptance {res['accept']} outside "
                             f"[0.6, 0.99]")
    mean = {n: v["mean"] for n, v in res["posterior"].items()}
    if not (abs(mean["Y_A"] - TRUTH4[9]) < 0.03
            and abs(mean["Y_B"] - TRUTH4[10]) < 0.03
            and abs(mean["lambda"] - TRUTH4[11]) < 0.2):
        raise AssertionError("HMC posterior misses the simulated truth")
    return res


def run_multipop_mh(model) -> dict:
    """Phase 8d: reference-parity adaptive MH (bench_baseline.py:211-235's
    step scales) on 64 chains from the truth, at 200 / 200 / 400 steps;
    every step one density call without gradients (kernels 1 and 3
    alone)."""
    from base_tpu_torch.inference.mh import MHConfig, run_adaptive_mh
    from base_tpu_torch.model import multipop as mp

    dev = model.grid.device
    f, evals = counted(mp.make_logpost_fn(model))
    start = torch.as_tensor(TRUTH4, device=dev)
    cfg = MHConfig(n_stage1=200, n_stage2=200, n_main=400)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, info = run_adaptive_mh(
        f, start.expand(N_CHAINS_MH4, -1).contiguous(),
        torch.Generator(device=dev).manual_seed(6),
        torch.as_tensor(STEP_MH4, device=dev), cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = cfg.n_stage1 + cfg.n_stage2 + cfg.n_main
    rate = float(info["accept_rate"].mean())
    res = dict(wall_s=wall, chains=N_CHAINS_MH4, steps=steps,
               chain_steps_per_s=N_CHAINS_MH4 * steps / wall,
               accept=rate, evals=evals[0], launches=counts,
               stage2_accept=float(info["stage2_accept"].mean()),
               mean_Y_A=float(samples[..., mp.MP_YYA].mean()),
               mean_Y_B=float(samples[..., mp.MP_YYB].mean()),
               mean_lambda=float(samples[..., mp.MP_LAMBDA].mean()))
    log("  " + json.dumps(res))
    lps = info["logposts"]
    if not bool((torch.isfinite(lps) & (lps > -1e29)).all()):
        raise AssertionError("non-finite MH log posteriors")
    pinned = torch.as_tensor(STEP_MH4 == 0, device=dev)
    if not bool((samples[..., pinned] == start[pinned]).all()):
        raise AssertionError("a pinned MH dim moved")
    if not 0.05 < rate < 0.6:
        raise AssertionError(f"MH acceptance {rate} outside (0.05, 0.6)")
    check_one_launch_per_call("MH", counts, evals[0],
                              kernels=("table_fwd", "marglik_fwd"))
    return res


def fold_walls(model, z) -> dict:
    """ms per value + gradient of the MS marginals of both populations
    (CUDA events): in one folded pass, as log_post runs them, and in two
    passes of one population each."""
    from base_tpu_torch.inference.hmc import value_and_grad
    from base_tpu_torch.model import multipop as mp

    tr = mp.ordered_transform(model)
    C = z.shape[0]

    def folded(zz):
        return mp.population_marginals(
            model, mp.population_params(tr.forward(zz)))[0].sum(1)

    def two_pass(zz):
        p2 = mp.population_params(tr.forward(zz))
        return (mp.population_marginals(model, p2[:C])[0].sum(1)
                + mp.population_marginals(model, p2[C:])[0].sum(1))

    res = {}
    for label, fn in (("folded", folded), ("two_pass", two_pass)):
        vg = value_and_grad(fn)
        res[label + "_ms"] = cuda_ms(lambda: vg(z))
    log(f"  MS marginals of both populations, value + gradient: "
        f"{json.dumps(res)}")
    return res


def run_config4(dev) -> dict:
    """Config 4's phases, after config 3's: (a) kernels 1-4 against their
    plain versions at its shapes, and the folded launch against two
    per-population launches bit for bit; (b) log_post + gradient, card
    against the CPU plain path, twice bit for bit, and the label swap;
    (c) VI warm start + chunked HMC, launches held equal to density
    evaluations; (d) adaptive MH; (e) the density's wall and device time
    per call, its busy share, and the kernels at the config-4 shapes
    against their bound."""
    from base_tpu_torch.model import multipop as mp

    data4 = make_data4()
    model = make_model4(data4, dev)
    z = config4_points(model)
    log(f"config 4: {N_STARS4} stars, {N_CHAINS4} chains ({2 * N_CHAINS4} "
        f"table chains), free {mp.free_mask(model)}")

    log("phase 8a: kernels vs plain and the fold at the config-4 shapes")
    errs = check_kernels(model, z, "config 4")
    check_fold(*kernel_inputs(model, z), N_CHAINS4)

    log("phase 8b: log_post + gradient, card vs CPU; label swap")
    check_density(model, make_model4(data4, "cpu"), z)
    check_label_swap(model, z)

    log(f"phase 8c: VI warm start + chunked HMC, {N_CHAINS4} chains, dense "
        f"metric, l_max 48, {N_WARMUP4} + {N_SAMPLES4} draws")
    hmc = run_multipop_hmc(model)

    log(f"phase 8d: adaptive MH, {N_CHAINS_MH4} chains")
    mh = run_multipop_mh(model)

    log("phase 8e: density time and the kernels at the config-4 shapes")
    wall = density_walls({"config 4": model}, z)["config 4"]
    fold = fold_walls(model, z)
    shares = device_shares(model, z, "config 4", wall)
    times = time_kernels(model, z)
    work = kernel_work(model, z)
    kernels4 = {}
    for name, (ms, plain_ms, dev_ms) in times.items():
        bound_ms, bound_by = bound(*work[name])
        kernels4[name] = dict(
            ms_config4=ms, plain_ms_config4=plain_ms,
            device_ms_config4=dev_ms, bound_ms_config4=bound_ms,
            bound_by_config4=bound_by, max_abs_err_config4=errs[name],
            launches_config4=(hmc["vi_launches"][name]
                              + hmc["launches"][name]))
        log(f"  {name} at the config-4 shapes: kernel {ms:.4f} ms, device "
            f"{dev_ms:.5f} ms; plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.6f} ms by {bound_by}")
    log("  marglik_bwd skip rule at the config-4 shapes: "
        + json.dumps(work["marglik_bwd_skip"]))
    return dict(hmc=hmc, mh=mh, wall_ms=wall, fold=fold, shares=shares,
                kernels=kernels4)


# Config 1 under NUTS (benchmarks/nuts_vs_hmc_tpu.py:55-79): phase 4's model
# and chains, dense metric, the flat dims pinned, max_depth 7.  A short run
# (the benchmark takes 256 + 1024 draws): 64 warmup transitions left the
# chains short of stationary (split R-hat of age 1.129 after 64 draws on an
# H100), 128 do not (1.048); the draws were cut from 64 to 48 when phase
# 11d joined, and raised to 96 when a density equal to the last bits moved
# the split R-hat of 48 draws (about 7 effective draws a chain) from 1.078
# to 1.152 with the same mean and sd: at 48 the gate read noise.
N_WARMUP_NUTS, N_SAMPLES_NUTS, MAX_DEPTH_NUTS = 128, 96, 7


def age_summary(xs) -> dict:
    """ESS and split R-hat of the age, its posterior mean and sd, from
    constrained draws [N, C, P]."""
    from base_tpu_torch.inference import diagnostics as diag

    age = xs[:, :, :1]
    return dict(ess=float(diag.ess(age)[0]),
                rhat=float(diag.split_rhat(age)[0]),
                mean=float(age.mean()), sd=float(age.std()))


def run_nuts_config1(model, hmc_res: dict) -> dict:
    """Phase 9: chunked NUTS on config 1 (64 chains, dense metric, pinned
    flat dims, max_depth 7, 4 windows), every kernel's launches held equal
    to the density calls; split R-hat of the age below 1.1 and its mean
    within 4 posterior sd of the truth.  Every leaf is one density call on
    all chains, so the calls per transition are the lockstep tree size:
    the largest of the chains' trees, beside the chains' mean."""
    from base_tpu_torch.inference.nuts import (NUTSConfig,
                                               make_nuts_chunked_runner)

    cfg = NUTSConfig(n_warmup=N_WARMUP_NUTS, n_samples=N_SAMPLES_NUTS,
                     max_depth=MAX_DEPTH_NUTS, n_windows=4, dense_mass=True,
                     free_mask=FREE)
    tr = transform(model)
    fz, calls = counted(logpost_z_fn(model))
    dev = model.grid.device
    z0 = tr.inverse(torch.as_tensor(TRUTH, device=dev))
    init = z0 + 0.02 * torch.randn(
        N_CHAINS, 9, generator=torch.Generator().manual_seed(2)).to(dev)
    runner = make_nuts_chunked_runner(fz, cfg, chunk_draws=64)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs, info = runner(init, torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    xs = tr.forward(zs)
    transitions = (cfg.n_windows * max(cfg.n_warmup // cfg.n_windows, 1)
                   + cfg.n_samples)
    age = age_summary(xs)
    res = dict(
        wall_s=wall, density_calls=calls[0], launches=counts,
        calls_per_s=calls[0] / wall,
        mean_leapfrogs=float(info["mean_leapfrogs"]),
        lockstep_leaves_per_transition=(calls[0] - 1) / transitions,
        accept=float(info["accept_prob"]),
        step_size=float(info["step_size"]),
        age=age, hmc_age=hmc_res["posterior"]["logAge"])
    log("  " + json.dumps(res))
    if not torch.isfinite(zs).all():
        raise AssertionError("non-finite NUTS samples")
    check_one_launch_per_call("NUTS", counts, calls[0])
    if not 0.0 < res["accept"] < 1.0:
        raise AssertionError(f"NUTS acceptance {res['accept']}")
    if not age["rhat"] < 1.1:
        raise AssertionError(f"NUTS split R-hat of age {age['rhat']:.3f}")
    if not abs(age["mean"] - TRUTH[0]) < 4.0 * age["sd"]:
        raise AssertionError("NUTS posterior misses the simulated age")
    return res


# Config 2 (BASELINE.json config 2, benchmarks/field_membership_tpu.py:
# 36-78): 200 members, every one a binary, plus 40 uniform-CMD field stars
# at membership priors 0.9 / 0.3, the field density normalised over the box
# they were drawn from, upsample 4; 32 chains of HMC.  A short run (the
# benchmark takes 512 + 2048 draws), cut from 64 + 64 to 32 + 32 when phase
# 12 joined (the whole script took 770 s on one H100 machine and 1075 s on
# another, and a machine 1.5x slower still would leave it little of its
# 1200 s limit), to 32 + 16 when phase 14 did and to 32 + 8 when phase 15
# did.
N_MEMBERS2, N_FIELD2, N_CHAINS2 = 200, 40, 32
N_WARMUP2, N_SAMPLES2 = 32, 8
# p_member, card vs CPU plain path.  Both evaluate the plain marginal in
# float32, whose floor reaches ~1e-2 where chi2 cancels at the start of long
# segments (the conditionals' un-upsampled table; 2^-7 to 2^-3 between an
# H100 and the CPU here), and dp / d(log-odds) <= 1/4.
MEMBER_TOL = 0.25 * 1e-2


def make_data2():
    """Config-2 photometry (members, then field stars), the per-star
    membership priors and the field box's side, on the CPU from fixed
    seeds."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import (field_cmd_box, simulate_cluster,
                                             simulate_field_stars)

    grid = synthetic.make_grid(n_eep=N_EEP, device="cpu")
    gen = torch.Generator().manual_seed(30)
    cat = simulate_cluster(grid, torch.as_tensor(TRUTH), N_MEMBERS2, gen,
                           percent_binary=1.0, min_mass=0.15)
    field = simulate_field_stars(gen, N_FIELD2, cat.mags)
    sc = scatter_cluster(torch.cat([cat.mags, field]), gen, limit_mag=26.0,
                         censor=False)
    cm = np.concatenate([np.full(N_MEMBERS2, 0.9, np.float32),
                         np.full(N_FIELD2, 0.3, np.float32)])
    lo, hi = field_cmd_box(cat.mags)
    return sc.mags.numpy(), sc.sigmas.numpy(), cm, (hi - lo).numpy()


def make_model2(data2, device):
    """The config-2 model (field_membership_tpu.py:68-73): n_q 8,
    upsample 4, array membership priors and field box."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars

    mags, sig, cm, box = data2
    stars = make_ms_stars(mags, sig, cm_prior=cm, field_mag_range=box,
                          device=device)
    return post.make_single_pop_model(
        synthetic.make_grid(n_eep=N_EEP, device=device), stars, TRUTH,
        PRIOR_SIGMA, n_q=N_Q, upsample=4, device=device)


def membership_auc(p_member: np.ndarray, is_field: np.ndarray) -> float:
    """Mann-Whitney AUC: P(a member's p_member > a field star's)."""
    order = np.argsort(p_member, kind="stable")
    rank = np.empty(len(p_member), np.float64)
    rank[order] = np.arange(len(p_member))
    n_mem = int((~is_field).sum())
    u = rank[~is_field].sum() - n_mem * (n_mem - 1) / 2.0
    return float(u / (n_mem * int(is_field.sum())))


def run_config2(dev) -> dict:
    """Phase 10: config 2 end to end.  (a) chunked HMC (dense, step
    jitter, l_max 48, 5 windows) with every kernel's launches equal to the
    density calls; (b) sample_ms_masses on every 16th draw, and the
    membership posterior of the first 8 draws on the card against the CPU
    plain path; the membership AUC of members against field stars,
    asserted >= 0.95."""
    from base_tpu_torch.model import conditionals as cond
    from base_tpu_torch.model import posterior as post

    data2 = make_data2()
    model = make_model2(data2, dev)
    free = post.free_mask(model)
    is_field = np.arange(N_MEMBERS2 + N_FIELD2) >= N_MEMBERS2
    log(f"config 2: {N_MEMBERS2} members + {N_FIELD2} field stars, "
        f"{N_CHAINS2} chains, upsample 4, free {free}")

    log(f"phase 10a: chunked HMC, {N_CHAINS2} chains, dense metric, l_max "
        f"48, {N_WARMUP2} + {N_SAMPLES2} draws")
    z0 = post.default_transform(model).inverse(
        torch.as_tensor(TRUTH, device=dev))
    init = z0 + 0.01 * torch.randn(
        N_CHAINS2, 9, generator=torch.Generator().manual_seed(3)).to(dev)
    hmc, xs = run_hmc(model, TRUTH, N_CHAINS2, free, N_WARMUP2, N_SAMPLES2,
                      n_windows=5, rhat_max=None, report=(0, 1, 2, 3, 4),
                      init=init, seed=5)
    check_one_launch_per_call("config 2 HMC", hmc["launches"], hmc["evals"])

    log("phase 10b: sample_ms_masses and the membership posterior")
    draws = xs.reshape(-1, 9)[::16].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cond.sample_ms_masses(model, draws,
                                torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    model_cpu = make_model2(data2, "cpu")
    t1 = time.perf_counter()
    out_cpu = cond.sample_ms_masses(model_cpu, draws[:8].cpu(),
                                    torch.Generator().manual_seed(9))
    wall_cpu = time.perf_counter() - t1
    pm_gpu = cond.membership_posterior(model.stars, out.log_marg[:8])
    member_err = float((pm_gpu.cpu() - out_cpu.p_member).abs().max())
    marg_err = float((out.log_marg[:8].cpu() - out_cpu.log_marg)
                     .abs().max())
    pm = out.p_member.double().mean(0).cpu().numpy()
    res = dict(
        hmc=hmc, draws=int(draws.shape[0]), conditionals_wall_s=wall,
        conditionals_wall_s_cpu_8_draws=wall_cpu,
        p_member_err_vs_cpu=member_err, log_marg_err_vs_cpu=marg_err,
        p_member_cluster_mean=float(pm[~is_field].mean()),
        p_member_field_mean=float(pm[is_field].mean()),
        separation_auc=membership_auc(pm, is_field))
    log("  membership " + json.dumps({k: v for k, v in res.items()
                                      if k != "hmc"}))
    if not all(bool(torch.isfinite(t).all()) for t in
               (out.mass1, out.mass_ratio, out.log_marg, out.p_member)):
        raise AssertionError("non-finite MS conditionals")
    if not member_err <= MEMBER_TOL:
        raise AssertionError("card membership disagrees with the CPU path")
    if not res["separation_auc"] >= 0.95:
        raise AssertionError(f"membership AUC {res['separation_auc']:.3f}")
    return res


# Config 5's single-card SMC leg (BASELINE.json config 5,
# benchmarks/smc_10k_tpu.py:44-150): 10 000 stars, every one a binary, no
# censoring, upsample 4; full-rank VI, then tempered SMC from the VI
# Gaussian inflated 2x.  Cut only in particles: 2 replicates x 512 (the
# benchmark runs 4 x 1024), so a density call evaluates 1024 rows.
N_STARS5, UPSAMPLE5 = 10_000, 4
N_REP5, N_PARTICLES5 = 2, 512
# Kernel checks at S = 10 000: the plain [rows, S, T, B] tensors hold 0.65 GB
# a row, so kernels 1 and 3 are held to plain on 4 rows of the 1024 and
# kernel 4 on 2 of VI's 8.
CHECK_ROWS5_BWD = 2
# At 10 000 stars the posterior sd of the age (~0.001-0.003 dex) is below
# the model's own offset from the simulated truth: base_tpu's converged HMC
# at 10 000 stars (upsample 1) sat 0.026 dex, 7.9 sd, below it
# (benchmarks/longaxis_10k_converged.out), and this phase's SMC particles
# on an H100 0.0062 dex (5.0 of their sd) below.  So the age is held to the
# truth within that offset, not within sd.
AGE_TOL5 = 0.03
# The recipe's settings (smc_10k_tpu.py:72-75, 109-111), shared with
# scripts/torch_smc_parity.py: full-rank VI, then SMC from vi_q0.
VI_CFG5 = dict(n_steps=600, n_mc=8, full_rank=True, learning_rate=2e-2,
               init_log_sd=-4.0)
SMC_CFG5 = dict(max_stages=30, n_move=3)
VI_SEED5, SMC_SEED5 = 5, 7
NAMES5 = ("logAge", "Y", "FeH", "mod", "Av")


def make_data5():
    """Config-5 photometry through the port's simulator and noise model, on
    the CPU from fixed seeds."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    grid = synthetic.make_grid(n_eep=N_EEP, device="cpu")
    gen = torch.Generator().manual_seed(50)
    cat = simulate_cluster(grid, torch.as_tensor(TRUTH), N_STARS5, gen,
                           percent_binary=1.0, min_mass=0.15)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0, censor=False)
    return sc.mags.numpy(), sc.sigmas.numpy()


def vi_q0(res, z0, free):
    """smc_10k_tpu.py's reference distribution: the VI Gaussian with its
    free block's covariance inflated 2^2, sd 0.05 and no correlation on the
    pinned dims (centred there on z0).  Returns (sample_q0, log_q0)."""
    from base_tpu_torch.inference.vi import posterior_covariance

    freem = np.asarray(free) > 0
    mu = np.where(freem, res.mu.double().cpu().numpy(),
                  z0.double().cpu().numpy())
    cov = posterior_covariance(res).double().cpu().numpy()
    cov_q = np.eye(9) * 0.05**2
    cov_q[np.ix_(freem, freem)] = cov[np.ix_(freem, freem)] * 2.0**2
    L = np.linalg.cholesky(cov_q)
    dev = z0.device
    mu_q = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    L_q = torch.as_tensor(L, dtype=torch.float32, device=dev)
    L_inv = torch.as_tensor(np.linalg.inv(L), dtype=torch.float32,
                            device=dev)
    log_det = float(np.log(np.diag(L)).sum())

    def log_q0(z):
        e = (z - mu_q) @ L_inv.T
        return (-0.5 * (e * e).sum(-1) - log_det
                - 0.5 * 9 * math.log(2.0 * math.pi))

    def sample_q0(gen, n):
        return mu_q + torch.randn((n, 9), generator=gen,
                                  device=dev) @ L_q.T

    return sample_q0, log_q0


def config5_model(mags, sigmas, dev, upsample: int = UPSAMPLE5):
    """(model, transform, free mask, z at the truth) of config 5 on the
    photometry (mags, sigmas) [S, B]: smc_10k_tpu.py's model (the grid at
    n_eep 64, cm_prior 0.99, n_q 8) at `upsample`."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars

    model = post.make_single_pop_model(
        synthetic.make_grid(n_eep=N_EEP, device=dev),
        make_ms_stars(mags, sigmas, cm_prior=0.99, device=dev), TRUTH,
        PRIOR_SIGMA, n_q=N_Q, upsample=upsample, device=dev)
    tr = post.default_transform(model)
    z0 = tr.inverse(torch.as_tensor(TRUTH, device=dev))
    return model, tr, post.free_mask(model), z0


def run_vi5(fz, z0):
    """The recipe's VI from z0 (VI_CFG5, 100-step chunks)."""
    from base_tpu_torch.inference.vi import VIConfig, run_vi_chunked

    gen = torch.Generator(device=z0.device).manual_seed(VI_SEED5)
    return run_vi_chunked(fz, z0, gen, VIConfig(**VI_CFG5), chunk_steps=100)


def smc_runner5(fz, vres, z0, free, n_rep: int, n_particles: int):
    """The recipe's SMC runner: from vi_q0 of the VI result, SMC_CFG5,
    n_rep replicates of n_particles (call it with smc_generator5)."""
    from base_tpu_torch.inference.smc import (SMCConfig,
                                              make_smc_chunked_runner)

    sample_q0, log_q0 = vi_q0(vres, z0, free)
    return make_smc_chunked_runner(
        fz, sample_q0, log_q0, SMCConfig(n_particles=n_particles, **SMC_CFG5),
        n_rep=n_rep)


def smc_generator5(dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(SMC_SEED5)


def smc_posterior5(xs: np.ndarray, n_rep: int) -> dict:
    """smc_10k_tpu.py's posterior summary of particles xs [n_rep * N, 9]
    (replicate-major): per cluster parameter the mean, the pooled sd, the
    truth, z = (mean - truth) / sd and rep_spread (the sd of the
    replicates' means over the pooled sd)."""
    pooled_sd = xs.std(0)
    spread = xs.reshape(n_rep, -1, 9).mean(1).std(0) / np.maximum(
        pooled_sd, 1e-9)
    return {n: dict(mean=float(xs[:, i].mean()), sd=float(pooled_sd[i]),
                    truth=float(TRUTH[i]),
                    z=float((xs[:, i].mean() - TRUTH[i])
                            / max(pooled_sd[i], 1e-9)),
                    rep_spread=float(spread[i]))
            for i, n in enumerate(NAMES5)}


def check_rows(table_in, marg_in, rows, label: str) -> dict:
    """Kernels 1 and 3 on every row of the inputs against their plain
    versions on `rows`: {kernel: max abs error}, raising past FWD_TOL and
    MARGLIK_TOL."""
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    comb = tb.table_fwd_cuda(*table_in)[rows]
    comb_p = tb.table_fwd_plain(*(t[rows] for t in table_in))
    out = ml.marglik_fwd_cuda(*marg_in)[rows]
    out_p = ml.marglik_fwd_plain(*marg_in[:3],
                                 *(t[rows] for t in marg_in[3:]))
    sel = out_p > -200
    errs = {"table_fwd": float((comb - comb_p).abs().max()),
            "marglik_fwd": float((out - out_p).abs()[sel].max())}
    log(f"  [{label}] rows {rows.tolist()} of {marg_in[3].shape[0]}, S = "
        f"{marg_in[0].shape[0]}: table_fwd max|err| "
        f"{errs['table_fwd']:.3e}, marglik_fwd {errs['marglik_fwd']:.3e} "
        f"({int(sel.sum())}/{sel.numel()} values > -200)")
    if not (errs["table_fwd"] <= FWD_TOL
            and errs["marglik_fwd"] <= MARGLIK_TOL):
        raise AssertionError(f"[{label}] a kernel disagrees with plain")
    return errs


def check_bwd_rows(table_in, marg_in, rows, label: str) -> dict:
    """Kernel 2 against its plain version on every row, kernel 4 on
    `rows`: {kernel: max scaled error}, raising past GRAD_TOL and
    MARGLIK_TOL."""
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    gen = torch.Generator(device=marg_in[0].device).manual_seed(7)
    comb = tb.table_fwd_plain(*table_in)
    g = torch.randn(comb.shape, generator=gen, device=comb.device)
    names2 = ("dapp1", "dm2", "dlit", "dsecT", "dxl", "dinv_dl", "dxr",
              "dinv_dr")
    e2 = grad_errs(names2, tb.table_bwd_cuda(*table_in, g),
                   tb.table_bwd_plain(*table_in, g))[1]
    m_in = marg_in[:3] + tuple(t[rows] for t in marg_in[3:])
    out = ml.marglik_fwd_plain(*m_in)
    gs = torch.randn(out.shape, generator=gen, device=out.device)
    e4 = grad_errs(("dlo", "dhi", "dlogw"),
                   ml.marglik_bwd_cuda(*m_in, out, gs),
                   ml.marglik_bwd_plain(*m_in, out, gs))[1]
    log(f"  [{label}] table_bwd scaled err {e2:.3e} ({table_in[0].shape[0]} "
        f"rows); marglik_bwd scaled err {e4:.3e} (rows {rows.tolist()})")
    if not (e2 <= GRAD_TOL and e4 <= MARGLIK_TOL):
        raise AssertionError(f"[{label}] a backward kernel disagrees")
    return {"table_bwd": e2, "marglik_bwd": e4}


def time_rows(table_in, marg_in, rows, names, reps: int) -> dict:
    """{kernel: (kernel ms, plain ms, device ms)} for kernels `names`: the
    kernel on every row, its plain version on `rows` alone (time_pair)."""
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    t_rows = tuple(t[rows].contiguous() for t in table_in)
    m_rows = marg_in[:3] + tuple(t[rows].contiguous() for t in marg_in[3:])
    out = out_r = None
    if "marglik_bwd" in names:
        out, out_r = (ml.marglik_fwd_plain(*m_rows),
                      ml.marglik_fwd_cuda(*marg_in))
    g = torch.ones_like(table_in[0])
    fns = {
        "table_fwd": (lambda: tb.table_fwd_cuda(*table_in),
                      lambda: tb.table_fwd_plain(*t_rows)),
        "table_bwd": (lambda: tb.table_bwd_cuda(*table_in, g),
                      lambda: tb.table_bwd_plain(*t_rows, g[rows])),
        "marglik_fwd": (lambda: ml.marglik_fwd_cuda(*marg_in),
                        lambda: ml.marglik_fwd_plain(*m_rows)),
        "marglik_bwd": (
            lambda: ml.marglik_bwd_cuda(*marg_in, out_r,
                                        torch.ones_like(out_r)),
            lambda: ml.marglik_bwd_plain(*m_rows, out, torch.ones_like(out))),
    }
    return {n: time_pair(*fns[n], reps=reps) for n in names}


def run_config5(dev) -> dict:
    """Phase 11: config 5's single-card leg at 10 000 stars.  (a) full-rank
    VI (600 steps, n_mc 8), launches held to the density calls; (b) SMC
    from the VI Gaussian inflated 2x, 2 replicates x 512 particles, n_move
    3, max_stages 30, through make_smc_chunked_runner: kernels 1 and 3
    launched once per density call, kernels 2 and 4 never; every replicate
    at beta = 1, a finite log-evidence, the age within AGE_TOL5 of the
    truth;
    (c) kernels 1 and 3 against plain at S = 10 000 on 4 of the SMC's 1024
    rows, kernels 2 and 4 at VI's 8 rows, and their times beside their
    bounds at both shapes; the peak memory of the SMC run."""
    from base_tpu_torch.inference.vi import sample_posterior
    from base_tpu_torch.model import posterior as post

    t0 = time.perf_counter()
    model, tr, free, z0 = config5_model(*make_data5(), dev)
    log(f"config 5: {N_STARS5} stars, upsample {UPSAMPLE5}, free {free}; "
        f"data and model {time.perf_counter() - t0:.2f} s")

    log("phase 11a: full-rank VI, 600 steps, n_mc 8")
    fz, calls = counted(post.make_logpost_z_fn(model, tr))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vres = run_vi5(fz, z0)
    torch.cuda.synchronize()
    vi = dict(wall_s=time.perf_counter() - t0, density_calls=calls[0],
              final_elbo=float(vres.final_elbo), launches=launch_counts())
    log("  VI " + json.dumps(vi))
    check_one_launch_per_call("VI", vi["launches"], calls[0])

    log(f"phase 11b: tempered SMC, {N_REP5} replicates x {N_PARTICLES5} "
        f"particles, n_move 3, max_stages 30")
    calls[0] = 0
    runner = smc_runner5(fz, vres, z0, free, N_REP5, N_PARTICLES5)
    reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    z_part, info = runner(smc_generator5(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    xs = tr.forward(z_part).double().cpu().numpy()
    smc = dict(
        wall_s=wall, density_calls=calls[0], rows_per_call=N_REP5
        * N_PARTICLES5, ms_per_call=1e3 * wall / max(calls[0], 1),
        launches=counts, stages=info["n_stages"],
        betas_final=info["betas"][-1].tolist(),
        move_accept=info["accept"], move_scale=info["move_scale"],
        log_evidence=info["log_evidence"],
        log_evidence_se=info["log_evidence_se"],
        log_evidences=info["log_evidences"].tolist(),
        peak_memory_gb=peak_gb, posterior=smc_posterior5(xs, N_REP5))
    vi_age = tr.forward(sample_posterior(
        vres, torch.Generator(device=dev).manual_seed(8), 4096))[:, 0]
    smc.update(vi_age_mean=float(vi_age.mean()), vi_age_sd=float(vi_age.std()))
    log("  SMC " + json.dumps(smc))
    check_one_launch_per_call("SMC", counts, calls[0],
                              kernels=("table_fwd", "marglik_fwd"))
    if not bool((info["betas"][-1] >= 1.0).all()):
        raise AssertionError("an SMC replicate did not reach beta = 1")
    if not (math.isfinite(smc["log_evidence"])
            and math.isfinite(smc["log_evidence_se"])):
        raise AssertionError("non-finite SMC log-evidence")
    if not np.isfinite(xs).all():
        raise AssertionError("non-finite SMC particles")
    age = smc["posterior"]["logAge"]
    if not abs(age["mean"] - TRUTH[0]) < AGE_TOL5:
        raise AssertionError("SMC posterior misses the simulated age")

    log("phase 11c: the kernels at S = 10 000 against plain, times, bounds")
    smc["density_ms_1024_rows"] = cuda_ms(lambda: fz(z_part), reps=3)
    C = z_part.shape[0]
    rows = torch.tensor([0, C // 3, 2 * C // 3, C - 1], device=dev)
    inputs = kernel_inputs(model, z_part)
    errs = check_rows(*inputs, rows, "config 5 SMC")
    times = time_rows(*inputs, rows, ("table_fwd", "marglik_fwd"), reps=3)
    work = table_work(inputs, bwd=False)
    del inputs
    z_vi = sample_posterior(vres, torch.Generator(device=dev).manual_seed(6),
                            VI_CFG5["n_mc"])
    inputs_vi = kernel_inputs(model, z_vi)
    rows_vi = torch.arange(CHECK_ROWS5_BWD, device=dev)
    errs.update(check_bwd_rows(*inputs_vi, rows_vi, "config 5 VI"))
    times.update(time_rows(*inputs_vi, rows_vi, ("table_bwd", "marglik_bwd"),
                           reps=5))
    work.update({k: v for k, v in table_work(inputs_vi).items()
                 if k in ("table_bwd", "marglik_bwd", "marglik_bwd_skip")})
    kernels5 = {}
    for name, (ms, plain_ms, dev_ms) in times.items():
        bound_ms, bound_by = bound(*work[name])
        shape = "smc" if name in ("table_fwd", "marglik_fwd") else "vi"
        kernels5[name] = {
            f"ms_config5_{shape}": ms, f"plain_ms_config5_{shape}": plain_ms,
            f"plain_rows_config5_{shape}": int(
                (rows if shape == "smc" else rows_vi).numel()),
            f"device_ms_config5_{shape}": dev_ms,
            f"bound_ms_config5_{shape}": bound_ms,
            f"bound_by_config5_{shape}": bound_by,
            f"max_abs_err_config5_{shape}": errs[name],
            "launches_config5": vi["launches"][name] + counts[name]}
        log(f"  {name} at the config-5 {shape.upper()} shape: kernel "
            f"{ms:.4f} ms, device {dev_ms:.5f} ms; plain {plain_ms:.4f} ms "
            f"on {kernels5[name][f'plain_rows_config5_{shape}']} rows; "
            f"bound {bound_ms:.5f} ms by {bound_by}")
    log("  marglik_bwd skip rule at VI's shape: "
        + json.dumps(work["marglik_bwd_skip"]))

    log(f"phase 11d: VI warm start into chunked dense HMC, {N_CHAINS5D} "
        f"chains, chain_chunk {CHAIN_CHUNK5D}, l_max {L_MAX5D}, "
        f"{N_WARMUP5D} + {N_SAMPLES5D} draws")
    longaxis = run_longaxis5(model, vres, z0, free, smc)
    for name in kernels5:
        kernels5[name]["launches_config5_longaxis"] = \
            longaxis["launches"][name]
    return dict(vi=vi, smc=smc, longaxis=longaxis, kernels=kernels5)


# Phase 11d: config 5's long-axis path (benchmarks/longaxis_10k_converged.py:
# 85-170; at CI size and sharded, tests/test_longaxis.py) on phase 11's
# model and data and 11a's VI: the chains start from VI draws and the
# warmup metric from the VI covariance (vi.warm_start_draws: the pinned
# block a unit diagonal, as tests/test_longaxis.py:47-48), then dense HMC
# with step jitter, l_max 24, init_step 0.1 and chain_chunk 8 on 16
# chains: each density evaluation two blocks of 8 rows.  Cut only in
# length: 16 + 8 transitions in 2 windows (16 + 16 until phase 15 joined;
# the benchmark: 192 + 1024 in 6; scripts/torch_longaxis.py runs it
# whole).
N_CHAINS5D, CHAIN_CHUNK5D = 16, 8
N_WARMUP5D, N_SAMPLES5D, N_WINDOWS5D, L_MAX5D = 16, 8, 2, 24
# The chunked and the unchunked run are compared over this many
# transitions from one generator state, bit for bit where the card gives
# it, else at ROADMAP section C's float32 tolerance of the whole log_post
# (1e-4 relative), on the log densities and the positions.
N_COMPARE5D = 2
CHUNK_REL_TOL = 1e-4


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def _max_scaled(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest per-row max |a - b| over the row's max |b|."""
    return float(((a - b).abs().amax(1)
                  / b.abs().amax(1).clamp_min(1e-30)).max())


def compare_chunked(fz, init, inv_mass0, eps, cfg) -> dict:
    """N_COMPARE5D HMC transitions of `cfg` from `init` with chain_chunk
    and without it, from one generator seed: whether the states are bit
    for bit equal, else their largest relative differences, raising past
    CHUNK_REL_TOL; and each run's row counts per call."""
    from base_tpu_torch.inference import hmc

    def run(chunk):
        c = dataclasses.replace(cfg, chain_chunk=chunk)
        f, rows = counted_rows(fz)
        st = hmc.init_chains(f, init, c)
        vg = hmc.value_and_grad(f, chunk)
        gen = torch.Generator(device=init.device).manual_seed(11)
        for _ in range(N_COMPARE5D):
            st, _ = hmc.hmc_transition(vg, st, eps, inv_mass0, c, gen)
        return st, rows

    (a, rows_a), (b, rows_b) = run(cfg.chain_chunk), run(None)
    bitwise = all(torch.equal(x, y) for x, y in
                  ((a.z, b.z), (a.logpost, b.logpost), (a.grad, b.grad)))
    # One evaluation at the same points, in blocks and in one call.
    v0, g0 = hmc.value_and_grad(fz, cfg.chain_chunk)(init)
    v1, g1 = hmc.value_and_grad(fz)(init)
    res = dict(start_value_bit_for_bit=torch.equal(v0, v1),
               start_grad_bit_for_bit=torch.equal(g0, g1),
               start_value_rel_diff=_max_rel(v0, v1),
               start_grad_scaled_diff=_max_scaled(g0, g1),
               transitions=N_COMPARE5D, bit_for_bit=bitwise,
               held="bit for bit" if bitwise else "float32 tolerance",
               z_rel_diff=_max_rel(a.z, b.z),
               logpost_rel_diff=_max_rel(a.logpost, b.logpost),
               grad_scaled_diff=_max_scaled(a.grad, b.grad),
               rows_per_call=[sorted(set(rows_a)), sorted(set(rows_b))],
               calls=[len(rows_a), len(rows_b)])
    if not (bitwise or (res["z_rel_diff"] <= CHUNK_REL_TOL
                        and res["logpost_rel_diff"] <= CHUNK_REL_TOL)):
        raise AssertionError(f"11d: chunked HMC off the unchunked run: {res}")
    return res


def run_longaxis5(model, vres, z0, free, smc: dict) -> dict:
    """Phase 11d: VI warm start (11a's fit) into chunked dense HMC at
    10 000 stars.  Gates: every call one block of CHAIN_CHUNK5D rows, the
    evaluations those of the run's length, each kernel's launches equal
    to evaluations x blocks; finite draws; acceptance > 0; chunked equal
    to unchunked over N_COMPARE5D transitions (compare_chunked); kernels
    1-4 against their plain versions on 2 rows of a block of the final
    draws.  Printed: the peak memory and the wall of one density +
    gradient call on the 16 chains with chain_chunk and without, and the
    age's mean and sd beside 11a's VI and 11b's SMC."""
    from base_tpu_torch.inference import diagnostics as diag
    from base_tpu_torch.inference import hmc
    from base_tpu_torch.inference.driver import make_hmc_chunked_runner
    from base_tpu_torch.inference.vi import warm_start_draws
    from base_tpu_torch.model import posterior as post

    dev = z0.device
    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    init, inv_mass0 = warm_start_draws(
        vres, z0, torch.Generator(device=dev).manual_seed(9), N_CHAINS5D,
        free)
    cfg = hmc.HMCConfig(n_warmup=N_WARMUP5D, n_samples=N_SAMPLES5D,
                        l_max=L_MAX5D, n_windows=N_WINDOWS5D,
                        dense_mass=True, free_mask=free, jitter_mode="step",
                        init_step=0.1, chain_chunk=CHAIN_CHUNK5D)
    f, rows = counted_rows(fz)
    runner = make_hmc_chunked_runner(f, cfg, chunk_draws=N_SAMPLES5D)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs, info = runner(init, torch.Generator(device=dev).manual_seed(10),
                      inv_mass0=inv_mass0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    blocks = hmc.chain_blocks(N_CHAINS5D, CHAIN_CHUNK5D)
    evals = block_evaluations("11d", rows, N_CHAINS5D, CHAIN_CHUNK5D)
    want_evals = 1 + L_MAX5D * (
        N_WINDOWS5D * max(N_WARMUP5D // N_WINDOWS5D, 1) + N_SAMPLES5D)
    if not (blocks == 2 and evals == want_evals):
        raise AssertionError(f"11d: {evals} evaluations of {blocks} blocks "
                             f"(want {want_evals} of 2)")
    check_one_launch_per_call("11d", counts, evals, blocks=blocks)
    xs = tr.forward(zs)
    age = xs[:, :, 0]
    res = dict(
        wall_s=wall, chains=N_CHAINS5D, chain_chunk=CHAIN_CHUNK5D,
        blocks=blocks, evaluations=evals, density_calls=len(rows),
        ms_per_evaluation=1e3 * wall / evals, launches=counts,
        accept=float(info["accept_prob"]),
        step_size=float(info["step_size"]),
        age=dict(mean=float(age.mean()), sd=float(age.std()),
                 truth=float(TRUTH[0]),
                 rhat=float(diag.split_rhat(xs[:, :, :1])[0]),
                 ess=float(diag.ess(xs[:, :, :1])[0])),
        vi_age=dict(mean=smc["vi_age_mean"], sd=smc["vi_age_sd"]),
        smc_age={k: smc["posterior"]["logAge"][k] for k in ("mean", "sd")})
    if not torch.isfinite(zs).all():
        raise AssertionError("11d: non-finite HMC draws")
    if not res["accept"] > 0.0:
        raise AssertionError(f"11d: acceptance {res['accept']}")
    res["chunked_vs_unchunked"] = compare_chunked(
        fz, init, inv_mass0, info["step_size"], cfg)

    # Kernels 1-4 against plain on a block of the final draws (the shape
    # the path launches them at): kernels 1 and 3 held to plain on 2 rows,
    # kernel 2 on all 8, kernel 4 on 2.
    inputs = kernel_inputs(model, zs[-1, :CHAIN_CHUNK5D])
    rows_k = torch.tensor([0, CHAIN_CHUNK5D - 1], device=dev)
    errs = check_rows(*inputs, rows_k, "11d")
    errs.update(check_bwd_rows(*inputs, rows_k, "11d"))
    res["max_abs_err"] = errs
    del inputs

    z_last = zs[-1].contiguous()
    per_call = {}
    for chunk in (CHAIN_CHUNK5D, None):
        vg = hmc.value_and_grad(fz, chunk)
        vg(z_last)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        vg(z_last)
        torch.cuda.synchronize()
        per_call[str(chunk)] = dict(
            peak_memory_gb=(torch.cuda.max_memory_allocated() - mem0) / 1e9,
            ms=cuda_ms(lambda: vg(z_last), reps=5))
    res["per_call_16_chains"] = per_call
    log("  long-axis HMC " + json.dumps(res))
    return res


# Phase 12: the port's CLI (base_tpu_torch.tools.main) end to end, called
# in-process so that the wrappers' launch counters see it, at the widths of
# conf/base9.yaml (100 stars, 30% binaries, UBVRIJHK, nMassRatio 16, the
# default upsample 4, 64 chains, dense metric).  Only the depth is cut: 16
# warmup transitions and 16 draws a chain (32 + 32 until phase 14 joined),
# and l_max 24 (conf/base9.yaml's 48 until phase 16 joined: the phase
# checks the CLI's path and launches, not its mixing), which leaves phases
# 13-16 their time within the script's limit
# (with 8 draws the CLI's --metrics windows, a quarter of the draws, hold
# 2 draws a chain: no split R-hat).  conf/base9.yaml says
# usePallas: false, which the card refuses; settings read a later `--set
# mcmc.usePallas=auto` over that YAML boolean as false (as base_tpu's do),
# so the kernels are asked for with true.
CLI_SETS = ("mcmc.warmup=16", "mcmc.runIter=1024", "mcmc.usePallas=true",
            "mcmc.lMax=24")
# The CLI model's density check against the CPU (12a, 13b) runs on 16 of
# its 64 chains: the CPU plain density at upsample 4 holds [C, S, T, B]
# tensors of 0.9 GB at 16 chains and B = 29.  Its kernels are checked on
# all 64.
N_CHAINS_CPU_CHECK = 16
# Chains a block of the plain marginal versions on the card take at once
# (plain_blocks): the float64 residual form holds [C, S, T, B] tensors.
PLAIN_BLOCK_BYTES = 1e9
# make-cmd on the card against the CPU: one unit of the .4f format plus the
# float32 floor of the magnitudes.
CMD_TOL = 2e-4
# 12d: checkpointed HMC on the CLI's model, interrupted after chunk 1.  Its
# trajectories are cut to 4 leapfrog steps (the CLI's 48 took 146 s on an
# H100 for the three runs; resuming does not depend on the length), its
# draws to 16 (32 until phase 15 joined): two chunks.
N_CHAINS_RESUME, N_WARMUP_RESUME, N_SAMPLES_RESUME, CHUNK_RESUME = 16, 32, 16, 8
L_MAX_RESUME = 4


class _Interrupt(Exception):
    pass


def _cmd_rows(path: str):
    """(stages, values [rows, 1 + B]) of a make-cmd file."""
    raw = np.loadtxt(path, skiprows=1, dtype=str, ndmin=2)
    return raw[:, 0], raw[:, 1:].astype(np.float64)


def run_resume(s, phot: str, ckpt: str, dev) -> dict:
    """Phase 12d: run_hmc_checkpointed on the CLI's model (16 chains, 32 +
    32 draws, chunk 8, l_max 4), interrupted by an on_window that raises after
    chunk 1, then resumed from its checkpoint with a freshly seeded
    generator; against an uninterrupted run, bit for bit: draws, log
    posteriors, final chain states and the CUDA generator's state."""
    from base_tpu_torch.inference import driver
    from base_tpu_torch.inference.hmc import HMCConfig
    from base_tpu_torch.io.phot import read_phot
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.tools import main as cli

    model = cli._build_model_from_phot(s, read_phot(phot), dev)
    tr = post.default_transform(model)
    fz = post.make_logpost_z_fn(model, tr)
    cfg = HMCConfig(n_warmup=N_WARMUP_RESUME, n_samples=N_SAMPLES_RESUME,
                    l_max=L_MAX_RESUME, target_accept=s.mcmc.targetAccept,
                    dense_mass=s.mcmc.denseMass,
                    free_mask=post.free_mask(model))
    z0 = tr.inverse(torch.as_tensor(s.cluster.start_vector(), device=dev))
    init = cli._start_chains(z0, N_CHAINS_RESUME, s)

    def run(path, on_window=None):
        gen = cli._gen(dev, s.mcmc.seed, 1)
        zs, info = driver.run_hmc_checkpointed(
            fz, init, gen, cfg, driver.DriverConfig(
                checkpoint_path=path, chunk_size=CHUNK_RESUME,
                on_window=on_window))
        return zs, info, gen.get_state()

    def stop(ci, zs, lps):
        if ci == 1:
            raise _Interrupt

    t0 = time.perf_counter()
    want = run(None)
    try:
        run(ckpt, stop)
        raise AssertionError("12d: the interrupting on_window never ran")
    except _Interrupt:
        pass
    got = run(ckpt)
    torch.cuda.synchronize()
    fields = dict(
        samples=(want[0], got[0]),
        logposts=(want[1]["logposts"], got[1]["logposts"]),
        final_z=(want[1]["final_states"].z, got[1]["final_states"].z),
        final_logpost=(want[1]["final_states"].logpost,
                       got[1]["final_states"].logpost),
        step_size=(want[1]["step_size"], got[1]["step_size"]),
        inv_mass=(want[1]["inv_mass"], got[1]["inv_mass"]),
        generator_state=(want[2], got[2]))
    same = {k: torch.equal(a, b) for k, (a, b) in fields.items()}
    res = dict(wall_s=time.perf_counter() - t0, bit_identical=same,
               accept=float(got[1]["accept_prob"]))
    log("  resume " + json.dumps(res))
    if not all(same.values()):
        raise AssertionError(f"12d: resumed run differs: {same}")
    return res


def cli_model(s, table, dev, n_chains: int):
    """The model the CLI builds from its .phot, and n_chains points around
    the config's start (the chains the CLI starts from)."""
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.tools import main as cli

    model = cli._build_model_from_phot(s, table, dev)
    z = chain_points(model, 0.05, seed=1, truth=s.cluster.start_vector(),
                     n_chains=n_chains, free=post.free_mask(model))
    return model, z


def check_cli_model(s, table, dev, label: str = "12a") -> dict:
    """Phase 12a's model check: the model the CLI builds from its .phot
    (n_q 16, upsample 4, its WDs with carbonicity and the IFMR free), at
    the CLI's chains around its start: each kernel against its plain
    version (kernels 3-4 on the MS and the WD segment tables), and log_post
    + gradient on the card against the CPU plain path on the first
    N_CHAINS_CPU_CHECK chains, twice bit for bit.  Returns {kernel: max abs
    error}; raises past the tolerances."""
    from base_tpu_torch.tools import main as cli

    model, z = cli_model(s, table, dev, s.mcmc.chains)
    n_wd = 0 if model.wd_stars is None else model.wd_stars.obs_mags.shape[0]
    log(f"phase {label}: the CLI's model ({model.stars.obs_mags.shape[0]} "
        f"MS stars, {n_wd} WDs, {model.stars.obs_mags.shape[1]} bands, n_q "
        f"{model.q_grid.shape[-1]}, upsample {model.upsample}): kernels vs "
        f"plain on {z.shape[0]} chains, density card vs CPU on "
        f"{N_CHAINS_CPU_CHECK}")
    errs = check_kernels(model, z, f"cli {label}")
    if model.wd_stars is not None:
        wd = check_marglik(wd_marglik_inputs(model, z), f"cli {label} WD")
        errs = {k: max(v, wd.get(k, 0.0)) for k, v in errs.items()}
    check_density(model, cli._build_model_from_phot(s, table, "cpu"),
                  z[:N_CHAINS_CPU_CHECK])
    return errs


def run_cli(dev, hmc_res: dict) -> dict:
    """Phase 12: (a) simulate -> scatter; the CLI's model from that .phot
    checked (check_cli_model); single-pop --metrics, each
    kernel's launches over single-pop equal to the density calls the CLI
    counted (kernels 3-4 once per segment table: twice with WDs), 1024
    finite .res rows, the age within 4 sd of the simulated truth, split
    R-hat of the age beside phase 4's; (b) sample-mass; (c) make-cmd on
    the card and, as a subprocess through `python -m`, on the CPU, within
    CMD_TOL; (d) checkpointed HMC interrupted and resumed, bit for bit."""
    import os
    import tempfile
    from pathlib import Path

    from base_tpu_torch.io.phot import read_phot
    from base_tpu_torch.io.res import read_res
    from base_tpu_torch.io.samples import read_star_samples
    from base_tpu_torch.io.settings import load_settings
    from base_tpu_torch.tools import main as cli

    root = Path(__file__).resolve().parent
    conf = str(root / "conf" / "base9.yaml")
    sets = [a for x in CLI_SETS for a in ("--set", x)]
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "run")
        args = ["--config", conf, "--outputFileBase", base, *sets,
                "--device", str(dev)]

        def tool(name, *extra):
            t0 = time.perf_counter()
            cli.main([name, *args, *extra])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0

        log("phase 12a: simulate -> scatter -> single-pop --metrics")
        tool("simulate")
        tool("scatter", "--photFile", base + ".sim.phot")
        table = read_phot(base + ".phot")
        n_wd = int((table.stage == 3).sum())
        errs = check_cli_model(load_settings(conf, list(CLI_SETS)), table,
                               dev, "12a")
        reset_launch_counts()
        metrics_path = os.path.join(tmp, "m.jsonl")
        tool("single-pop", "--photFile", base + ".phot",
             "--metrics", metrics_path)
        counts = launch_counts()
        with open(metrics_path) as f:
            metrics = [json.loads(line) for line in f][-1]
        calls = metrics["density_calls"]
        tables = 2 if n_wd else 1
        want = {k: calls * (tables if k.startswith("marglik") else 1)
                for k in counts}
        chain = read_res(base + ".res")
        age = chain.params[:, 0]
        res = dict(
            stars=int(table.n_stars), wds=n_wd, density_calls=calls,
            launches=counts, rows=int(chain.params.shape[0]),
            samples_per_s=metrics["samples_per_sec"],
            evals_per_s=metrics["evals_per_sec"],
            single_pop_wall_s=metrics["wall_s"],
            calls_per_s=calls / metrics["wall_s"],
            accept=metrics["accept"], ess_age=metrics["ess_age"],
            ess_age_per_s=metrics["ess_age"] / metrics["wall_s"],
            rhat_age=metrics["rhat_age"],
            rhat_age_phase4=hmc_res["rhat"]["logAge"],
            age=dict(mean=float(age.mean()), sd=float(age.std()),
                     truth=float(load_settings(conf).cluster
                                 .starting_logAge)))
        res["max_abs_err"] = errs
        log("  single-pop " + json.dumps(res))
        if counts != want:
            raise AssertionError(f"12a: launches {counts} for {calls} "
                                 f"density calls and {tables} tables "
                                 f"(want {want})")
        rows = load_settings(conf, list(CLI_SETS)).mcmc.runIter
        if res["rows"] != rows or not (np.isfinite(chain.params).all()
                                       and np.isfinite(chain.logpost).all()):
            raise AssertionError(f"12a: the .res is not {rows} finite rows")
        if not abs(res["age"]["mean"] - res["age"]["truth"]) < \
                4.0 * res["age"]["sd"]:
            raise AssertionError("12a: the CLI's age misses the truth")

        log("phase 12b: sample-mass")
        tool("sample-mass", "--photFile", base + ".phot")
        ids, cols = read_star_samples(base + ".massSamples")
        mids, mcols = read_star_samples(base + ".membership")
        n_ms = int((table.stage == 1).sum())
        pm = mcols["pMember"]
        res["sample_mass"] = dict(stars=len(ids), draws=int(pm.shape[0]),
                                  p_member_mean=float(pm.mean()))
        if not (len(ids) == n_ms == cols["mass"].shape[1] and mids == ids
                and ((pm >= 0) & (pm <= 1)).all()
                and np.isfinite(cols["mass"]).all()):
            raise AssertionError("12b: sample-mass output malformed")

        log("phase 12c: make-cmd on the card, and on the CPU via python -m")
        tool("make-cmd")
        cpu_base = os.path.join(tmp, "cpu")
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "base_tpu_torch.tools.main", "make-cmd",
             "--config", conf, "--outputFileBase", cpu_base, *sets,
             "--device", "cpu"],
            cwd=root, check=True, timeout=600)
        walls["make-cmd (cpu, subprocess)"] = time.perf_counter() - t0
        st_g, v_g = _cmd_rows(base + ".cmd")
        st_c, v_c = _cmd_rows(cpu_base + ".cmd")
        if st_g.shape != st_c.shape or not (st_g == st_c).all():
            raise AssertionError("12c: card and CPU CMDs differ in rows")
        cmd_err = float(np.abs(v_g - v_c).max())
        res["make_cmd"] = dict(rows=int(len(st_g)),
                               wd_rows=int((st_g == "WD").sum()),
                               max_abs_err_vs_cpu=cmd_err)
        log("  make-cmd " + json.dumps(res["make_cmd"]))
        if not cmd_err <= CMD_TOL:
            raise AssertionError(f"12c: CMD card vs CPU {cmd_err:.2e}")

        log(f"phase 12d: checkpointed HMC, {N_CHAINS_RESUME} chains, "
            f"{N_WARMUP_RESUME} + {N_SAMPLES_RESUME}, chunk {CHUNK_RESUME}, "
            f"l_max {L_MAX_RESUME}, interrupted after chunk 1 and resumed")
        res["resume"] = run_resume(load_settings(conf, list(CLI_SETS)),
                                   base + ".phot",
                                   os.path.join(tmp, "resume.ckpt"), dev)
    res["tool_wall_s"] = walls
    return res


# Phase 13: wide band sets through the grid ingest.  13a writes
# upstream-format text grids with the port's writers (conf/base9.yaml's MS
# family, its synthetic axis spans, in all 29 bands of grids/filters.py;
# carbonicity-resolved WD cooling tracks; Bergeron DA/DB tables in the same
# bands), packs them with `python -m base_tpu_torch.tools.main
# convert-models`, and reads a table back through the native IO runtime.
# 13b runs the CLI at conf/base9.yaml's widths on those grids with B = 29,
# cut in depth: 16 warmup transitions and 16 draws a chain, as phase 12
# (64 + 64 took 125-276 s at B = 8 by host; 32 + 32 until phase 14
# joined); its model's
# density is checked against the CPU on N_CHAINS_CPU_CHECK of its chains.
# 13c drives the matmul form
# (kernels 3m and 4m) at the bench shapes (B = 8) and on 13b's MS table (B
# = 29).
# l_max 24 (conf/base9.yaml's 48 until phase 16 joined): the phase checks
# the ingest, the 29-band kernels and the CLI's launches, not the mixing.
WIDE_SETS = ("mcmc.warmup=16", "mcmc.runIter=1024", "mcmc.usePallas=true",
             "mcmc.lMax=24")
# Calls of each plain version timed at B = 29 (44-85 ms a call for kernels
# 3-4; 20 until phase 16 joined).
PLAIN_REPS_B29 = 4
# 13c: the seeds of the chain points at which kernels 3m and 4m are
# checked at each width (seed 1: the points the phase times), the value +
# gradient calls of fused_log_marginals(..., matmul=True) that make up the
# matmul form's own path at each width, and the calls of its plain
# versions timed (they emulate the kernels' FMA chain in float64).
MM_SEEDS = (1, 2, 3)
MM_PATH_CALLS = 10
MM_PLAIN_REPS = 2
# The matmul form cancels in float32 (sum_b iv obs^2 reaches ~1e6 at 29
# bands and sigma 0.01, against chi2 ~ 1), so it sits up to whole nats from
# the float64 marginal.  Its plain version sums the products in the
# kernels' order with their rounding, so kernels 3m and 4m are held to it
# at MARGLIK_TOL, as kernels 3 and 4 are to theirs; the residual form
# (kernels 3 and 4 on the same inputs), put in their place, must fail that
# gate.  Against the float64 residual form each is held to MM_REL times
# the plain version's own distance from it, plus MM_ABS (forward, abs) or
# MARGLIK_TOL (backward, scaled).
MM_REL, MM_ABS = 2.0, 1e-4


def write_text_grids(src: str, s) -> tuple:
    """13a: the port's writers put the grids of `s`'s families in upstream
    text format under `src`: the synthetic MS family (its axis spans) in
    every band of grids/filters.py, WD cooling tracks, Bergeron DA/DB.
    Returns (bands, the MS grid written)."""
    import os

    from base_tpu_torch.grids import filters, load, parse, synthetic
    from base_tpu_torch.grids import wd_atmosphere as wda
    from base_tpu_torch.grids import wd_cooling as wdc

    bands = tuple(filters.FILTERS)
    family = s.models.msRgbModel.lower()
    spans = load.SYNTHETIC_SPANS[family]
    ms = synthetic.make_grid(feh_axis=np.linspace(*spans["feh"]),
                             y_axis=np.linspace(*spans["y"]),
                             age_axis=np.linspace(*spans["age"]),
                             bands=bands, name=family, device="cpu")
    parse.write_ms_model(os.path.join(src, f"{family}.ms"), ms)
    parse.write_wd_cooling(os.path.join(src, f"{s.models.wdModel}.wd"),
                           wdc.synthetic_wd_cooling(device="cpu"))
    atm = wda.synthetic_bergeron(bands=bands, device="cpu")
    for wd_type, name in enumerate(("Table_DA", "Table_DB")):
        parse.write_bergeron_table(os.path.join(src, name), atm, wd_type)
    return bands, ms


def check_native_io(table_path: str, out_path: str) -> dict:
    """13a: the native runtime is loaded (no fallback), parses a written
    Bergeron table as numpy does, and its AsyncWriter writes every row in
    order."""
    from base_tpu_torch.io import native

    if not native.native_available():
        raise AssertionError("13a: the native IO library did not build")
    got, header = native.parse_table(table_path)
    want = np.loadtxt(table_path, skiprows=1, ndmin=2)
    with open(table_path) as f:
        first = f.readline().strip()
    if header != first or got.shape != want.shape or \
            not np.array_equal(got, want):
        raise AssertionError("13a: native parse_table disagrees with numpy")
    rows = [" ".join(f"{v:.6f}" for v in r) + "\n" for r in want]
    with native.AsyncWriter(out_path) as w:
        for r in rows:
            w.write(r)
    with open(out_path) as f:
        if f.read() != "".join(rows):
            raise AssertionError("13a: AsyncWriter output differs")
    res = dict(library=str(native.library_path().name),
               table_shape=list(got.shape), rows_written=len(rows))
    log("  native io " + json.dumps(res))
    return res


def mm_skip_shares(marg_in) -> dict | None:
    """Kernel 4m's group rule (ops.marglik.marglik_mm_bwd_group_skip) on
    these inputs, centered as the kernel takes them: the (chain, star,
    32-segment group)s with a live segment (`pairs`) and those the rule
    marks; the live elements of the pairs it keeps (`kept`: the full path)
    and of the pairs holding a non-zero weight of marglik_mm_bwd_plain
    (`nonzero`: the star-axis products).  Raises if a marked pair holds a
    non-zero weight.  None for a checkout without the rule."""
    from base_tpu_torch.ops import marglik as ml

    if not hasattr(ml, "marglik_mm_bwd_group_skip"):
        return None
    obs, lo, hi = ml.center_bands(marg_in[0], marg_in[1], marg_in[3],
                                  marg_in[4])
    cent = (obs, marg_in[1], marg_in[2], lo, hi, *marg_in[5:])
    S, B = obs.shape
    C, T = lo.shape[:2]
    step = max(1, 2**26 // (S * T * B))   # the float64 FMA emulation
    n = dict(pairs=0, marked=0, kept=0, nonzero=0, misses=0, live=0)
    for c0 in range(0, C, step):
        blk = cent[:3] + tuple(t[c0:c0 + step] for t in cent[3:])
        out = ml.marglik_mm_fwd_plain(*blk)
        marked = ml.marglik_mm_bwd_group_skip(*blk, out)
        gw = ml._cotangent_weights(
            *ml._abg_mm(blk[0], blk[1], blk[3], blk[4]), blk[2], blk[5],
            blk[6], out, torch.ones_like(out))[0]
        Cb, G = marked.shape[0], marked.shape[2]
        pad = G * 32 - T
        live = torch.nn.functional.pad(blk[6] > 0.5, (0, pad)) \
            .reshape(Cb, 1, G, 32).expand(Cb, S, G, 32)
        nz = torch.nn.functional.pad(gw != 0.0, (0, pad)) \
            .reshape(Cb, S, G, 32).any(-1)
        per_pair = live.sum(-1)                       # live elements
        n["live"] += int(per_pair.sum())
        n["pairs"] += int((per_pair > 0).sum())
        n["marked"] += int(marked.sum())
        n["kept"] += int(per_pair[~marked].sum())
        n["nonzero"] += int(per_pair[nz].sum())
        n["misses"] += int((marked & nz).sum())
    if n["misses"]:
        raise AssertionError(f"13c: kernel 4m's group rule marks "
                             f"{n['misses']} pairs holding a non-zero weight")
    return dict(n, group_rule_share=n["marked"] / max(n["pairs"], 1),
                kept_share=n["kept"] / max(n["live"], 1),
                nonzero_share=n["nonzero"] / max(n["live"], 1))


def marglik_mm_work(marg_in) -> dict:
    """{kernel: (flops, bytes)} of kernels 3m and 4m (see kernel_work),
    with 4m's dense count and its skip shares (mm_skip_shares).  Per live
    element, 3m: the five expanded products 10B, gamma's assembly 4,
    core_width and the online update ~105.  4m: per (group, star) pair with
    a live segment, the group rule and c0, 15B + 10; per live element of
    the pairs it keeps, the products again, core_width, the moments and
    weight, 10B + 147; per live element of a pair with a non-zero weight,
    the five star-axis products, 10B; per (segment, band) the assembly of
    dlo and dhi, 14.  `marglik_mm_bwd_dense`: every live element at the
    full path, 20B + 147, PR 8's count (its kernel had no skip).  Bytes as
    kernels 3-4."""
    B = marg_in[0].shape[1]
    C, T = marg_in[3].shape[:2]
    live, fwd_bytes, bwd_bytes = _marglik_sizes(marg_in)
    skips = mm_skip_shares(marg_in)
    dense = live * (20 * B + 147) + 14 * C * T * B
    return {
        "marglik_mm_fwd": (live * (10 * B + 109), fwd_bytes),
        "marglik_mm_bwd": ((skips["pairs"] * (15 * B + 10)
                            + skips["kept"] * (10 * B + 147)
                            + skips["nonzero"] * 10 * B + 14 * C * T * B)
                           if skips else dense, bwd_bytes),
        "marglik_mm_bwd_dense": (dense, bwd_bytes),
        "marglik_mm_bwd_skip": skips,
    }


def check_mm(marg_in, label: str) -> dict:
    """Kernels 3m and 4m against their plain versions on every chain of
    the centered inputs, each backward given its own forward's output:
    forward abs and backward scaled error within MARGLIK_TOL.  Kernels 3
    and 4 on the same inputs (the residual form) are the control: they
    must sit past that gate.  Both kernels against the float64 residual
    form within MM_REL x the plain version's distance from it, plus MM_ABS
    (forward) or MARGLIK_TOL (backward).  Returns the errors, with
    {kernel: max abs error against plain}; raises on any miss."""
    from base_tpu_torch.ops import marglik as ml

    obs, lo, hi = ml.center_bands(marg_in[0], marg_in[1], marg_in[3],
                                  marg_in[4])
    args = (obs, marg_in[1], marg_in[2], lo, hi, *marg_in[5:])
    args64 = tuple(t.double() for t in args)
    got = ml.marglik_mm_fwd_cuda(*args)
    ctrl = ml.marglik_fwd_cuda(*args)
    plain = plain_blocks(ml.marglik_mm_fwd_plain, args)
    ref = plain_blocks(ml.marglik_fwd_plain, args64)
    sel = ref > -200

    def fwd_dist(a, b):
        return float((a.double() - b.double()).abs()[sel].max())

    gen = torch.Generator(device=plain.device).manual_seed(7)
    g = torch.randn(plain.shape, generator=gen, device=plain.device)
    names = ("dlo", "dhi", "dlogw")
    # Each backward on its own forward's output, as autograd pairs them:
    # the softmax weights exp(core - out') follow chi2's rounding.
    bwd = ml.marglik_mm_bwd_cuda(*args, got, g)
    bwd_ctrl = ml.marglik_bwd_cuda(*args, ctrl, g)
    bwd_plain = plain_blocks(ml.marglik_mm_bwd_plain, args, plain, g)
    bwd_ref = plain_blocks(ml.marglik_bwd_plain, args64, ref, g.double())
    bwd_abs, bwd_scaled, report = grad_errs(names, bwd, bwd_plain)
    plain_err = fwd_dist(plain, ref)
    plain64 = grad_errs(names, bwd_plain, bwd_ref)[1]
    res = dict(fwd_err=fwd_dist(got, plain), bwd_scaled=bwd_scaled,
               bwd_abs=bwd_abs, control_fwd_err=fwd_dist(ctrl, plain),
               control_bwd_scaled=grad_errs(names, bwd_ctrl, bwd_plain)[1],
               fwd_err_vs_float64=fwd_dist(got, ref),
               plain_err_vs_float64=plain_err,
               fwd_budget_vs_float64=MM_REL * plain_err + MM_ABS,
               bwd_scaled_vs_float64=grad_errs(names, bwd, bwd_ref)[1],
               plain_bwd_scaled_vs_float64=plain64,
               bwd_budget_vs_float64=MM_REL * plain64 + MARGLIK_TOL)
    log(f"  [{label}] mm C={lo.shape[0]} "
        f"S={obs.shape[0]} T={lo.shape[1]} B={obs.shape[1]}: "
        f"{json.dumps(res)}; bwd abs/scaled {report}")
    if not (res["fwd_err"] <= MARGLIK_TOL and bwd_scaled <= MARGLIK_TOL):
        raise AssertionError(f"[{label}] a matmul-form kernel disagrees with "
                             f"its plain version past {MARGLIK_TOL}")
    if not (res["control_fwd_err"] > MARGLIK_TOL
            and res["control_bwd_scaled"] > MARGLIK_TOL):
        raise AssertionError(f"[{label}] the residual form passes the "
                             f"matmul form's gate: it tells nothing here")
    if not (res["fwd_err_vs_float64"] <= res["fwd_budget_vs_float64"]
            and res["bwd_scaled_vs_float64"]
            <= res["bwd_budget_vs_float64"]):
        raise AssertionError(f"[{label}] a matmul-form kernel past its "
                             f"float64 budget")
    return dict(res, max_abs_err={"marglik_mm_fwd": res["fwd_err"],
                                  "marglik_mm_bwd": bwd_abs})


def mm_path(inputs: dict) -> dict:
    """The matmul form's own path: MM_PATH_CALLS value + gradient calls of
    fused_log_marginals(..., matmul=True) on each width's inputs, counts
    reset just before and read just after; each of kernels 3m and 4m
    launched once a call, and no other kernel."""
    from base_tpu_torch.ops import marglik as ml

    reset_launch_counts()
    calls = 0
    for marg_in in inputs.values():
        leaves = [t.clone().requires_grad_(True) for t in marg_in[3:6]]
        for _ in range(MM_PATH_CALLS):
            out = ml.fused_log_marginals(*marg_in[:3], *leaves, marg_in[6],
                                         matmul=True)
            grads = torch.autograd.grad(out.sum(), leaves)
            calls += 1
        if not all(bool(torch.isfinite(x).all()) for x in (out, *grads)):
            raise AssertionError("13c: the matmul form is not finite")
    torch.cuda.synchronize()
    counts = launch_counts((*KERNELS, *MM_KERNELS))
    want = {k: (calls if k in MM_KERNELS else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"13c: launches {counts} for {calls} calls")
    return counts


def time_mm(marg_in) -> dict:
    """Kernels 3, 3m, 4 and 4m on the same inputs (3m and 4m on them
    centered): time_pair against the plain version of each (MM_PLAIN_REPS
    calls of the matmul form's), and bounds."""
    from base_tpu_torch.ops import marglik as ml

    obs, lo, hi = ml.center_bands(marg_in[0], marg_in[1], marg_in[3],
                                  marg_in[4])
    cent = (obs, marg_in[1], marg_in[2], lo, hi, *marg_in[5:])
    out = ml.marglik_fwd_plain(*marg_in)
    out_mm = ml.marglik_mm_fwd_plain(*cent)
    gs = torch.ones_like(out)
    times = dict(time_marglik(marg_in))
    times["marglik_mm_fwd"] = time_pair(
        lambda: ml.marglik_mm_fwd_cuda(*cent),
        lambda: ml.marglik_mm_fwd_plain(*cent), plain_reps=MM_PLAIN_REPS)
    times["marglik_mm_bwd"] = time_pair(
        lambda: ml.marglik_mm_bwd_cuda(*cent, out_mm, gs),
        lambda: ml.marglik_mm_bwd_plain(*cent, out_mm, gs),
        plain_reps=MM_PLAIN_REPS)
    work = {**marglik_work(marg_in, bwd=True), **marglik_mm_work(marg_in)}
    res = {}
    for name, (ms, plain_ms, dev) in times.items():
        bound_ms, by = bound(*work[name])
        res[name] = dict(ms=ms, plain_ms=plain_ms, device_ms=dev,
                         bound_ms=bound_ms, bound_by=by,
                         roofline_share=bound_ms / dev)
        if name in ("marglik_bwd", "marglik_mm_bwd"):
            res[name].update(bound_ms_dense=bound(*work[f"{name}_dense"])[0],
                             skip=work[f"{name}_skip"])
    return res


def run_wide(dev, bench) -> dict:
    """Phase 13: (a) text grids in 29 bands -> convert-models -> native IO;
    (b) the CLI on the converted grids at B = 29: the model checked
    (check_cli_model), single-pop --metrics with every
    kernel's launches held to the density calls counted, the age within 4
    sd of the truth; kernels 1-4 timed beside their bounds on its 64
    chains; (c) the matmul form against its plain version and float64 at
    `bench` = (model, z) (B = 8) and on 13b's MS table (B = 29), at the
    chain points of each of MM_SEEDS, its own path's launches, and each
    form's device ms beside its bound."""
    import os
    import tempfile
    from pathlib import Path

    from base_tpu_torch.grids import load
    from base_tpu_torch.io.phot import read_phot
    from base_tpu_torch.io.res import read_res
    from base_tpu_torch.io.settings import load_settings
    from base_tpu_torch.tools import main as cli

    root = Path(__file__).resolve().parent
    conf = str(root / "conf" / "base9.yaml")
    res, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "text"), os.path.join(tmp, "npz")
        os.makedirs(src)
        log("phase 13a: text grids in 29 bands -> convert-models -> "
            "native IO")
        t0 = time.perf_counter()
        bands, ms = write_text_grids(src, load_settings(conf))
        walls["write text grids"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "base_tpu_torch.tools.main",
             "convert-models", "--config", conf, "--src", src, "--dst", dst],
            cwd=root, check=True, timeout=600, capture_output=True,
            text=True)
        walls["convert-models (subprocess)"] = time.perf_counter() - t0
        written = sorted(os.listdir(dst))
        log("  " + proc.stdout.strip().replace("\n", "\n  "))
        if written != ["bergeron.npz", f"{ms.name}.npz", "wd_montgomery.npz"]:
            raise AssertionError(f"13a: convert-models wrote {written}")
        sets = (*WIDE_SETS, f"files.modelDirectory={dst}",
                "models.bands=" + ",".join(bands))
        s = load_settings(conf, list(sets))
        bundle = load.make_model(s, device="cpu")
        if not (bundle.ms.bands == bands == bundle.wd_atm.bands
                and bundle.ms.name == ms.name):
            raise AssertionError("13a: the packed grids' bands or names")
        back = float((bundle.ms.mags - ms.mags).abs().max())
        if not back <= 5e-6:   # the text's 6 decimals
            raise AssertionError(f"13a: packed MS mags {back:.2e} off")
        res["ingest"] = dict(written=written, bands=len(bands),
                             ms_mags_max_abs_err=back, **check_native_io(
                                 os.path.join(src, "Table_DA"),
                                 os.path.join(tmp, "async.txt")))

        base = os.path.join(tmp, "run")
        args = ["--config", conf, "--outputFileBase", base,
                *[a for x in sets for a in ("--set", x)], "--device",
                str(dev)]

        def tool(name, *extra):
            t0 = time.perf_counter()
            cli.main([name, *args, *extra])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0

        log("phase 13b: simulate -> scatter -> single-pop --metrics at 29 "
            "bands on the converted grids")
        tool("simulate")
        tool("scatter", "--photFile", base + ".sim.phot")
        table = read_phot(base + ".phot")
        n_wd = int((table.stage == 3).sum())
        res["max_abs_err"] = check_cli_model(s, table, dev, "13b")
        model, z = cli_model(s, table, dev, s.mcmc.chains)
        if model.stars.obs_mags.shape[1] != len(bands):
            raise AssertionError("13b: the CLI's model lost bands")
        reset_launch_counts()
        metrics_path = os.path.join(tmp, "m.jsonl")
        tool("single-pop", "--photFile", base + ".phot",
             "--metrics", metrics_path)
        counts = launch_counts((*KERNELS, *MM_KERNELS))
        with open(metrics_path) as f:
            metrics = [json.loads(line) for line in f][-1]
        calls = metrics["density_calls"]
        tables = 2 if n_wd else 1
        want = {k: (0 if k in MM_KERNELS else calls
                    * (tables if k.startswith("marglik") else 1))
                for k in counts}
        chain = read_res(base + ".res")
        age = chain.params[:, 0]
        rows = s.mcmc.runIter
        res.update(
            stars=int(table.n_stars), wds=n_wd, bands=len(bands),
            density_calls=calls, launches=counts,
            rows=int(chain.params.shape[0]),
            samples_per_s=metrics["samples_per_sec"],
            evals_per_s=metrics["evals_per_sec"],
            single_pop_wall_s=metrics["wall_s"],
            calls_per_s=calls / metrics["wall_s"],
            accept=metrics["accept"], ess_age=metrics["ess_age"],
            rhat_age=metrics["rhat_age"],
            age=dict(mean=float(age.mean()), sd=float(age.std()),
                     truth=float(s.cluster.starting_logAge)))
        log("  single-pop " + json.dumps(res))
        if counts != want:
            raise AssertionError(f"13b: launches {counts} for {calls} "
                                 f"density calls and {tables} tables "
                                 f"(want {want})")
        if res["rows"] != rows or not (np.isfinite(chain.params).all()
                                       and np.isfinite(chain.logpost).all()):
            raise AssertionError(f"13b: the .res is not {rows} finite rows")
        if not abs(res["age"]["mean"] - res["age"]["truth"]) < \
                4.0 * res["age"]["sd"]:
            raise AssertionError("13b: the CLI's age misses the truth")

    log("phase 13b: kernels 1-4 at B = 29 (the CLI's 64 chains): times "
        "and bounds")
    times = time_kernels(model, z, plain_reps=PLAIN_REPS_B29)
    work = kernel_work(model, z)
    res["kernels_b29"] = {}
    for name in KERNELS:
        ms_, plain_ms, dev_ms = times[name]
        bound_ms, by = bound(*work[name])
        res["kernels_b29"][name] = dict(
            ms=ms_, plain_ms=plain_ms, device_ms=dev_ms, bound_ms=bound_ms,
            bound_by=by, roofline_share=bound_ms / dev_ms)
    log("  " + json.dumps(res["kernels_b29"]))

    log("phase 13c: the matmul form (kernels 3m, 4m) at B = 8 and B = 29")
    from base_tpu_torch.model import posterior as post

    points = {
        "bench": lambda seed: chain_points(bench[0], 0.05, seed=seed),
        "b29": lambda seed: chain_points(
            model, 0.05, seed=seed, truth=s.cluster.start_vector(),
            n_chains=s.mcmc.chains, free=post.free_mask(model))}
    models = {"bench": bench[0], "b29": model}
    res["mm_check"] = {
        f"{k} seed {seed}": check_mm(
            kernel_inputs(models[k], points[k](seed))[1], f"{k} seed {seed}")
        for k in points for seed in MM_SEEDS}
    inputs = {"bench": kernel_inputs(*bench)[1],
              "b29": kernel_inputs(model, z)[1]}
    res["mm_launches"] = mm_path(inputs)
    res["mm_times"] = {k: time_mm(v) for k, v in inputs.items()}
    for label, t in res["mm_times"].items():
        log(f"  [{label}] device ms: " + ", ".join(
            f"{k} {v['device_ms']:.5f} (bound {v['bound_ms']:.5f} by "
            f"{v['bound_by']}, share {v['roofline_share']:.3f})"
            for k, v in t.items()))
        mm = t["marglik_mm_bwd"]
        log(f"  [{label}] 4m's group rule {json.dumps(mm['skip'])}; bound "
            f"with every live element at full cost "
            f"{mm['bound_ms_dense']:.5f} ms")
    res["tool_wall_s"] = walls
    return res


# Phase 14: the parallel layer (base_tpu_torch.parallel) on the card.
# 14a: a world of one in this process (NCCL by the backend rule), mesh 1 x
# 1 on cuda:0: local_logpost_fn on phase 4's model and chains against the
# unsharded card density, bit for bit, and run_hmc_sharded against run_hmc
# given the chain-shard-0 generator, bit for bit.  14c: the CLI's
# `single-pop --mesh 1,2` at phase 12's settings (two ranks it spawns on
# the card).  14b: a world of two ranks spawned here on the one card (gloo:
# two ranks share it), at meshes (1, 2) and (2, 1): the star-sharded
# density against the unsharded card density on config 1 (100 stars, and
# 99 stars, which pad to 100), and at config 5's 10 000 stars; sharded
# HMC on config 1; and the CLI model's sharded checkpointed HMC
# interrupted and resumed.  Its HMC takes phase 4's settings with l_max 8
# (phase 4's 48 would take ~6x the time; the checks do not depend on it),
# 16 + 16 transitions (32 + 32 until phase 15 joined).
MESHES14 = ((1, 2), (2, 1))
N_WARMUP14, N_SAMPLES14, L_MAX14 = 16, 16, 8
# tests/test_parallel.py:106-111: the star sum reassociated across shards.
SHARD_VALUE_RTOL = 1e-5
SHARD_GRAD_RTOL, SHARD_GRAD_ATOL = 5e-3, 2e-3   # atol x the largest |grad|
N_ROWS5_GRAD = 8
WORLD14_TIMEOUT_S = 300.0


def hmc14_cfg():
    from base_tpu_torch.inference.hmc import HMCConfig

    return HMCConfig(n_warmup=N_WARMUP14, n_samples=N_SAMPLES14,
                     l_max=L_MAX14, dense_mass=True, free_mask=FREE,
                     jitter_mode="step")


def hmc14_init(model):
    """Phase 4's start: the truth jittered by 0.02 sd on every chain."""
    tr = transform(model)
    z0 = tr.inverse(torch.as_tensor(TRUTH, device=model.grid.device))
    return z0 + 0.02 * torch.randn(
        N_CHAINS, z0.shape[0],
        generator=torch.Generator().manual_seed(2)).to(z0.device)


def sharded_density_errs(model, mesh, z, grad: bool = True) -> dict:
    """This rank's star-sharded density (and gradient) at z against the
    unsharded card density: the value's largest relative error, and the
    gradient's largest error over tests/test_parallel.py's bound,
    |d| / (rtol |g| + atol max|g|) with max|g| per chain (<= 1 passes)."""
    from base_tpu_torch.inference.hmc import value_and_grad
    from base_tpu_torch.parallel import run as prun

    tr = transform(model)
    fz = prun._logpost_z(model, tr, mesh)
    if grad:
        v, g = value_and_grad(fz)(z)
        want_v, want_g = density_fn(model)(z)
    else:
        with torch.no_grad():
            v, want_v = fz(z), logpost_z_fn(model)(z)
    rel = float(((v - want_v).abs() / want_v.abs().clamp_min(1.0)).max())
    res = dict(value_rel_err=rel, rows=int(z.shape[0]))
    if grad:
        bound = (SHARD_GRAD_RTOL * want_g.abs() + SHARD_GRAD_ATOL
                 * want_g.abs().amax(1, keepdim=True)).clamp_min(1e-30)
        res["grad_err_over_bound"] = float(((g - want_g).abs()
                                            / bound).max())
        res["grad_scaled_err"] = float(
            ((g - want_g).abs().amax(1)
             / want_g.abs().amax(1).clamp_min(1e-30)).max())
    ok = (torch.isfinite(v).all() and rel <= SHARD_VALUE_RTOL
          and res.get("grad_err_over_bound", 0.0) <= 1.0)
    if not ok:
        raise AssertionError(f"sharded density off the unsharded card "
                             f"density: {res}")
    return res


def sharded_hmc(model, mesh, label: str) -> tuple[dict, torch.Tensor]:
    """run_hmc_sharded (hmc14_cfg) on config 1 over the mesh: this rank's
    launches equal to its density calls, every chain moving, the recorded
    logposts the unsharded density at the recorded draws, the age within
    4 sd of the truth; `staged_collectives`: those gloo ran through the
    host (parallel.comm's rule for CUDA tensors).  Returns (results,
    draws)."""
    from base_tpu_torch.parallel import comm
    from base_tpu_torch.parallel import run as prun

    tr = transform(model)
    dev = model.grid.device
    prun.reset_counts()
    comm.staged = 0
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs, info = prun.run_hmc_sharded(
        model, tr, hmc14_init(model),
        torch.Generator(device=dev).manual_seed(4), hmc14_cfg(), mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = prun.density_calls
    counts = launch_counts()
    check_one_launch_per_call(label, counts, calls)
    with torch.no_grad():
        lp = logpost_z_fn(model)(zs.reshape(-1, zs.shape[-1])).view(
            zs.shape[:2])
    lp_err = float(((info["logposts"] - lp).abs()
                    / lp.abs().clamp_min(1.0)).max())
    xs = tr.forward(zs)
    age = xs[..., 0]
    moved = float((zs.amax(0) - zs.amin(0)).amax(-1).min())
    res = dict(wall_s=wall, density_calls=calls, calls_per_s=calls / wall,
               staged_collectives=comm.staged,
               launches=counts, accept=float(info["accept_prob"]),
               step_size=float(info["step_size"]), logpost_rel_err=lp_err,
               least_chain_range=moved,
               age=dict(mean=float(age.mean()), sd=float(age.std()),
                        truth=float(TRUTH[0])))
    if not (torch.isfinite(zs).all() and moved > 1e-4
            and lp_err <= SHARD_VALUE_RTOL
            and abs(res["age"]["mean"] - TRUTH[0]) < 4 * res["age"]["sd"]):
        raise AssertionError(f"{label}: sharded HMC {res}")
    return res, zs


def sharded_resume(s, phot: str, ckpt: str, mesh) -> dict:
    """12d over the mesh: the CLI's model, run_hmc_sharded_checkpointed
    (16 chains, 32 + 16, chunk 8, l_max 4) interrupted after chunk 1 (rank
    0 wrote the whole run) and resumed on every rank, against an
    uninterrupted run, bit for bit."""
    from base_tpu_torch.inference import driver
    from base_tpu_torch.inference.hmc import HMCConfig
    from base_tpu_torch.io.phot import read_phot
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.parallel import run as prun
    from base_tpu_torch.tools import main as cli

    dev = mesh.device
    model = cli._build_model_from_phot(s, read_phot(phot), dev)
    tr = post.default_transform(model)
    cfg = HMCConfig(n_warmup=N_WARMUP_RESUME, n_samples=N_SAMPLES_RESUME,
                    l_max=L_MAX_RESUME, target_accept=s.mcmc.targetAccept,
                    dense_mass=s.mcmc.denseMass,
                    free_mask=post.free_mask(model))
    z0 = tr.inverse(torch.as_tensor(s.cluster.start_vector(), device=dev))
    init = cli._start_chains(z0, N_CHAINS_RESUME, s)

    def run(path, on_window=None):
        return prun.run_hmc_sharded_checkpointed(
            model, tr, init, cli._gen(dev, s.mcmc.seed, 1), cfg, mesh,
            driver.DriverConfig(checkpoint_path=path,
                                chunk_size=CHUNK_RESUME,
                                on_window=on_window))

    def stop(ci, zs, lps):
        if ci == 1:
            raise _Interrupt

    t0 = time.perf_counter()
    want = run(None)
    try:
        run(ckpt, stop)
        raise AssertionError("14c: the interrupting on_window never ran")
    except _Interrupt:
        pass
    got = run(ckpt)
    torch.cuda.synchronize()
    same = dict(
        samples=torch.equal(want[0], got[0]),
        logposts=torch.equal(want[1]["logposts"], got[1]["logposts"]),
        final_z=torch.equal(want[1]["final_states"].z,
                            got[1]["final_states"].z),
        step_size=torch.equal(want[1]["step_size"], got[1]["step_size"]),
        inv_mass=torch.equal(want[1]["inv_mass"], got[1]["inv_mass"]))
    res = dict(wall_s=time.perf_counter() - t0, bit_identical=same)
    if not all(same.values()):
        raise AssertionError(f"14c: the resumed sharded run differs: {same}")
    return res


def parallel_rank(rank: int, world: int, out_dir: str, job: str,
                  cli_run: tuple | None = None) -> None:
    """One rank of a world spawned on the card (torch.multiprocessing's
    entry): joins it, runs `job` ("density": config 1's sharded density at
    MESHES14; "14b": that, config 5's, sharded HMC and, with cli_run =
    (settings args, .phot), the sharded resume), and saves its results to
    out_dir/rank<r>.pt."""
    from base_tpu_torch.ops import build
    from base_tpu_torch.parallel import distributed
    from base_tpu_torch.parallel.mesh import make_mesh

    build.library()                      # built by the parent: loaded here
    dev = distributed.initialize(
        "cuda", init_method=f"file://{out_dir}/store", world_size=world,
        rank=rank, local_rank=rank, local_world_size=world,
        timeout_s=WORLD14_TIMEOUT_S)
    res, draws = {}, {}
    try:
        data = make_data()
        model = make_model(data, dev)
        model99 = make_model(tuple(a[:99] for a in data), dev)
        z = chain_points(model, 0.05, seed=1)
        model5 = z5 = None
        if job == "14b":
            from base_tpu_torch.grids import synthetic
            from base_tpu_torch.model import posterior as post
            from base_tpu_torch.model.stardata import make_ms_stars

            mags, sig = make_data5()
            model5 = post.make_single_pop_model(
                synthetic.make_grid(n_eep=N_EEP, device=dev),
                make_ms_stars(mags, sig, cm_prior=0.99, device=dev), TRUTH,
                PRIOR_SIGMA, n_q=N_Q, upsample=UPSAMPLE5, device=dev)
            z5 = chain_points(model5, 0.02, seed=5,
                              n_chains=N_REP5 * N_PARTICLES5)
        for shape in MESHES14:
            mesh = make_mesh(*shape)
            key = f"{shape[0]}x{shape[1]}"
            r = dict(mesh=mesh.describe(), world=world)
            r["config1"] = sharded_density_errs(model, mesh, z)
            r["config1_99"] = sharded_density_errs(model99, mesh, z)
            if job == "14b":
                t0 = time.perf_counter()
                r["config5"] = sharded_density_errs(model5, mesh, z5,
                                                    grad=False)
                r["config5_grad"] = sharded_density_errs(
                    model5, mesh, z5[:N_ROWS5_GRAD])
                r["config5"]["wall_s"] = time.perf_counter() - t0
                r["hmc"], draws[key] = sharded_hmc(model, mesh,
                                                   f"14b {key}")
                if cli_run is not None and shape == (1, 2):
                    from base_tpu_torch.io.settings import load_settings

                    sets, phot = cli_run
                    r["resume"] = sharded_resume(
                        load_settings(sets[0], list(sets[1:])), phot,
                        f"{out_dir}/resume.ckpt", mesh)
            res[key] = r
        torch.save(dict(results=res, draws=draws), f"{out_dir}/rank{rank}.pt")
    finally:
        distributed.shutdown()


def spawn_world(world: int, job: str, cli_run=None) -> list:
    """Spawn a world of `world` ranks on the card running parallel_rank's
    `job`; returns every rank's saved results."""
    import tempfile

    import torch.multiprocessing as tmp

    from base_tpu_torch.ops import build

    build.build()
    with tempfile.TemporaryDirectory() as out_dir:
        tmp.start_processes(parallel_rank,
                            args=(world, out_dir, job, cli_run),
                            nprocs=world, start_method="spawn")
        return [torch.load(f"{out_dir}/rank{r}.pt", map_location="cpu")
                for r in range(world)]


def run_parallel(dev, model, z) -> dict:
    """Phase 14 (see the comment above MESHES14)."""
    import os
    import tempfile
    from pathlib import Path

    from base_tpu_torch.inference.hmc import run_hmc, value_and_grad
    from base_tpu_torch.io.phot import read_phot
    from base_tpu_torch.io.res import read_res
    from base_tpu_torch.io.settings import load_settings
    from base_tpu_torch.parallel import distributed
    from base_tpu_torch.parallel import run as prun
    from base_tpu_torch.parallel.mesh import make_mesh
    from base_tpu_torch.tools import main as cli

    res = {}
    log("phase 14a: a world of one, mesh 1 x 1 on cuda:0")
    tr = transform(model)
    cfg = hmc14_cfg()
    with distributed.world_of_one("cuda"):
        mesh = make_mesh(1, 1)
        log(f"  {mesh.describe()}")
        if mesh.backend != "nccl":
            raise AssertionError(f"14a: backend {mesh.backend}, not nccl")
        fz = prun._logpost_z(model, tr, mesh)
        reset_launch_counts()
        prun.reset_counts()
        v, g = value_and_grad(fz)(z)
        check_one_launch_per_call("14a density", launch_counts(),
                                  prun.density_calls)
        want_v, want_g = density_fn(model)(z)
        density_same = torch.equal(v, want_v) and torch.equal(g, want_g)
        prun.reset_counts()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zs, info = prun.run_hmc_sharded(
            model, tr, hmc14_init(model),
            torch.Generator(device=dev).manual_seed(4), cfg, mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        calls, counts = prun.density_calls, launch_counts()
        g0 = mesh.chain_generator(torch.Generator(device=dev).manual_seed(4))
    check_one_launch_per_call("14a HMC", counts, calls)
    t0 = time.perf_counter()
    want_zs, want_info = run_hmc(logpost_z_fn(model), hmc14_init(model), g0,
                                 cfg)
    torch.cuda.synchronize()
    hmc_same = {k: torch.equal(a, b) for k, (a, b) in dict(
        samples=(zs, want_zs),
        logposts=(info["logposts"], want_info["logposts"]),
        step_size=(info["step_size"], want_info["step_size"]),
        inv_mass=(info["inv_mass"], want_info["inv_mass"])).items()}
    res["14a"] = dict(backend=mesh.backend, world=1,
                      density_bit_identical=density_same,
                      hmc_bit_identical=hmc_same, wall_s=wall,
                      density_calls=calls, calls_per_s=calls / wall,
                      run_hmc_wall_s=time.perf_counter() - t0,
                      launches=counts, accept=float(info["accept_prob"]))
    log("  " + json.dumps(res["14a"]))
    if not (density_same and all(hmc_same.values())):
        raise AssertionError("14a: the 1 x 1 mesh differs from the "
                             "unsharded path")

    root = Path(__file__).resolve().parent
    conf = str(root / "conf" / "base9.yaml")
    sets = [a for x in CLI_SETS for a in ("--set", x)]
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "run")
        args = ["--config", conf, "--outputFileBase", base, *sets,
                "--device", str(dev)]
        log("phase 14c: simulate -> scatter -> single-pop --mesh 1,2 "
            "--metrics (two ranks on the card)")
        cli.main(["simulate", *args])
        cli.main(["scatter", *args, "--photFile", base + ".sim.phot"])
        metrics_path = os.path.join(tmp, "m.jsonl")
        t0 = time.perf_counter()
        cli.main(["single-pop", *args, "--photFile", base + ".phot",
                  "--mesh", "1,2", "--metrics", metrics_path])
        wall = time.perf_counter() - t0
        with open(metrics_path) as f:
            metrics = [json.loads(line) for line in f][-1]
        chain = read_res(base + ".res")
        age = chain.params[:, 0]
        s = load_settings(conf, list(CLI_SETS))
        truth = float(s.cluster.starting_logAge)
        res["14c"] = dict(
            mesh=metrics["mesh"], backend=metrics["backend"], world=2,
            tool_wall_s=wall, single_pop_wall_s=metrics["wall_s"],
            density_calls_rank0=metrics["density_calls"],
            calls_per_s=metrics["density_calls"] / metrics["wall_s"],
            samples_per_s=metrics["samples_per_sec"],
            rows=int(chain.params.shape[0]), accept=metrics["accept"],
            age=dict(mean=float(age.mean()), sd=float(age.std()),
                     truth=truth),
            stars=int(read_phot(base + ".phot").n_stars))
        log("  " + json.dumps(res["14c"]))
        if not (res["14c"]["rows"] == s.mcmc.runIter
                and np.isfinite(chain.params).all()
                and np.isfinite(chain.logpost).all()
                and metrics["mesh"] == "1,2" and metrics["backend"] == "gloo"
                and abs(float(age.mean()) - truth) < 4 * float(age.std())):
            raise AssertionError(f"14c: single-pop --mesh 1,2 {res['14c']}")

        log("phase 14b: two ranks on the one card (the backend rule: gloo), "
            "meshes (1, 2) and (2, 1); 14c's sharded resume")
        t0 = time.perf_counter()
        ranks = spawn_world(2, "14b", ((conf, *CLI_SETS), base + ".phot"))
        res["14b_wall_s"] = time.perf_counter() - t0
    for key in ranks[0]["results"]:
        res[f"14b {key}"] = [r["results"][key] for r in ranks]
        log(f"  {key}: " + json.dumps(res[f"14b {key}"]))
        if not torch.equal(ranks[0]["draws"][key], ranks[1]["draws"][key]):
            raise AssertionError(f"14b {key}: the ranks' draws differ")
    log(f"  14b world: {res['14b_wall_s']:.1f} s with the spawn")
    return res


# Phase 15: the port held to base_tpu's pinned posterior.  The golden model
# is tests/test_goldens.py's: the 64-star catalog base_tpu simulates from
# JAX's threefry streams (keys 77 / 78, 30% binaries), read from
# GOLDEN_STARS_PATH (scripts/golden_stars_from_jax.py writes it; this
# machine needs no JAX), on the conftest small grid's axes (E = 48), n_q 8,
# upsample 1.  GOLDEN_PATH pins its density at the truth and the moments
# of 4 adaptive-MH chains of 500 + 500 + 12 000 steps
# (scripts/regen_goldens.py).  15b runs the MH of test_goldens.py:62-66
# (4 chains, 400 + 400 + 2000); 15c the main path's HMC, cut to
# N_WARMUP15 + N_SAMPLES15 transitions on 64 chains.  On one H100, 48 + 32
# took 51-68 s by host (split R-hat <= 1.010, |z| <= 1.35) and 32 + 16 took
# 37 s (split R-hat up to 1.066, |z| up to 3.45: the warmup short of
# stationary), so the draws were cut and not the warmup.
GOLDEN_PATH = "tests/data/golden_singlepop.json"
GOLDEN_STARS_PATH = "tests/data/golden_singlepop_stars.json"
GOLDEN_AXES = dict(feh_axis=np.linspace(-1.5, 0.3, 4),
                   y_axis=np.linspace(0.24, 0.31, 3),
                   age_axis=np.linspace(8.6, 10.1, 6), n_eep=48)
GOLDEN_RTOL = 1e-4           # test_goldens.py:52
GOLDEN_STEP0 = np.array([0.05, 0.02, 0.05, 0.05, 0.03, 0, 0, 0, 0],
                        np.float32)
GOLDEN_MH = dict(n_stage1=400, n_stage2=400, n_main=2000)
N_CHAINS_MH15, SEED_MH15 = 4, 123
N_WARMUP15, N_SAMPLES15 = 48, 16
# The golden's effective draws, for the z that 15b and 15c report (and do
# not check): taken as ~1000 of its 4 x 12 000 adaptive-MH draws, whose
# ESS the golden file does not hold.
ESS_GOLDEN = 1000.0


def repo_path(rel: str) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def load_golden() -> dict:
    with open(repo_path(GOLDEN_PATH)) as f:
        return json.load(f)


def golden_stars() -> dict:
    """The golden catalog: mags and sigmas [64, B] float32, bands, truth."""
    with open(repo_path(GOLDEN_STARS_PATH)) as f:
        doc = json.load(f)
    for k in ("mags", "sigmas", "truth"):
        doc[k] = np.asarray(doc[k], np.float32)
    return doc


def golden_model(device, use_pallas: bool = True):
    """tests/test_goldens.py's golden model, built with the port's API."""
    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars

    doc = golden_stars()
    grid = synthetic.make_grid(**GOLDEN_AXES, device=device)
    if tuple(grid.bands) != tuple(doc["bands"]):
        raise AssertionError(f"golden bands {doc['bands']} vs {grid.bands}")
    stars = make_ms_stars(doc["mags"], doc["sigmas"], cm_prior=0.99,
                          device=device)
    return post.make_single_pop_model(grid, stars, prior_mean=doc["truth"],
                                      prior_sigma=PRIOR_SIGMA, n_q=N_Q,
                                      use_pallas=use_pallas, device=device)


def golden_moments(xs, golden: dict, ess=None) -> dict:
    """test_goldens.py:70-77's rule on constrained draws xs [N, C, 9] for
    the five free parameters: |mean - golden mean| < 5 sd_g / 3 + 1e-3 and
    0.4 sd_g < sd + 1e-5 < 2.5 sd_g + 1e-3 (sd over all draws, ddof 0).
    With `ess` [5], also z = (mean - golden mean) / (sd_g sqrt(1 / ess +
    1 / ESS_GOLDEN)), reported and not checked.  Returns {name: {mean, sd,
    golden_mean, golden_sd, mean_ok, sd_ok[, ess, z]}}."""
    from base_tpu_torch.constants import PARAM_NAMES

    flat = xs.reshape(-1, xs.shape[-1]).double().cpu()
    out = {}
    for i in range(5):
        m, s = float(flat[:, i].mean()), float(flat[:, i].std(correction=0))
        mg, sg = golden["mean"][i], golden["sd"][i]
        r = dict(mean=m, sd=s, golden_mean=mg, golden_sd=sg,
                 mean_ok=abs(m - mg) < 5 * sg / 3 + 1e-3,
                 sd_ok=0.4 * sg < s + 1e-5 < 2.5 * sg + 1e-3)
        if ess is not None:
            r["ess"] = float(ess[i])
            r["z"] = (m - mg) / (sg * math.sqrt(1.0 / r["ess"]
                                                + 1.0 / ESS_GOLDEN))
        out[PARAM_NAMES[i]] = r
    return out


def check_golden_moments(label: str, moments: dict) -> None:
    bad = {n: r for n, r in moments.items()
           if not (r["mean_ok"] and r["sd_ok"])}
    if bad:
        raise AssertionError(f"{label}: moments off the golden: {bad}")


def golden_density(model, model_cpu, golden: dict) -> dict:
    """15a: log_post at the truth on the card against the golden value and
    the CPU plain path."""
    from base_tpu_torch.model import posterior as post

    x = torch.as_tensor(TRUTH, device=model.grid.device)[None]
    with torch.no_grad():
        lp = float(post.log_post(model, x)[0])
        lp_cpu = float(post.log_post(model_cpu, x.cpu())[0])
    want = golden["logpost_at_truth"]
    res = dict(logpost_at_truth=lp, cpu=lp_cpu, golden=want,
               rel_err_golden=abs(lp - want) / abs(want),
               rel_err_cpu=abs(lp - lp_cpu) / max(1.0, abs(lp_cpu)))
    log("  " + json.dumps(res))
    if not res["rel_err_golden"] <= GOLDEN_RTOL:
        raise AssertionError(f"15a: log_post at the truth {lp} vs the "
                             f"golden {want}")
    if not res["rel_err_cpu"] <= DENSITY_REL_TOL:
        raise AssertionError(f"15a: log_post at the truth {lp} on the card, "
                             f"{lp_cpu} on the CPU")
    return res


def run_golden_mh(model, golden: dict) -> dict:
    """15b: test_goldens.py:62-66's adaptive MH through the port: 4 chains
    from the truth, 400 + 400 + 2000 steps, each one density call without
    gradients (kernels 1 and 3)."""
    from base_tpu_torch.inference import diagnostics as diag
    from base_tpu_torch.inference.mh import MHConfig, run_adaptive_mh
    from base_tpu_torch.model import posterior as post

    dev = model.grid.device
    f, evals = counted(post.make_logpost_fn(model))
    start = torch.as_tensor(TRUTH, device=dev).expand(N_CHAINS_MH15, -1)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples, info = run_adaptive_mh(
        f, start.contiguous(), torch.Generator(device=dev).manual_seed(
            SEED_MH15), torch.as_tensor(GOLDEN_STEP0, device=dev),
        MHConfig(**GOLDEN_MH))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    moments = golden_moments(samples, golden, diag.ess(samples[..., :5]))
    res = dict(wall_s=wall, chains=N_CHAINS_MH15, evals=evals[0],
               launches=counts,
               accept=float(info["accept_rate"].mean()),
               golden_accept=golden["accept"],
               rhat={n: float(v) for n, v in zip(
                   moments, diag.split_rhat(samples[..., :5]))},
               moments=moments)
    log("  " + json.dumps(res))
    if not torch.isfinite(samples).all():
        raise AssertionError("15b: non-finite MH draws")
    check_one_launch_per_call("15b MH", counts, evals[0],
                              kernels=("table_fwd", "marglik_fwd"))
    check_golden_moments("15b MH", moments)
    return res


def run_golden(dev) -> dict:
    """Phase 15 (see the comment above GOLDEN_PATH): (a) the density at the
    truth and kernels 1-4 against their plain versions on the golden
    model; (b) reference-mode MH; (c) the main path's HMC, its moments
    held to the golden's."""
    golden = load_golden()
    model = golden_model(dev)
    model_cpu = golden_model("cpu")
    res = {}
    log("phase 15a: the golden model's log_post at the truth; kernels vs "
        "plain; density + gradient vs CPU")
    t0 = time.perf_counter()
    res["density"] = golden_density(model, model_cpu, golden)
    z = chain_points(model, 0.05, seed=1)
    res["max_abs_err"] = check_kernels(model, z, "golden")
    check_density(model, model_cpu, z[:16])
    res["density"]["wall_s"] = time.perf_counter() - t0

    log(f"phase 15b: adaptive MH, {N_CHAINS_MH15} chains, "
        f"{GOLDEN_MH['n_stage1']} + {GOLDEN_MH['n_stage2']} + "
        f"{GOLDEN_MH['n_main']} steps")
    res["mh"] = run_golden_mh(model, golden)

    log(f"phase 15c: chunked HMC, {N_CHAINS} chains, dense metric, l_max 48, "
        f"{N_WARMUP15} + {N_SAMPLES15} draws")
    hmc, xs = run_hmc(model, n_warmup=N_WARMUP15, n_samples=N_SAMPLES15,
                      report=(0, 1, 2, 3, 4))
    check_one_launch_per_call("15c HMC", hmc["launches"], hmc["evals"])
    hmc["moments"] = golden_moments(xs, golden,
                                    [hmc["ess"][n] for n in hmc["ess"]])
    log("  moments: " + json.dumps(hmc["moments"]))
    check_golden_moments("15c HMC", hmc["moments"])
    res["hmc"] = hmc
    return res


# Phase 16: the simulation-based calibration (SBC) path on the card, the
# port's counterpart of base_tpu's vmap over data sets
# (tests/test_calibration.py; scripts/torch_sbc.py runs the three checks
# whole).  Its models hold base_tpu's 64 SBC data sets
# (tests/data/sbc_stars.npz) as star sets, one chain a set.  16a, at the SBC
# shapes, G = C = 64 (32 stars, no binaries: T = 47) and G = 8 with 8
# chains a set (20 stars, binaries, n_q 8: T = 376): kernels 3-4 over star
# sets against one-set launches on a set's chains and, at G = 1, against
# the one-set kernel, bit for bit; against their plain versions and
# float64 within MARGLIK_TOL on the SBC stars with a model floor of
# SIGMA_MODEL16 in quadrature.  Without it every star has sigma 0.01 and
# the tables no upsampling, and the float32 formula itself (kernel or plain
# version, CPU or card) sits up to 1.7-4.5e-2 from float64 (a long segment
# cancels gamma - beta^2 / alpha from ~1e5 down to ~10): there the errors
# are reported, not gated.  The kernels' times beside the one-set form's
# and their bound, on the SBC data.  16b: the stacked density (64 sets, a
# chain a set about a posterior sd from its truth) on the card against the
# CPU plain path (with the floor; without it, reported).  16c: replica-blocked HMC (run_hmc(replicas=64) on the
# binaries model: all four kernels) and adaptive MH (the MS model: kernel
# 3), cut to a few transitions, each run again with one set's stars moved
# by MOVED_MAG: finite draws, every kernel launched once an evaluation,
# and every other replica's draws bit for bit the same.
SBC_SHAPES16 = {"G64": ("ms", 4, False, 64, 1),
                "G8 k8": ("bin", 8, True, 8, 8)}
SIGMA_MODEL16 = 0.1
N_WARMUP16, N_SAMPLES16, L_MAX16 = 48, 8, 8
MH16 = dict(n_stage1=50, n_stage2=20, n_main=20)
MOVED_SET16 = 5


def torch_sbc():
    """scripts/torch_sbc.py, the SBC runs' module."""
    if repo_path("scripts") not in sys.path:
        sys.path.insert(0, repo_path("scripts"))
    import torch_sbc as mod

    return mod


def sbc_marglik_inputs(dev, shape: str, sigma_model: float = 0.0,
                       seed: int = 0) -> tuple:
    """Kernels 3-4's inputs on SBC_SHAPES16[shape] as the SBC path builds
    them (ms_table: the fused table with binaries, the plain one
    without), k chains a set near each set's truth."""
    from base_tpu_torch.model import posterior as post

    coll, n_q, binaries, G, k = SBC_SHAPES16[shape]
    model, truths = torch_sbc().sbc_model(coll, n_q, binaries, dev, G,
                                          sigma_model=sigma_model)
    table, _ = post.ms_table(model, torch.as_tensor(
        torch_sbc().near_truths(truths, k, seed), device=dev))
    st = model.stars
    return (st.obs_mags, st.inv_var, st.log_norm, table.lo.contiguous(),
            table.hi.contiguous(), table.logw.contiguous(),
            table.mask.float())


def marglik_floor(marg_in, label: str) -> dict:
    """Kernels 3-4, their plain versions on the card and on the CPU, all
    against float64 (the plain version on the CPU): the float32 formula's
    own error on these inputs, reported (forward where plain is above
    -200; backward scaled by float64's largest magnitude)."""
    from base_tpu_torch.ops import marglik as ml

    cpu = tuple(t.cpu() for t in marg_in)
    out64 = ml.marglik_fwd_plain(*(t.double() for t in cpu))
    sel = out64 > -200
    g = torch.randn(out64.shape, generator=torch.Generator().manual_seed(7))
    bwd64 = ml.marglik_bwd_plain(*(t.double() for t in cpu), out64,
                                 g.double())
    res = {}
    for name, fwd, bwd, args in (
            ("kernel", ml.marglik_fwd_cuda, ml.marglik_bwd_cuda, marg_in),
            ("plain card", ml.marglik_fwd_plain, ml.marglik_bwd_plain,
             marg_in),
            ("plain cpu", ml.marglik_fwd_plain, ml.marglik_bwd_plain, cpu)):
        gd = g.to(args[0].device)
        out = fwd(*args)
        grads = bwd(*args, out64.float().to(args[0].device), gd)
        res[name] = dict(
            fwd=float((out.cpu().double() - out64).abs()[sel].max()),
            bwd_scaled=max(float((a.cpu().double() - b).abs().max())
                           / max(float(b.abs().max()), 1e-30)
                           for a, b in zip(grads, bwd64)))
    log(f"  [{label}, sigma 0.01] against float64 (reported): "
        f"{json.dumps(res)}")
    return res


def check_sets_vs_one_set(marg_in, label: str) -> None:
    """Kernels 3-4 over star sets against one-set launches on the first
    and the last set's chains (bit for bit), and the stacked form at G = 1
    against the one-set kernel on the first set (bit for bit)."""
    from base_tpu_torch.ops import marglik as ml

    G = marg_in[0].shape[0]
    k = marg_in[3].shape[0] // G
    out = ml.marglik_fwd_cuda(*marg_in)
    g = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(device=out.device)
                    .manual_seed(7))
    grads = ml.marglik_bwd_cuda(*marg_in, out, g)
    same = {}
    for s_ in (0, G - 1):
        one = tuple(t[s_] for t in marg_in[:3]) + tuple(
            t[s_ * k:(s_ + 1) * k].contiguous() for t in marg_in[3:])
        rows = slice(s_ * k, (s_ + 1) * k)
        o1 = ml.marglik_fwd_cuda(*one)
        g1 = ml.marglik_bwd_cuda(*one, out[rows].contiguous(),
                                 g[rows].contiguous())
        same[f"set {s_}"] = torch.equal(out[rows], o1) and all(
            torch.equal(a[rows], b) for a, b in zip(grads, g1))
        if s_ == 0:
            st = tuple(t[None] for t in one[:3]) + one[3:]
            same["G = 1"] = torch.equal(ml.marglik_fwd_cuda(*st), o1) and all(
                torch.equal(a, b) for a, b in zip(
                    ml.marglik_bwd_cuda(*st, out[rows].contiguous(),
                                        g[rows].contiguous()), g1))
    log(f"  [{label}] bit for bit against one-set launches: "
        f"{json.dumps(same)}")
    if not all(same.values()):
        raise AssertionError(f"16a {label}: the set form differs from the "
                             f"one-set kernel")


def time_sets(marg_in) -> dict:
    """Kernels 3-4 over star sets: time_pair against the plain version,
    the one-set form's device ms at the same shapes (every chain on set
    0), and the bound of the set form's work."""
    times = time_marglik(marg_in)
    one = tuple(t[0] for t in marg_in[:3]) + marg_in[3:]
    one_times = {k: v[2] for k, v in time_marglik(one).items()}
    work = marglik_work(marg_in)
    res = {}
    for name, (ms_, plain_ms, dev_ms) in times.items():
        bound_ms, by = bound(*work[name])
        res[name] = dict(ms=ms_, plain_ms=plain_ms, device_ms=dev_ms,
                         device_ms_one_set=one_times[name],
                         bound_ms=bound_ms, bound_by=by,
                         roofline_share=bound_ms / dev_ms)
    return res


def sbc_hmc16(dev, moved_set=None) -> dict:
    """16c's replica-blocked HMC on the binaries SBC model: (results,
    draws [n, 64, 9])."""
    from base_tpu_torch.inference import hmc
    from base_tpu_torch.model import posterior as post

    sbc = torch_sbc()
    model, truths = sbc.sbc_model("bin", 8, True, dev, moved_set=moved_set)
    tr = post.default_transform(model)
    fz, calls = counted(post.make_logpost_z_fn(model, tr))
    cfg = hmc.HMCConfig(**dict(sbc.CASES["hmc_binaries"]["settings"],
                               n_warmup=N_WARMUP16, n_samples=N_SAMPLES16,
                               l_max=L_MAX16))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zs, info = hmc.run_hmc(fz, tr.inverse(torch.as_tensor(truths,
                                                          device=dev)),
                           torch.Generator(device=dev).manual_seed(13), cfg,
                           replicas=sbc.R)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_one_launch_per_call("16c HMC", counts, calls[0])
    xs = tr.forward(zs.reshape(-1, zs.shape[-1])).reshape(zs.shape)
    if not (torch.isfinite(xs).all() and info["inv_mass"].shape
            == (sbc.R, 9, 9) and info["step_size"].shape == (sbc.R,)):
        raise AssertionError("16c HMC: non-finite draws or a shared metric")
    return dict(wall_s=wall, evals=calls[0], ms_per_eval=1e3 * wall
                / calls[0], launches=counts,
                accept=float(info["accept_prob"]),
                step_size=[float(info["step_size"].min()),
                           float(info["step_size"].max())]), xs


def sbc_mh16(dev, moved_set=None) -> dict:
    """16c's adaptive MH (every chain adapting on its own) on the MS SBC
    model: (results, draws [n, 64, 9])."""
    from base_tpu_torch.inference import mh
    from base_tpu_torch.model import posterior as post

    sbc = torch_sbc()
    model, truths = sbc.sbc_model("ms", 4, False, dev, moved_set=moved_set)
    f, calls = counted(post.make_logpost_fn(model))
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, info = mh.run_adaptive_mh(
        f, torch.as_tensor(truths, device=dev),
        torch.Generator(device=dev).manual_seed(5), sbc.STEP0_MH,
        mh.MHConfig(**MH16))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_one_launch_per_call("16c MH", counts, calls[0],
                              kernels=("marglik_fwd",))
    if not torch.isfinite(xs).all():
        raise AssertionError("16c MH: non-finite draws")
    return dict(wall_s=wall, evals=calls[0], ms_per_eval=1e3 * wall
                / calls[0], launches=counts,
                accept=float(info["accept_rate"].mean())), xs


def check_replicas(label: str, a, b, moved: int) -> dict:
    """Draws a [n, R, P] and b (the same run with set `moved` moved): every
    other replica bit for bit the same, the moved one not."""
    same = [torch.equal(a[:, r], b[:, r]) for r in range(a.shape[1])]
    others = all(v for r, v in enumerate(same) if r != moved)
    log(f"  [{label}] set {moved} moved: other replicas bit for bit "
        f"{others}, replica {moved} changed {not same[moved]}")
    if not others or same[moved]:
        raise AssertionError(f"16c {label}: a replica's draws depend on "
                             f"another's stars")
    return dict(others_bit_identical=others, moved_changed=not same[moved])


def density_floor(model, model_cpu, z) -> dict:
    """The stacked density at the SBC data's own sigmas: card and CPU
    against float64 (the CPU plain path), reported."""
    lp_g, g_g = density_fn(model)(z)
    lp_c, g_c = density_fn(model_cpu)(z.cpu())
    m64 = dataclasses.replace(_double(model_cpu), use_pallas=False)
    lp_d = logpost_z_fn(m64)(z.cpu().double()).detach()

    def rel(a):
        return float(((a.cpu().double() - lp_d).abs()
                      / lp_d.abs().clamp_min(1.0)).max())

    res = dict(card_vs_cpu=float(((lp_g.cpu() - lp_c).abs()
                                  / lp_c.abs().clamp_min(1.0)).max()),
               card_vs_float64=rel(lp_g), cpu_vs_float64=rel(lp_c))
    log(f"  [sigma 0.01] log_post relative errors (reported): "
        f"{json.dumps(res)}")
    return res


def _double(obj):
    """obj with every floating tensor in it, through nested dataclass
    fields, in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _double(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    return obj


def run_sbc(dev) -> dict:
    """Phase 16 (see the comment above SBC_SHAPES16)."""
    sbc = torch_sbc()
    res = {"max_abs_err": {}, "kernels": {}, "floor": {}}
    log("phase 16a: kernels 3-4 over star sets at the SBC shapes: vs one-set "
        f"launches and G = 1; vs plain (sigma_model {SIGMA_MODEL16}); times")
    for shape in SBC_SHAPES16:
        marg_in = sbc_marglik_inputs(dev, shape)
        check_sets_vs_one_set(marg_in, shape)
        res["floor"][shape] = marglik_floor(marg_in, shape)
        errs = check_marglik(sbc_marglik_inputs(dev, shape, SIGMA_MODEL16),
                             f"sbc {shape}, sigma_model {SIGMA_MODEL16}")
        for name, err in errs.items():
            res["max_abs_err"][name] = max(res["max_abs_err"].get(name, 0.0),
                                           err)
        res["kernels"][shape] = time_sets(marg_in)
        log(f"  [{shape}] " + json.dumps(res["kernels"][shape]))

    log("phase 16b: the stacked density (64 sets, one chain a set near its "
        "truth), card vs CPU")
    for sm in (SIGMA_MODEL16, 0.0):
        model, truths = sbc.sbc_model("ms", 4, False, dev, sigma_model=sm)
        model_cpu, _ = sbc.sbc_model("ms", 4, False, "cpu", sigma_model=sm)
        z = transform(model).inverse(torch.as_tensor(
            sbc.near_truths(truths, 1, 1), device=dev))
        if sm:
            check_density(model, model_cpu, z)
        else:
            res["density_sigma_001"] = density_floor(model, model_cpu, z)

    log(f"phase 16c: run_hmc(replicas=64) on the binaries SBC model, "
        f"{N_WARMUP16} + {N_SAMPLES16}, l_max {L_MAX16}; adaptive MH on "
        f"the MS SBC model, {MH16['n_stage1']} + {MH16['n_stage2']} + "
        f"{MH16['n_main']}; each again with set {MOVED_SET16} moved")
    res["hmc"], xs = sbc_hmc16(dev)
    _, xs_moved = sbc_hmc16(dev, MOVED_SET16)
    res["hmc"]["replicas"] = check_replicas("HMC", xs, xs_moved,
                                            MOVED_SET16)
    res["mh"], xs = sbc_mh16(dev)
    _, xs_moved = sbc_mh16(dev, MOVED_SET16)
    res["mh"]["replicas"] = check_replicas("MH", xs, xs_moved, MOVED_SET16)
    log("  " + json.dumps({k: res[k] for k in ("hmc", "mh")}))
    return res


def kernel_outputs(models: dict, z) -> dict:
    """Kernels 1 and 4 on phase 2's inputs at each shape, with the inputs,
    for --save-outputs."""
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    res = {}
    for label, model in models.items():
        table_in, marg_in = kernel_inputs(model, z)
        out = ml.marglik_fwd_plain(*marg_in)
        gen = torch.Generator(device=z.device).manual_seed(7)
        g = torch.randn(out.shape, generator=gen, device=z.device)
        res[label] = dict(table_in=table_in, marg_in=marg_in, out=out, g=g,
                          table_fwd=tb.table_fwd_cuda(*table_in),
                          marglik_bwd=ml.marglik_bwd_cuda(*marg_in, out, g))
    return res


def compare_outputs(path: str) -> None:
    """Kernels 1 and 4 of this checkout on the inputs saved at `path` (by
    --save-outputs, from another checkout): whether kernel 1's outputs are
    bit-identical, and both kernels' largest differences."""
    from base_tpu_torch.ops import marglik as ml
    from base_tpu_torch.ops import table as tb

    saved = torch.load(path, map_location="cuda:0")
    for label, r in saved.items():
        comb = tb.table_fwd_cuda(*r["table_in"])
        diff = (comb - r["table_fwd"]).abs()
        log(f"  [{label}] table_fwd vs {path}: bit-identical "
            f"{torch.equal(comb, r['table_fwd'])}, {int((diff > 0).sum())} of "
            f"{diff.numel()} outputs differ, max|diff| {float(diff.max()):.3e}")
        grads = ml.marglik_bwd_cuda(*r["marg_in"], r["out"], r["g"])
        report = grad_errs(("dlo", "dhi", "dlogw"), grads,
                           r["marglik_bwd"])[2]
        same = all(torch.equal(a, b) for a, b in zip(grads, r["marglik_bwd"]))
        log(f"  [{label}] marglik_bwd vs {path}: bit-identical {same}; "
            f"abs/scaled {report}")


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


class PhaseClock:
    """Each phase's wall (s) and the script's running total, logged as the
    phases end."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.walls = {}

    def done(self, label: str) -> None:
        now = time.perf_counter()
        self.walls[label] = now - self.t
        log(f"  [phase {label}: {now - self.t:.1f} s; {now - self.t0:.1f} s "
            f"since the build]")
        self.t = now


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times-only", action="store_true",
                    help="phases 1, 5 and 6 only: build and time the kernels "
                         "and the density calls")
    ap.add_argument("--root", default=None,
                    help="time the base_tpu_torch of this checkout instead")
    ap.add_argument("--save-outputs", default=None, metavar="PATH",
                    help="with --times-only: save kernels 1 and 4's inputs "
                         "and outputs at both shapes to PATH")
    ap.add_argument("--against", default=None, metavar="PATH",
                    help="with --times-only: compare kernels 1 and 4 with "
                         "the outputs saved at PATH")
    args = ap.parse_args()
    data, model, model_up4, z = setup(args.root)
    models = {"bench": model, "upsample 4": model_up4}

    if args.times_only:
        if args.save_outputs:
            torch.save(kernel_outputs(models, z), args.save_outputs)
            log(f"kernels 1 and 4 outputs saved to {args.save_outputs}")
        if args.against:
            log(f"kernels 1 and 4 against {args.against}")
            compare_outputs(args.against)
        log("phase 5: kernel times (CUDA events) and bounds")
        report = kernel_report(model, model_up4, z)
        walls = density_walls(models, z)
        log("phase 6: torch.profiler, density + gradient")
        shares = {label: device_shares(m, z, label, walls[label])
                  for label, m in models.items()}
        print(json.dumps({"density": shares}))
        print(json.dumps({"kernels": report}))
        return

    clock = PhaseClock()
    # 2. Kernels vs their plain versions, bench and upsample-4 shapes.
    log("phase 2: kernels vs plain on the card")
    errs = check_kernels(model, z, "bench")
    errs_up4 = check_kernels(model_up4, z, "upsample 4")
    worst = {k: max(errs[k], errs_up4[k]) for k in errs}
    clock.done("2")

    # 3. Density parity against the CPU plain path, and determinism.
    log("phase 3: log_post + gradient, card vs CPU")
    check_density(model, make_model(data, "cpu"), z)
    clock.done("3")

    # 4. HMC, the main path.
    log(f"phase 4: chunked HMC, {N_CHAINS} chains, dense metric, l_max 48, "
        f"{N_WARMUP_MAIN} + {N_SAMPLES_MAIN} draws")
    hmc_res, _ = run_hmc(model, n_warmup=N_WARMUP_MAIN,
                         n_samples=N_SAMPLES_MAIN)
    clock.done("4")

    # 5. Kernel times vs plain and vs their bounds, at both shapes.
    log("phase 5: kernel times (CUDA events) and bounds")
    report = kernel_report(model, model_up4, z)
    walls = density_walls(models, z)
    clock.done("5")

    # 6. Device busy share and kernel shares of device time.
    log("phase 6: torch.profiler, density + gradient")
    shares = {label: device_shares(m, z, label, walls[label])
              for label, m in models.items()}
    clock.done("6")

    # 7a-7e. Config 3: the WD branch through kernels 3 and 4.
    c3 = run_config3(torch.device("cuda", 0),
                     baseline=(model_up4, z[:N_CHAINS3]))
    clock.done("7")

    # 8a-8e. Config 4: two populations folded into one pass.
    c4 = run_config4(torch.device("cuda", 0))
    clock.done("8")

    # 9. Config 1 under NUTS.
    log(f"phase 9: chunked NUTS, {N_CHAINS} chains, dense metric, max_depth "
        f"{MAX_DEPTH_NUTS}, {N_WARMUP_NUTS} + {N_SAMPLES_NUTS} draws")
    nuts = run_nuts_config1(model, hmc_res)
    clock.done("9")

    # 10. Config 2: field membership.
    c2 = run_config2(torch.device("cuda", 0))
    clock.done("10")

    # 11. Config 5's single-card leg: VI + tempered SMC at 10 000 stars.
    c5 = run_config5(torch.device("cuda", 0))
    clock.done("11")

    # 12. The CLI end to end at conf/base9.yaml's widths.
    cli = run_cli(torch.device("cuda", 0), hmc_res)
    clock.done("12")

    # 13. Wide band sets: the grid ingest, the CLI at 29 bands, the matmul
    # form of kernels 3 and 4.
    wide = run_wide(torch.device("cuda", 0), (model, z))
    clock.done("13")

    # 14. The parallel layer: a 1 x 1 mesh, the CLI's --mesh 1,2, and two
    # ranks on the card at meshes (1, 2) and (2, 1).
    par = run_parallel(torch.device("cuda", 0), model, z)
    clock.done("14")

    # 15. The port held to base_tpu's pinned posterior (the goldens).
    golden = run_golden(torch.device("cuda", 0))
    clock.done("15")

    # 16. The SBC path: kernels 3-4 over star sets, replica blocks.
    sbc = run_sbc(torch.device("cuda", 0))
    clock.done("16")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = report[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=hmc_res["launches"][name], max_abs_err=worst[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            roofline_share=r["roofline_share"], ms_up4=r["ms_up4"],
            device_ms=r["device_ms"], device_ms_up4=r["device_ms_up4"],
            # The profiler's time of the kernel in phase 6's density calls
            # (config 1 launches each kernel once per call).
            device_ms_profiler=profiler_ms(shares["bench"], name),
            device_ms_profiler_up4=profiler_ms(shares["upsample 4"], name),
            **{k: r[k] for k in ("bound_ms_dense",) if k in r},
            launches_config3=c3["hmc"]["launches"][name],
            **c3["wd_kernels"].get(name, {}),
            **c4["kernels"][name],
            launches_nuts=nuts["launches"][name],
            launches_config2=c2["hmc"]["launches"][name],
            **c5["kernels"][name],
            launches_cli=cli["launches"][name],
            max_abs_err_cli=cli["max_abs_err"][name],
            launches_wide=wide["launches"][name],
            max_abs_err_wide=wide["max_abs_err"][name],
            b29=wide["kernels_b29"][name],
            # Phase 14's HMC: the 1 x 1 mesh, and each rank of the two
            # meshes on the card (each rank's launches = its calls).
            launches_parallel={
                "14a": par["14a"]["launches"][name],
                **{k[4:]: [r["hmc"]["launches"][name] for r in par[k]]
                   for k in par if k.startswith("14b ")}},
            # Phase 15's MH (kernels 1 and 3) and HMC on the golden model.
            launches_golden={k: golden[k]["launches"][name]
                             for k in ("mh", "hmc")},
            max_abs_err_golden=golden["max_abs_err"][name],
            # Phase 16c's replica-blocked HMC (binaries) and MH (kernel
            # 3); 16a's set form at the SBC shapes.
            launches_sbc={k: sbc[k]["launches"][name] for k in ("hmc", "mh")},
            **({"max_abs_err_sbc": sbc["max_abs_err"][name],
                "sbc": {k: v[name] for k, v in sbc["kernels"].items()}}
               if name in sbc["max_abs_err"] else {})))
        if not all(math.isfinite(v) for k, v in kernels[-1].items()
                   if k.startswith(("ms", "plain_ms", "bound_ms",
                                    "device_ms"))):
            raise AssertionError(f"{name}: a time is missing or not finite")
    for name, (source, replaces) in MM_KERNELS.items():
        t8 = wide["mm_times"]["bench"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=wide["mm_launches"][name],
            max_abs_err=max(c["max_abs_err"][name]
                            for c in wide["mm_check"].values()),
            ms=t8["ms"], plain_ms=t8["plain_ms"], bound_ms=t8["bound_ms"],
            bound_by=t8["bound_by"], library_ms=None,
            roofline_share=t8["roofline_share"], device_ms=t8["device_ms"],
            # 4m: the bound over every live element (PR 8's count, its
            # kernel had no skip) and its group rule's shares.
            **{k: t8[k] for k in ("bound_ms_dense", "skip") if k in t8},
            b29=wide["mm_times"]["b29"][name]))
        if not all(math.isfinite(v) for k, v in kernels[-1].items()
                   if k.startswith(("ms", "plain_ms", "bound_ms",
                                    "device_ms"))):
            raise AssertionError(f"{name}: a time is missing or not finite")
    print(json.dumps({"cli": cli}))
    print(json.dumps({"wide": wide}))
    print(json.dumps({"parallel": par}))
    print(json.dumps({"golden": golden}))
    print(json.dumps({"sbc": sbc, "phase_walls": clock.walls}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
