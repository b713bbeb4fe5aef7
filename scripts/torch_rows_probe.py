"""Does a chain's row of the port's CPU density depend on its batch, and
what do the CPU forms cost?  Run it under each MKL code path, one process
a path (MKL reads MKL_CBWR once, when it loads), and with --root on
another checkout to compare two versions:

    [MKL_CBWR=AVX2|COMPATIBLE] python scripts/torch_rows_probe.py
        [--root DIR] [--threads 1] [--save-catalog P | --catalog P]

It prints one JSON line:
- `rows`: for each stage of the density (the isochrone's fields and their
  gradients, the secondary lookup, the plain table kernels, log_post and
  its gradient on the plain path and through the kernels' plain
  versions; and torch.bmm itself at [6, 8, 48] @ [6, 48, 200]), the
  largest difference between a batch of 6 chains near the truth and 8 of
  its subsets, each op on the same inputs (0: bit for bit);
  tests/conftest.py's small grid, 30 stars, n_q 6, upsample 2;
- `ms`: times (at --threads) of the plain table kernels at config 1's bench
  shapes (C 64, B 8, E2 64, N 512) and of derive_isochrone forward +
  backward at 64 chains (n_eep 64);
- `wide`: tests/test_torch_wide_bands.py's 29-band float32 gradient
  against float64, whole and upstream of the likelihood (wide_bands);
  --save-catalog / --catalog run one checkout's density on another's
  catalog.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--catalog", default=None, metavar="PATH",
                    help="the 29-band catalog from this file (written "
                         "by --save-catalog), not this checkout's own")
    ap.add_argument("--save-catalog", default=None, metavar="PATH")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.grids.isochrone import (derive_isochrone,
                                                upsample_isochrone)
    from base_tpu_torch.model import likelihood as lk
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars
    from base_tpu_torch.ops import table as tb
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    torch.set_num_threads(args.threads)
    truth = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
    sig = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32)
    grid = synthetic.make_grid(feh_axis=np.linspace(-1.5, 0.3, 4),
                               y_axis=np.linspace(0.24, 0.31, 3),
                               age_axis=np.linspace(8.6, 10.1, 6), n_eep=48,
                               device="cpu")
    gen = torch.Generator().manual_seed(0)
    cat = simulate_cluster(grid, torch.from_numpy(truth), 30, gen,
                           percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    stars = make_ms_stars(sc.mags, sc.sigmas, cm_prior=0.99, device="cpu")
    x = np.tile(truth, (6, 1))
    x[:, :5] += np.random.default_rng(1).normal(
        0, [0.05, 0.01, 0.05, 0.05, 0.03], (6, 5))
    x = torch.from_numpy(x.astype(np.float32))
    subsets = [slice(0, 1), slice(1, 3), slice(3, 6), slice(2, 5),
               slice(5, 6), slice(0, 5), slice(1, 6), slice(1, 5)]
    rows = {}

    def fields(obj):
        return [getattr(obj, f.name) for f in dataclasses.fields(obj)]

    def cut(a, sl):
        if isinstance(a, torch.Tensor):
            return a[sl]
        return type(a)(*(v[sl] for v in fields(a)))

    def stage(name, fn, *inputs):
        full = fn(*inputs)
        worst = 0.0
        for sl in subsets:
            part = fn(*(cut(a, sl) for a in inputs))
            for a, b in zip(full, part):
                worst = max(worst, float((a[sl].double() - b.double())
                                         .abs().max()))
        rows[name] = worst

    def grad_of(fn):
        def g(p):
            p = p.clone().requires_grad_(True)
            (d,) = torch.autograd.grad(fn(p).sum(), p)
            return [d]
        return g

    def iso(p):
        return derive_isochrone(grid, p[:, 2], p[:, 1], p[:, 0])

    stage("isochrone", lambda p: [f for f in fields(iso(p))
                                  if f.is_floating_point()], x)
    stage("d isochrone mass", grad_of(lambda p: iso(p).mass.sum(-1)), x)
    stage("d isochrone mags", grad_of(lambda p: iso(p).mags.sum((1, 2))), x)
    base = iso(x)
    up = upsample_isochrone(base, 2)
    q = torch.linspace(0, 1, 6)
    m2 = (up.mass[:, :, None] * q).reshape(6, -1)
    stage("secondary lookup", lambda b, m: [b.mags_at_mass(m)], base, m2)
    model = post.make_single_pop_model(grid, stars, truth, sig, n_q=6,
                                       upsample=2, device="cpu")
    tin = lk.fused_table_inputs(up, model.q_grid, x[:, 3], x[:, 4],
                                model.abs_coefs, base)
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=tin[0].shape).astype(np.float32))
    stage("plain table fwd", lambda *a: [tb.table_fwd_plain(*a)], *tin)
    stage("plain table bwd", lambda *a: list(tb.table_bwd_plain(*a)),
          *tin, g)
    for use_pallas in (False, True):
        m = dataclasses.replace(model, use_pallas=use_pallas)
        tag = "kernels' plain versions" if use_pallas else "plain path"
        stage(f"log_post, {tag}", lambda p, m=m: [post.log_post(m, p)], x)
        stage(f"d log_post, {tag}",
              grad_of(lambda p, m=m: post.log_post(m, p)), x)

    # The library product itself, at the shape where a batch's rows were
    # seen to move with the number of threads.
    gen = torch.Generator().manual_seed(2)
    stage("torch.bmm [6, 8, 48] @ [6, 48, 200]", lambda a, b: [a @ b],
          torch.randn(6, 8, 48, generator=gen),
          torch.randn(6, 48, 200, generator=gen))

    def timed(fn, n=5):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e3 * (time.perf_counter() - t0) / n

    gen = torch.Generator().manual_seed(0)
    C, B, E2, N = 64, 8, 64, 512
    ax = torch.cumsum(0.01 + torch.rand(C, E2, generator=gen), -1)
    mq = ax[:, :1] + (ax[:, -1:] - ax[:, :1]) * torch.rand(C, N,
                                                           generator=gen)
    targs = (15 + torch.randn(C, B, N, generator=gen), mq[:, None, :],
             torch.rand(C, 1, N, generator=gen),
             16 + torch.randn(C, B, E2, generator=gen),
             *tb.base_axis_columns(ax))
    tg = torch.randn(C, B, N, generator=gen)
    grid64 = synthetic.make_grid(n_eep=64, device="cpu")
    qi = torch.stack([-1.0 + 0.5 * torch.rand(64, generator=gen),
                      0.25 + 0.04 * torch.rand(64, generator=gen),
                      9.0 + 0.5 * torch.rand(64, generator=gen)], 1)

    def iso_fwd_bwd():
        p = qi.clone().requires_grad_(True)
        i = derive_isochrone(grid64, p[:, 0], p[:, 1], p[:, 2])
        (i.mass.sum() + i.mags.sum() + i.agb_tip.sum()).backward()

    ms = {"plain table fwd": timed(lambda: tb.table_fwd_plain(*targs)),
          "plain table bwd": timed(lambda: tb.table_bwd_plain(*targs, tg)),
          "derive_isochrone fwd + bwd": timed(iso_fwd_bwd, 10)}

    print(json.dumps({"root": args.root,
                      "mkl_cbwr": os.environ.get("MKL_CBWR", "default"),
                      "threads": args.threads, "rows": rows, "ms": ms,
                      "wide": wide_bands(args, truth, sig)}))


def wide_bands(args, truth, sig) -> dict:
    """tests/test_torch_wide_bands.py's 29-band case on the port alone:
    the float32 gradient of log_post against the port's float64 one, as a
    share of its largest component, in whole (`f32`) and with only the
    likelihood over the segment table run in float64 (`upstream`: the
    error of the isochrone blend, the lookup and the table), and the
    catalog's largest difference from --catalog's when one is given."""
    import torch

    from base_tpu_torch.grids import synthetic
    from base_tpu_torch.grids.filters import FILTERS
    from base_tpu_torch.model import posterior as post
    from base_tpu_torch.model.stardata import make_ms_stars
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    grid = synthetic.make_grid(feh_axis=np.linspace(-1.5, 0.3, 3),
                               y_axis=np.linspace(0.24, 0.31, 2),
                               age_axis=np.linspace(8.6, 10.1, 4), n_eep=32,
                               bands=tuple(FILTERS), device="cpu")
    gen = torch.Generator().manual_seed(0)
    cat = simulate_cluster(grid, torch.from_numpy(truth), 10, gen,
                           percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    mags, sigmas = sc.mags, sc.sigmas
    out = {}
    if args.save_catalog:
        torch.save({"mags": mags, "sigmas": sigmas}, args.save_catalog)
    if args.catalog:
        other = torch.load(args.catalog)
        out["catalog_diff"] = float((mags - other["mags"]).abs().max())
        mags, sigmas = other["mags"], other["sigmas"]
    model = post.make_single_pop_model(
        grid, make_ms_stars(mags, sigmas, cm_prior=0.99, device="cpu"),
        truth, sig, n_q=4, use_pallas=False, device="cpu")

    def double(o):
        if isinstance(o, torch.Tensor):
            return o.double() if o.is_floating_point() else o
        if dataclasses.is_dataclass(o):
            return dataclasses.replace(o, **{
                f.name: double(getattr(o, f.name))
                for f in dataclasses.fields(o) if f.init})
        if hasattr(o, "_fields"):                      # a NamedTuple
            return type(o)(*map(double, o))
        return o

    def grad_at(m):
        z = torch.from_numpy(pts).to(m.priors.mean.dtype).requires_grad_()
        (d,) = torch.autograd.grad(post.log_post(m, z).sum(), z)
        return d.double().numpy()

    pts = np.tile(truth, (3, 1))
    pts[1:, :5] += np.random.default_rng(10).normal(
        0, [0.05, 0.01, 0.05, 0.05, 0.03], (2, 5))
    pts = pts.astype(np.float32)
    g64 = grad_at(double(model))
    scale = np.abs(g64).max()
    out["f32"] = float(np.abs(grad_at(model) - g64).max() / scale)
    loglik = post.lk.ms_total_loglik
    post.lk.ms_total_loglik = lambda stars, table, *a: loglik(
        double(stars), double(table), *a)
    try:
        out["upstream"] = float(np.abs(grad_at(model) - g64).max() / scale)
    finally:
        post.lk.ms_total_loglik = loglik
    return out


if __name__ == "__main__":
    main()
