"""A chain's row of the port's density does not depend on the other chains
in its batch (CPU).

The isochrone blend, the secondary-mass lookup and the plain versions of
the table kernels sum over small windows of nodes in a fixed order, by
elementwise operations, where they were library products (an einsum, a
batched matmul) whose summation order MKL may pick by the number of rows:
on one MKL code path a chain's isochrone mass moved by 2.4e-7 with its
batch.  (a) In subprocesses that import only torch and base_tpu_torch,
under the default MKL path and under MKL_CBWR=COMPATIBLE (the variable is
read once, when MKL loads), derive_isochrone and log_post (value and
gradient; the plain path and the kernels' plain versions) on the config-1
model at a small size give every subset of a batch the batch's rows bit
for bit.  (b) The window forms against the dense forms they replace, in
float64: the same values, and the same gradients at exact grid nodes,
where torch's clamp gives the node below a bracket a derivative too."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from base_tpu_torch.grids import synthetic
from base_tpu_torch.grids.isochrone import derive_isochrone
from base_tpu_torch.ops import interp as iops
from base_tpu_torch.ops import table as tb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The subprocess: config 1's model (chip_smoke.py's make_data/make_model:
# the synthetic grid at n_eep 64, n_q 8, 30% binaries, limit_mag 24) at
# 24 stars, 6 chains near the truth, one of them on an age node.
CHILD = r'''
import json, sys
import numpy as np
import torch
from base_tpu_torch.grids import synthetic
from base_tpu_torch.grids.isochrone import derive_isochrone
from base_tpu_torch.model import posterior as post
from base_tpu_torch.model.stardata import make_ms_stars
from base_tpu_torch.sim.scatter import scatter_cluster
from base_tpu_torch.sim.simulate import simulate_cluster

torch.set_num_threads(1)
TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0, 0, 0], np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32)
grid = synthetic.make_grid(n_eep=64, device="cpu")
gen = torch.Generator().manual_seed(0)
cat = simulate_cluster(grid, torch.as_tensor(TRUTH), 24, gen,
                       percent_binary=0.3)
sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
stars = make_ms_stars(sc.mags, sc.sigmas, cm_prior=0.99, device="cpu")
x = np.tile(TRUTH, (6, 1))
x[1:, :5] += np.random.default_rng(1).normal(
    0, [0.05, 0.01, 0.05, 0.05, 0.03], (5, 5))
x[5, 0] = float(grid.age[5])
x = torch.from_numpy(x.astype(np.float32))
SUBSETS = ((0, 1), (1, 3), (3, 6), (0, 5), (5, 6))


def iso(p):
    i = derive_isochrone(grid, p[:, 2], p[:, 1], p[:, 0])
    return [i.mass, i.mags, i.valid, i.agb_tip, i.in_bounds,
            i.mass_sorted, i.min_mass]


def density(model):
    def f(p):
        p = p.clone().requires_grad_(True)
        v = post.log_post(model, p)
        (g,) = torch.autograd.grad(v.sum(), p)
        return [v.detach(), g]
    return f


fns = {"derive_isochrone": iso}
for use_pallas, upsample in ((False, 1), (True, 1), (True, 4)):
    m = post.make_single_pop_model(grid, stars, TRUTH, PRIOR_SIGMA, n_q=8,
                                   upsample=upsample, use_pallas=use_pallas,
                                   device="cpu")
    fns[f"log_post use_pallas={use_pallas} upsample={upsample}"] = density(m)
out = {}
for name, fn in fns.items():
    full = fn(x)
    diff = 0.0
    for lo, hi in SUBSETS:
        for a, b in zip(full, fn(x[lo:hi])):
            if not torch.equal(a[lo:hi], b):
                diff = max(diff, float((a[lo:hi].double() - b.double())
                                       .abs().max()))
    out[name] = diff
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "base_tpu"))
print(json.dumps({"max_diff": out, "foreign": foreign}))
'''


@pytest.mark.parametrize("mkl_path", ["default", "COMPATIBLE"])
def test_rows_equal_their_subsets(mkl_path):
    """(a) Every subset's rows equal the batch's, bit for bit: the
    isochrone's fields, and log_post's value and gradient on the plain
    path and through the kernels' plain versions (upsample 1 and 4)."""
    env = {k: v for k, v in os.environ.items() if k != "MKL_CBWR"}
    if mkl_path != "default":
        env["MKL_CBWR"] = mkl_path
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["foreign"] == []
    assert len(got["max_diff"]) == 4
    assert got["max_diff"] == {k: 0.0 for k in got["max_diff"]}


def _grid_f64():
    grid = synthetic.make_grid(feh_axis=np.linspace(-1.5, 0.3, 4),
                               y_axis=np.linspace(0.24, 0.31, 3),
                               age_axis=np.linspace(8.6, 10.1, 6), n_eep=24,
                               device="cpu")
    return type(grid)(**{
        f: (getattr(grid, f).double() if f not in ("bands", "name")
            else getattr(grid, f))
        for f in ("feh", "y", "age", "mass", "mags", "valid", "agb_tip",
                  "bands", "name")})


def test_window_blend_equals_dense_blend():
    """(b) derive_isochrone's 27-corner window against the dense blend in
    float64, at points inside cells, on exact nodes of each axis and on
    the hull's corners, and past the hull: values to 1e-12, and the
    gradients of mass, mags and agb_tip in the three queries to 1e-9
    relative (at an exact node the dense form's gradient has a term from
    the node below the bracket, so a 2-node blend would miss it)."""
    grid = _grid_f64()
    f, y, a = (float(t) for t in (grid.feh[1], grid.y[1], grid.age[2]))
    q = torch.tensor([[-0.71, 0.263, 9.33],      # inside a cell
                      [f, 0.263, 9.33],          # on a FeH node
                      [-0.71, y, 9.33],          # on a Y node
                      [-0.71, 0.263, a],         # on an age node
                      [f, y, a],                 # on a node of every axis
                      [float(grid.feh[0]), float(grid.y[0]),
                       float(grid.age[0])],      # the hull's lower corner
                      [float(grid.feh[-1]), float(grid.y[-1]),
                       float(grid.age[-1])],     # its upper corner
                      [0.5, 0.2, 10.4]],         # past the hull
                     dtype=torch.float64)
    got_q = q.clone().requires_grad_(True)
    want_q = q.clone().requires_grad_(True)
    iso = derive_isochrone(grid, got_q[:, 0], got_q[:, 1], got_q[:, 2])
    dense = chip_smoke.isochrone_dense(grid, want_q[:, 0], want_q[:, 1],
                                       want_q[:, 2])
    valid = iso.valid > 0.5
    for got, want in zip((iso.mass, iso.mags, iso.agb_tip), dense):
        sel = valid if got.shape[:2] == valid.shape else slice(None)
        torch.testing.assert_close(got[sel], want[sel], rtol=1e-12,
                                   atol=1e-12)
    gen = torch.Generator().manual_seed(0)
    for got, want in zip((iso.mass, iso.mags, iso.agb_tip), dense):
        w = torch.randn(got.shape, generator=gen, dtype=torch.float64)
        if got.shape[:2] == valid.shape:
            w = w * valid.reshape(valid.shape + (1,) * (got.ndim - 2))
        (g1,) = torch.autograd.grad((got * w).sum(), got_q,
                                    retain_graph=True)
        (g2,) = torch.autograd.grad((want * w).sum(), want_q,
                                    retain_graph=True)
        torch.testing.assert_close(g1, g2, rtol=1e-9,
                                   atol=1e-9 * float(g2.abs().max()))


@pytest.mark.parametrize("smooth", [False, True])
def test_interp_window_equals_dense_product(smooth):
    """(b) interp1d_dense's three-node window against W @ y in float64,
    per-chain axes with queries between nodes, on nodes and past both
    ends: values to 1e-12, gradients in the queries, the axis and the
    payload to 1e-9 relative."""
    gen = torch.Generator().manual_seed(3)
    x = torch.cumsum(0.1 + torch.rand(3, 12, generator=gen,
                                      dtype=torch.float64), -1)
    y = torch.randn(3, 12, 4, generator=gen, dtype=torch.float64)
    xq = x[:, 0:1] - 0.3 + (x[:, -1:] - x[:, 0:1] + 0.6) * torch.rand(
        3, 40, generator=gen, dtype=torch.float64)
    xq[:, :6] = x[:, 2:8]                         # exact node hits
    xq[:, 6] = x[:, 0]
    xq[:, 7] = x[:, -1]
    args = [t.clone().requires_grad_(True) for t in (x, y, xq)]
    ref = [t.clone().requires_grad_(True) for t in (x, y, xq)]
    got = iops.interp1d_dense(args[0], args[1], args[2], smooth=smooth)
    want = iops.hat_weight_matrix(ref[0], ref[2], smooth=smooth) @ ref[1]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    w = torch.randn(got.shape, generator=gen, dtype=torch.float64)
    g1 = torch.autograd.grad((got * w).sum(), args)
    g2 = torch.autograd.grad((want * w).sum(), ref)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-9,
                                   atol=1e-9 * float(b.abs().max()))


def test_table_plain_runs_equal_dense_products():
    """(b) The plain versions of kernels 1 and 2, summed along each node's
    window of base-axis entries, against the dense products they replace
    (secT @ W and its three transposed products) in float64, on a mass
    axis with a tie and queries past both ends and on its nodes."""
    gen = torch.Generator().manual_seed(5)
    C, B, E2, N = 3, 5, 10, 30
    x = torch.cumsum(0.05 + torch.rand(C, E2, generator=gen,
                                       dtype=torch.float64), -1)
    x[1, 4] = x[1, 3]                             # a tie
    m2 = (x[:, :1] - 0.2 + (x[:, -1:] - x[:, :1] + 0.4)
          * torch.rand(C, N, generator=gen, dtype=torch.float64))
    m2[:, :4] = x[:, 3:7]                         # exact node hits
    cols = tb.base_axis_columns(x)
    app1 = 15 + torch.randn(C, B, N, generator=gen, dtype=torch.float64)
    lit = torch.rand(C, 1, N, generator=gen, dtype=torch.float64)
    secT = 16 + torch.randn(C, B, E2, generator=gen, dtype=torch.float64)
    args = (app1, m2[:, None, :], lit, secT, *cols)
    g = torch.randn(C, B, N, generator=gen, dtype=torch.float64)

    torch.testing.assert_close(tb.table_fwd_plain(*args),
                               chip_smoke.table_fwd_dense(*args),
                               rtol=1e-12, atol=1e-12)
    names = ("dapp1", "dm2", "dlit", "dsecT", "dxl", "dinv_dl", "dxr",
             "dinv_dr")
    for name, got, ref in zip(names, tb.table_bwd_plain(*args, g),
                              chip_smoke.table_bwd_dense(*args, g)):
        torch.testing.assert_close(got, ref, rtol=1e-12,
                                   atol=1e-12 * float(ref.abs().max()),
                                   msg=name)
