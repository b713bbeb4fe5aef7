"""Wide band sets: the kernel wrappers take up to 32 bands (all 29 filters
of grids/filters.py), and the port's density at B = 29 against
base_tpu's.  The matmul form of the marginal is in
tests/test_torch_matmul_form.py (a file holds at most 8 Tier-1 tests:
pytest-xdist's loadfile hands out files with more tests ahead of the JAX
long pole, tests/test_cli_mesh.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.grids import synthetic as jsyn
from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu_torch import convert
from base_tpu_torch.grids.filters import FILTERS
from base_tpu_torch.model import posterior as tpost
from base_tpu_torch.ops import marglik as tml
from base_tpu_torch.ops import table as ttb

torch.set_num_threads(1)

ALL_BANDS = tuple(FILTERS)
TRUTH = np.array([9.3, 0.27, -0.5, 10.0, 0.3, 0.5, 0.0, 0.0, 0.0], np.float32)
PRIOR_SIGMA = np.array([-1, -1, 0.3, 0.2, 0.1, -1, -1, -1, -1], np.float32)


def _marglik_args(B, C=2, S=6, T=5):
    rng = np.random.default_rng(B)
    arrays = (rng.normal(15, 1, (S, B)), np.ones((S, B)), np.zeros(S),
              rng.normal(15, 1, (C, T, B)), rng.normal(15, 1, (C, T, B)),
              np.zeros((C, T)), np.ones((C, T)))
    return tuple(torch.as_tensor(np.asarray(a, np.float32)) for a in arrays)


def test_filters_hold_29_bands():
    assert len(ALL_BANDS) == 29


@pytest.mark.parametrize("B", [29, 32])
def test_kernel_wrappers_take_up_to_32_bands(B):
    """The wrappers' shape checks pass B = 29 and 32 and refuse only what
    the card does: a CPU tensor (kernels 1-2 also fit their shared memory
    at the CLI's base axis of E2 = 80)."""
    args = _marglik_args(B)
    for fn in (tml.marglik_fwd_cuda, tml.marglik_mm_fwd_cuda):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            fn(*args)
    app1 = torch.zeros((2, B, 7))
    secT = torch.zeros((2, B, 80))
    sizes, shapes = ttb._shapes(app1, secT)
    assert sizes == (2, B, 7, 80) and shapes[3] == (2, B, 80)
    assert ttb.smem_bytes(B, 80) <= ttb.MAX_SMEM_BYTES


def test_kernel_wrappers_refuse_33_bands():
    """Past the kernels' largest band class the wrappers raise, naming the
    limit, and count no launch."""
    args = _marglik_args(33)
    before = (tml.marglik_fwd_launches, tml.marglik_mm_fwd_launches,
              ttb.table_fwd_launches)
    for fn in (tml.marglik_fwd_cuda, tml.marglik_mm_fwd_cuda):
        with pytest.raises(ValueError, match="at most 32 bands, got 33"):
            fn(*args)
    with pytest.raises(ValueError, match="at most 32 bands, got 33"):
        ttb.table_fwd_cuda(torch.zeros((2, 33, 7)), *([None] * 2),
                           torch.zeros((2, 33, 80)), *([None] * 4))
    assert before == (tml.marglik_fwd_launches, tml.marglik_mm_fwd_launches,
                      ttb.table_fwd_launches)


def _fields(obj, static=("bands", "name")):
    return {f.name: (getattr(obj, f.name) if f.name in static
                     else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def wide_grid():
    return jsyn.make_grid(feh_axis=np.linspace(-1.5, 0.3, 3),
                          y_axis=np.linspace(0.24, 0.31, 2),
                          age_axis=np.linspace(8.6, 10.1, 4),
                          n_eep=32, bands=ALL_BANDS)


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


def _value_and_grad(model, pts):
    x = torch.from_numpy(pts).to(model.priors.mean.dtype).requires_grad_(True)
    v = tpost.log_post(model, x)
    (g,) = torch.autograd.grad(v.sum(), x)
    return v.detach().numpy(), g.numpy()


def test_log_post_at_29_bands_matches_jax(wide_grid):
    """log_post and its gradient on a 29-band grid (10 simulated stars,
    binaries, upsample 1, the plain path) against jax.value_and_grad of
    base_tpu.  In float32 the value to 3e-4 relative, as
    tests/test_torch_posterior.py holds it.  The gradient is a sum of 29
    bands' large per-star terms that cancel, so both are evaluated in
    float64 too (base_tpu under jax.enable_x64): there the port's value is
    held to base_tpu's to 1e-6 relative and its gradient to 1e-4 of the
    largest component (6e-8 and 8e-6 here), and the port's float32 gradient
    to base_tpu's float64 one to 2e-3 (1.7e-3 here; jitted base_tpu's own
    float32 gradient sits 2.2e-2 from it, in the absorption component)."""
    from base_tpu_torch.sim.scatter import scatter_cluster
    from base_tpu_torch.sim.simulate import simulate_cluster

    tgrid = convert.grid_from_numpy(**_fields(wide_grid), device="cpu")
    gen = torch.Generator().manual_seed(0)
    cat = simulate_cluster(tgrid, torch.from_numpy(TRUTH), 10, gen,
                           percent_binary=0.3)
    sc = scatter_cluster(cat.mags, gen, limit_mag=24.0)
    assert sc.mags.shape == (10, 29)
    stars = jmake_stars(sc.mags.numpy(), sc.sigmas.numpy(), cm_prior=0.99)
    jm = jpost.make_single_pop_model(wide_grid, stars, TRUTH, PRIOR_SIGMA,
                                     n_q=4, use_pallas=False)
    tm = convert.model_from_numpy(
        _fields(wide_grid), _fields(stars), TRUTH, PRIOR_SIGMA,
        np.asarray(jm.q_grid), np.asarray(jm.abs_coefs), use_pallas=False,
        device="cpu")
    rng = np.random.default_rng(10)
    pts = np.tile(TRUTH, (3, 1))
    pts[1:, :5] += rng.normal(0, [0.05, 0.01, 0.05, 0.05, 0.03], (2, 5))
    pts = pts.astype(np.float32)

    def jax_value_and_grad(model, p):
        return map(np.asarray, jax.jit(jax.vmap(jax.value_and_grad(
            lambda q: jpost.log_post(model, q))))(p))

    want_v, _ = jax_value_and_grad(jm, jnp.asarray(pts))
    with jax.enable_x64(True):
        jm64 = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jm)
        want64_v, want64_g = jax_value_and_grad(
            jm64, jnp.asarray(pts, jnp.float64))
    assert want64_g.dtype == np.float64
    got_v, got_g = _value_and_grad(tm, pts)
    got64_v, got64_g = _value_and_grad(_double(tm), pts)
    assert np.all(np.isfinite(got_v)) and np.all(np.isfinite(got_g))
    np.testing.assert_array_less(np.abs(got_v - want_v),
                                 3e-4 * np.maximum(np.abs(want_v), 1.0))
    np.testing.assert_array_less(np.abs(got64_v - want64_v),
                                 1e-6 * np.maximum(np.abs(want64_v), 1.0))
    scale = np.abs(want64_g).max()
    assert np.abs(got64_g - want64_g).max() / scale <= 1e-4
    assert np.abs(got_g - want64_g).max() / scale <= 2e-3
