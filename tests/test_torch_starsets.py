"""Star sets: kernels 3-4's plain versions, the skip rules and the
single-population density over a leading star-set axis (G data sets, chain
c on set c // (C // G)), on base_tpu's own SBC data sets
(tests/data/sbc_stars.npz).  The stacked density is held to base_tpu's
`jax.vmap` of make_logpost_z_fn over the same stacked stars, the port's
counterpart of which it is."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.model import posterior as jpost
from base_tpu.model.stardata import make_ms_stars as jmake_stars
from base_tpu_torch.model import posterior as tpost
from base_tpu_torch.ops import marglik as ml

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_sbc  # noqa: E402
from test_torch_multipop import _double  # noqa: E402

torch.set_num_threads(1)
G, K = 4, 2          # star sets, chains a set
# The three SBC cases' models: (collection, n_q, binaries).
MODELS = {"ms": ("ms", 4, False), "bin": ("bin", 8, True)}


@pytest.fixture(scope="module")
def set_model():
    model, truths = torch_sbc.sbc_model(*MODELS["ms"], "cpu", G)
    return model, truths


def _marg_inputs(model, x):
    table, _ = tpost.ms_table(model, torch.from_numpy(x))
    st = model.stars
    return (st.obs_mags, st.inv_var, st.log_norm, table.lo.contiguous(),
            table.hi.contiguous(), table.logw.contiguous(),
            table.mask.float())


def _set_slice(args, g, k):
    """Set g's star rows and its chains' table rows: a one-set call."""
    obs, iv, ln, *tab = args
    return (obs[g], iv[g], ln[g], *(t[g * k:(g + 1) * k] for t in tab))


def test_plain_kernels_over_sets_equal_one_set_calls(set_model):
    """marglik_fwd_plain, marglik_bwd_plain and both skip rules over G = 4
    sets (2 chains a set) against G one-set calls on each set's chains:
    the forward and the skip marks equal; the backward's star sums equal
    up to summation order (1e-6 of each output's largest magnitude)."""
    model, truths = set_model
    args = _marg_inputs(model, torch_sbc.near_truths(truths, K, 1))
    out = ml.marglik_fwd_plain(*args)
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=out.shape).astype(np.float32))
    grads = ml.marglik_bwd_plain(*args, out, g)
    skip = ml.marglik_bwd_skip(*args, out)
    group = ml.marglik_bwd_group_skip(*args, out)
    assert torch.isfinite(out).all() and 0 < skip.float().mean() < 1
    for s in range(G):
        one = _set_slice(args, s, K)
        rows = slice(s * K, (s + 1) * K)
        assert torch.equal(out[rows], ml.marglik_fwd_plain(*one))
        assert torch.equal(skip[rows], ml.marglik_bwd_skip(*one, out[rows]))
        assert torch.equal(group[rows],
                           ml.marglik_bwd_group_skip(*one, out[rows]))
        for a, b in zip(grads, ml.marglik_bwd_plain(*one, out[rows],
                                                    g[rows])):
            scale = float(b.abs().max()) + 1e-30
            assert float((a[rows] - b).abs().max()) <= 1e-6 * scale


def test_fused_marginal_over_sets_autograd(set_model):
    """fused_log_marginals over sets on CPU tensors: its value is the plain
    version's; d log_norm is g summed over each set's chains [G, S]; dlo,
    dhi and dlogw are marglik_bwd_plain's."""
    model, truths = set_model
    args = list(_marg_inputs(model, torch_sbc.near_truths(truths, K, 3)))
    ln = args[2].clone().requires_grad_(True)
    lo = args[3].clone().requires_grad_(True)
    out = ml.fused_log_marginals(args[0], args[1], ln, lo, *args[4:])
    want = ml.marglik_fwd_plain(*args)
    assert torch.equal(out.detach(), want)
    g = torch.from_numpy(np.random.default_rng(4).normal(
        size=out.shape).astype(np.float32))
    dln, dlo = torch.autograd.grad(out, (ln, lo), g)
    assert dln.shape == (G, model.stars.n_stars)
    torch.testing.assert_close(dln, g.reshape(G, K, -1).sum(1))
    assert torch.equal(dlo, ml.marglik_bwd_plain(*args, want, g)[0])


@pytest.fixture(scope="module")
def jax_vmapped():
    """base_tpu's value and gradient of make_logpost_z_fn, vmapped over
    (star set, z): one jit a model (its plain marginal, use_pallas False:
    the port's plain path is held to it)."""
    cache = {}

    def get(key, grid):
        if key not in cache:
            collection, n_q, binaries = MODELS[key]
            sets = torch_sbc.load_sets(collection, G)
            stars = [jmake_stars(m, s, cm_prior=0.999)
                     for m, s in zip(sets["mags"], sets["sigmas"])]
            batched = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                             *stars)
            frame = jpost.make_single_pop_model(
                grid, stars[0], prior_mean=torch_sbc.BASE,
                prior_sigma=torch_sbc.PRIOR_SIGMA, n_q=n_q,
                binaries=binaries, use_pallas=False)
            tr = jpost.default_transform(frame)

            def one(stars_r, z):
                model_r = dataclasses.replace(frame, stars=stars_r)
                return jpost.make_logpost_z_fn(model_r, tr)(z)

            vg = jax.jit(jax.vmap(jax.value_and_grad(one, argnums=1)))
            cache[key] = (batched, vg, sets["truths"])
        return cache[key]

    return get


@pytest.mark.parametrize("key", list(MODELS))
def test_stacked_density_matches_base_tpu_vmap(small_grid, jax_vmapped,
                                               key):
    """The port's make_logpost_z_fn on a model over G = 4 star sets, 2
    chains a set (kernels' plain versions; with binaries the fused table),
    against base_tpu's vmap over each chain's (set, z): value within 1e-4
    of max(|log_post|, 1), gradient within 2e-3 of its largest component
    (tests/test_torch_posterior_density.py's scaling).  With binaries and
    sigmas of 0.01 base_tpu's own float32 value sits up to ~3e-4 of
    |log_post| from a float64 evaluation of the port's plain path (the
    port ~3e-5): at such a point the port is held to 1e-4 of the float64
    value, and to base_tpu within base_tpu's own distance from it plus
    1e-4 (tests/test_torch_multipop.py's rule, kept to those points)."""
    batched, vg, truths = jax_vmapped(key, small_grid)
    model, _ = torch_sbc.sbc_model(*MODELS[key], "cpu", G)
    tr = tpost.default_transform(model)
    x = torch_sbc.near_truths(truths, K, 5)
    z = tr.inverse(torch.from_numpy(x)).detach().requires_grad_(True)
    got = tpost.make_logpost_z_fn(model, tr)(z)
    (got_g,) = torch.autograd.grad(got.sum(), z)
    sets = np.repeat(np.arange(G), K)
    stars_c = jax.tree_util.tree_map(lambda a: a[sets], batched)
    want, want_g = vg(stars_c, jnp.asarray(z.detach().numpy()))
    want, want_g = np.asarray(want), np.asarray(want_g)
    got, got_g = got.detach().numpy(), got_g.numpy()
    assert np.isfinite(got).all() and np.isfinite(got_g).all()
    m64 = dataclasses.replace(_double(model), use_pallas=False)
    want64 = tpost.make_logpost_z_fn(m64, tpost.default_transform(m64))(
        z.detach().double()).numpy()
    tol = 1e-4 * np.maximum(np.abs(want64), 1.0)
    ref_err = np.abs(want - want64)
    np.testing.assert_array_less(np.abs(got - want64), tol)
    np.testing.assert_array_less(np.abs(got - want),
                                 np.where(ref_err < tol, tol, ref_err + tol))
    scale = np.abs(want_g).max()
    np.testing.assert_allclose(got_g / scale, want_g / scale, atol=2e-3)


def test_stacked_density_equals_one_set_models(set_model):
    """log_post of the model over G sets equals, chain for chain, log_post
    of G one-set models (dataclasses.replace with set g's stars) on that
    set's chains, value and gradient within float32 summation order
    (1e-6 relative)."""
    model, truths = set_model
    x = torch.from_numpy(torch_sbc.near_truths(truths, K, 6))
    x.requires_grad_(True)
    lp = tpost.log_post(model, x)
    (grad,) = torch.autograd.grad(lp.sum(), x)
    for s in range(G):
        one_stars = type(model.stars)(**{
            f.name: getattr(model.stars, f.name)[s]
            for f in dataclasses.fields(model.stars)})
        one = dataclasses.replace(model, stars=one_stars)
        xs = x.detach()[s * K:(s + 1) * K].clone().requires_grad_(True)
        want = tpost.log_post(one, xs)
        (want_g,) = torch.autograd.grad(want.sum(), xs)
        rows = slice(s * K, (s + 1) * K)
        torch.testing.assert_close(lp.detach()[rows], want.detach(),
                                   rtol=1e-6, atol=0)
        torch.testing.assert_close(grad[rows], want_g, rtol=1e-5,
                                   atol=1e-6 * float(want_g.abs().max()))
