"""The port's WD grids (the synthetic cooling family and Bergeron tables,
their interpolation and hull flags) and the precursor lifetime against
base_tpu on identical float32 inputs (tests/test_torch_wd.py holds the WD
chain, marginals and log posterior; tests/test_torch_ifmr.py the
IFMRs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.grids.wd_atmosphere import synthetic_bergeron as jbergeron
from base_tpu.grids.wd_atmosphere import wd_mags as jwd_mags
from base_tpu.grids.wd_cooling import synthetic_wd_cooling as jcooling
from base_tpu.grids.wd_cooling import wd_teff_radius as jteff_radius
from base_tpu.model import wd as jwd
from base_tpu_torch.grids.wd_atmosphere import synthetic_bergeron
from base_tpu_torch.grids.wd_atmosphere import wd_mags
from base_tpu_torch.grids.wd_cooling import synthetic_wd_cooling
from base_tpu_torch.grids.wd_cooling import wd_teff_radius
from base_tpu_torch.model import wd as twd
from test_torch_wd import _params, _t, grids  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("carbonicity", [True, False])
def test_wd_cooling_matches_jax(carbonicity):
    """The synthetic cooling family equals base_tpu's; trilinear (bilinear
    on a length-1 carbonicity axis) log Teff and log R agree to 1e-6 at
    [C, K] queries inside and outside the hull, and the hull flags
    agree."""
    jg = jcooling(with_carbonicity=carbonicity)
    tg = synthetic_wd_cooling(with_carbonicity=carbonicity, device="cpu")
    for name in ("carb", "mass", "log_age", "log_teff", "log_radius"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    rng = np.random.default_rng(1)
    C, K = 3, 40
    carb = rng.uniform(-0.1, 1.1, (C, 1)).astype(np.float32)
    mass = rng.uniform(0.3, 1.3, (C, K)).astype(np.float32)
    age = rng.uniform(4.8, 10.4, (C, K)).astype(np.float32)
    lt, lr, inside = wd_teff_radius(tg, _t(carb), _t(mass), _t(age))
    want = jax.jit(jax.vmap(jax.vmap(
        lambda x, m, a: jteff_radius(jg, x, m, a), in_axes=(None, 0, 0))))(
        jnp.asarray(carb[:, 0]), jnp.asarray(mass), jnp.asarray(age))
    for got, w in zip((lt, lr), want[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(inside.numpy(), np.asarray(want[2]))
    assert 0 < int(inside.sum()) < C * K


def test_wd_atmosphere_matches_jax():
    """The synthetic Bergeron tables equal base_tpu's; DA and DB mags at
    [C, K] (log Teff, log g) queries agree to 1e-5, hull flags exactly;
    select_atm_bands takes the same columns."""
    jg, tg = jbergeron(), synthetic_bergeron(device="cpu")
    np.testing.assert_array_equal(tg.mags.numpy(), np.asarray(jg.mags))
    assert tg.bands == jg.bands
    rng = np.random.default_rng(2)
    teff = rng.uniform(3.4, 4.5, (3, 40)).astype(np.float32)
    logg = rng.uniform(6.9, 9.1, (3, 40)).astype(np.float32)
    for wd_type in (0, 1):
        got, inside = wd_mags(tg, _t(teff), _t(logg), wd_type)
        want, w_in = jax.jit(jax.vmap(jax.vmap(
            lambda t, g: jwd_mags(jg, t, g, wd_type))))(jnp.asarray(teff),
                                                        jnp.asarray(logg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(inside.numpy(), np.asarray(w_in))
    from base_tpu.grids.wd_atmosphere import select_atm_bands as jselect
    from base_tpu_torch.grids.wd_atmosphere import select_atm_bands

    idx, bands = [0, 2, 5], ("U", "V", "J")
    np.testing.assert_array_equal(
        select_atm_bands(tg, idx, bands).mags.numpy(),
        np.asarray(jselect(jg, idx, bands).mags))


def test_wd_prec_logage_and_gradient(grids):
    """The precursor lifetime on each chain's own tip(age) axis, and its
    gradient in FeH and Y through the interpolation weights, agree with
    base_tpu (1e-5 in log age, 1e-4 of the largest gradient)."""
    jgrid, tgrid = grids
    p = _params(5, 4)
    mz = np.linspace(0.8, 8.0, 40).astype(np.float32)
    w = np.random.default_rng(5).normal(size=(5, 40)).astype(np.float32)
    feh = _t(p[:, 2]).requires_grad_(True)
    y = _t(p[:, 1]).requires_grad_(True)
    prec = twd.wd_prec_logage(tgrid, feh, y, _t(mz))
    gf, gy = torch.autograd.grad((prec * _t(w)).sum(), (feh, y))

    def f(fe, yy, wc):
        prec = jwd.wd_prec_logage(jgrid, fe, yy, jnp.asarray(mz))
        return jnp.sum(prec * wc), prec

    (_, want), (jf, jy) = jax.jit(jax.vmap(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)))(
        jnp.asarray(p[:, 2]), jnp.asarray(p[:, 1]), jnp.asarray(w))
    np.testing.assert_allclose(prec.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    for c in range(5):
        scale = max(abs(float(jf[c])), abs(float(jy[c])), 1.0)
        assert abs(float(gf[c]) - float(jf[c])) <= 1e-4 * scale
        assert abs(float(gy[c]) - float(jy[c])) <= 1e-4 * scale
    assert float(gf.abs().max()) > 0 and float(gy.abs().max()) > 0
