"""The plain PyTorch versions of kernels 1 and 2 (base_tpu_torch.ops.table,
what a CPU tensor runs) against base_tpu's jnp path, forward and
backward, on identical float32 inputs made with numpy
(tests/test_torch_kernels_plain.py holds kernels 3 and 4 and the shared
problem builders)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.grids import synthetic as jsyn
from base_tpu.grids.isochrone import derive_isochrone as jderive
from base_tpu.grids.isochrone import upsample_isochrone as jupsample
from base_tpu.model import likelihood as jlk
from base_tpu_torch.grids.isochrone import Isochrone as TIsochrone
from base_tpu_torch.model import likelihood as tlk
from test_torch_kernels_plain import _t

torch.set_num_threads(1)


@functools.cache
def _iso_problem(upsample, E=24, B=6):
    """base_tpu (iso, base iso, q, coefs) as tests/test_pallas_marglik.py
    builds them (derive_isochrone jitted), once per upsample."""
    grid = jsyn.make_grid(n_eep=E, bands=["U", "B", "V", "R", "I", "J"][:B])
    base = jax.jit(jderive)(grid, jnp.asarray(-0.5), jnp.asarray(0.27),
                            jnp.asarray(9.3))
    iso = jupsample(base, upsample) if upsample > 1 else base
    q = jnp.linspace(0.0, 1.0, 7)
    coefs = jnp.asarray(np.linspace(1.2, 0.4, B), jnp.float32)
    return iso, base, q, coefs


def _to_torch_iso(iso):
    """A base_tpu Isochrone as the port's, with a chain axis of 1."""
    return TIsochrone(**{f.name: _t(getattr(iso, f.name))[None]
                         for f in dataclasses.fields(iso)})


@pytest.mark.parametrize("upsample", [1, 3])
def test_fused_table_forward(upsample):
    """The fused table (kernel 1's plain version) == base_tpu's
    build_segment_table_fused in interpret mode, atol 2e-4 as the
    reference's own fused-vs-jnp test; weights to 1e-5 (log of float32
    masses through a different log10)."""
    iso, base, q, coefs = _iso_problem(upsample)
    mod, av = 9.7, 0.23
    want = jax.jit(lambda i, b: jlk.build_segment_table_fused(
        i, q, jnp.asarray(mod), jnp.asarray(av), coefs, sec_iso=b,
        interpret=True))(iso, base)
    got = tlk.build_segment_table_fused(
        _to_torch_iso(iso), _t(q), torch.tensor([mod]), torch.tensor([av]),
        _t(coefs), sec_iso=_to_torch_iso(base))
    for name in ("lo", "hi"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=2e-4, err_msg=name)
    np.testing.assert_allclose(got.logw[0].numpy(), np.asarray(want.logw),
                               atol=1e-5)
    np.testing.assert_array_equal(got.mask[0].numpy(), np.asarray(want.mask))


@pytest.mark.parametrize("upsample", [1, 3])
def test_fused_table_backward(upsample):
    """Kernel 2's plain version (analytic cotangents through the flux
    combine and the smoothstep weights) == jax.grad of base_tpu's fused
    table in interpret mode, on a functional with separate scales for the
    node masses, the base lookup axis and min_mass (as
    tests/test_pallas_marglik.py:183-234): scaled atol 2e-4."""
    iso, base, q, coefs = _iso_problem(upsample)
    rng = np.random.default_rng(8)
    n_lo = (iso.mass.shape[0] - 1) * q.shape[0]
    w_lo = rng.normal(0, 1, (n_lo, coefs.shape[0])).astype(np.float32)

    def f_jax(mod, av, mags, sec_mags, s_mass, s_axis, s_mm):
        iso2 = dataclasses.replace(iso, mags=mags, mass=s_mass * iso.mass)
        base2 = dataclasses.replace(
            base, mags=sec_mags, mass_sorted=s_axis * base.mass_sorted,
            min_mass=s_mm * base.min_mass)
        t = jlk.build_segment_table_fused(iso2, q, mod, av, coefs,
                                          sec_iso=base2, interpret=True)
        return jnp.sum(t.lo * w_lo) + jnp.sum(jnp.cos(t.hi))

    vals = (9.7, 0.23, iso.mags, base.mags, 1.03, 1.01, 0.98)
    want = jax.jit(jax.grad(f_jax, argnums=tuple(range(7))))(
        *[jnp.asarray(v) for v in vals])

    t_iso, t_base = _to_torch_iso(iso), _to_torch_iso(base)
    xs = [torch.tensor([vals[0]]), torch.tensor([vals[1]]),
          _t(iso.mags)[None], _t(base.mags)[None],
          torch.tensor(vals[4]), torch.tensor(vals[5]),
          torch.tensor(vals[6])]
    for x in xs:
        x.requires_grad_(True)
    mod, av, mags, sec_mags, s_mass, s_axis, s_mm = xs
    iso2 = dataclasses.replace(t_iso, mags=mags, mass=s_mass * t_iso.mass)
    base2 = dataclasses.replace(
        t_base, mags=sec_mags, mass_sorted=s_axis * t_base.mass_sorted,
        min_mass=s_mm * t_base.min_mass)
    t = tlk.build_segment_table_fused(iso2, _t(q), mod, av, _t(coefs),
                                      sec_iso=base2)
    out = (t.lo[0] * _t(w_lo)).sum() + torch.cos(t.hi[0]).sum()
    got = torch.autograd.grad(out, xs)
    for w, gt, name in zip(want, got, ["mod", "av", "mags", "sec_mags",
                                       "s_mass", "s_axis", "s_minmass"]):
        w = np.asarray(w)
        gt = gt.numpy().reshape(w.shape)
        scale = np.abs(w).max() + 1e-6
        np.testing.assert_allclose(gt / scale, w / scale, atol=2e-4,
                                   err_msg=name)
