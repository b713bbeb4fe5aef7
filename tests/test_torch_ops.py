"""Parity of the port's tensor primitives (base_tpu_torch.ops.special,
.interp's `locate`) with base_tpu on identical float32 inputs made with
numpy.  The interpolation weights and lookups are in
tests/test_torch_interp.py (a file holds at most 8 Tier-1 tests:
pytest-xdist's loadfile hands out files with more tests ahead of the JAX
long pole, tests/test_cli_mesh.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.ops import interp as jinterp
from base_tpu.ops import special as jspecial
from base_tpu_torch.ops import interp as tinterp
from base_tpu_torch.ops import special as tspecial

torch.set_num_threads(1)


def _intervals(region: str, n: int = 4000):
    rng = np.random.default_rng({"bulk": 0, "right": 1, "left": 2,
                                 "switch": 3}[region])
    if region == "bulk":
        u0 = rng.uniform(-4.0, 4.0, n)
    elif region == "right":       # one-sided far right tail (Mills)
        u0 = rng.uniform(3.0, 40.0, n)
    elif region == "left":        # one-sided far left tail
        u0 = -rng.uniform(3.0, 40.0, n) - 5.0
    else:                         # both sides of the +-3.5 switch
        u0 = np.concatenate([3.5 + rng.uniform(-1e-3, 1e-3, n // 2),
                             -3.5 - rng.uniform(-1e-3, 1e-3, n // 2)])
        u0[n // 2:] -= 2.0        # so u1 = u0 + width straddles -3.5
    width = 10.0 ** rng.uniform(-3.0, 1.0, n)
    return u0.astype(np.float32), (u0 + width).astype(np.float32)


@pytest.mark.parametrize("region", ["bulk", "right", "left", "switch"])
def test_phi_interval_scaled(region):
    """Same formula in both packages (A-S erf, +-3.5 Mills switch, the
    min(unear_sq, 13) clamp).  The erf branch is a difference of two
    erf values, each carrying ~1e-7 absolute float32 error from exp ulps,
    then multiplied by exp(min(unear_sq, 13) / 2); so the bound is rtol
    1e-5 plus 2e-7 times that scale."""
    u0, u1 = _intervals(region)
    d_j, un_j = jspecial.phi_interval_scaled(jnp.asarray(u0), jnp.asarray(u1))
    d_t, un_t = tspecial.phi_interval_scaled(torch.from_numpy(u0),
                                             torch.from_numpy(u1))
    d_j, un_j, d_t = np.asarray(d_j), np.asarray(un_j), d_t.numpy()
    np.testing.assert_allclose(un_t.numpy(), un_j, rtol=1e-6, atol=0)
    bound = 1e-5 * np.abs(d_j) + 2e-7 * np.exp(0.5 * np.minimum(un_j, 13.0))
    assert np.all(np.abs(d_t - d_j) <= bound), np.max(np.abs(d_t - d_j)
                                                      / bound)
    assert np.all(np.isfinite(d_t))


def test_masked_logsumexp():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 30, (6, 50)).astype(np.float32)
    mask = rng.random((6, 50)) > 0.5
    mask[2] = False                        # an all-masked row -> NEG_INF
    want = np.asarray(jspecial.masked_logsumexp(jnp.asarray(x),
                                                jnp.asarray(mask)))
    got = tspecial.masked_logsumexp(torch.from_numpy(x),
                                    torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    assert got[2] == np.float32(tspecial.NEG_INF)
    # base_tpu's keyword, along the other axis.
    want0 = np.asarray(jspecial.masked_logsumexp(
        jnp.asarray(x), jnp.asarray(mask), axis=0))
    got0 = tspecial.masked_logsumexp(torch.from_numpy(x),
                                     torch.from_numpy(mask), axis=0).numpy()
    np.testing.assert_allclose(got0, want0, rtol=1e-6, atol=1e-5)


def _axis_queries(seed: int):
    rng = np.random.default_rng(seed)
    axis = np.sort(rng.uniform(0.1, 3.0, 40)).astype(np.float32)
    q = rng.uniform(-0.5, 3.5, 300).astype(np.float32)   # incl. off-hull
    q[:40] = axis                                        # exact node hits
    return axis, q


def test_locate():
    axis, q = _axis_queries(5)
    j = jinterp.locate(jnp.asarray(axis), jnp.asarray(q))
    t = tinterp.locate(torch.from_numpy(axis), torch.from_numpy(q))
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_allclose(t.frac.numpy(), np.asarray(j.frac),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t.inside.numpy(), np.asarray(j.inside))
