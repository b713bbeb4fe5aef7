"""The port's IFMRs against base_tpu: every kind, fixed and tunable, on
identical float32 inputs (tests/test_torch_wd.py holds the rest of the
WD branch)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.model import ifmr as jifmr
from base_tpu_torch.model import ifmr as tifmr
from test_torch_wd import _params, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", jifmr.FIXED_IFMRS + jifmr.TUNABLE_IFMRS)
def test_ifmr_matches_jax(kind):
    """Every IFMR kind on [K] masses for [C, 9] parameters (the tunable
    ones read each chain's coefficients) agrees with base_tpu to 1e-6."""
    p = _params(4, 3)
    p[:, 8] = np.linspace(-0.02, 0.02, 4)
    m = np.linspace(0.8, 8.0, 33).astype(np.float32)
    got = tifmr.ifmr_mass(kind, _t(m), _t(p)).expand(4, -1).numpy()
    for c in range(4):
        want = np.asarray(jifmr.ifmr_mass(kind, jnp.asarray(m),
                                          jnp.asarray(p[c])))
        np.testing.assert_allclose(got[c], want, rtol=1e-6, atol=1e-6)
    assert tifmr.default_ifmr_start() == jifmr.default_ifmr_start()
