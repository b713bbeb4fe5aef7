"""Parity of the port's interpolation weights and chain-batched lookup
(base_tpu_torch.ops.interp) with base_tpu on identical float32 inputs made
with numpy (tests/test_torch_ops.py holds the special functions and
`locate`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.ops import interp as jinterp
from base_tpu_torch.ops import interp as tinterp
from test_torch_ops import _axis_queries

torch.set_num_threads(1)


@pytest.mark.parametrize("smooth", [False, True])
def test_hat_weight_matrix(smooth):
    axis, q = _axis_queries(6)
    want = np.asarray(jinterp.hat_weight_matrix(jnp.asarray(axis),
                                                jnp.asarray(q), smooth))
    got = tinterp.hat_weight_matrix(torch.from_numpy(axis),
                                    torch.from_numpy(q), smooth).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("smooth", [False, True])
def test_interp1d_dense(smooth):
    """Chain-batched lookup [C, E] x [C, E, B] x [C, Q] equals base_tpu's
    unbatched lookup per chain (float32 matmul reassociation: 1e-5)."""
    axes, ys, qs = [], [], []
    for c in range(3):
        axis, q = _axis_queries(10 + c)
        axes.append(axis)
        qs.append(q)
        ys.append(np.random.default_rng(c).normal(15, 3, (40, 8))
                  .astype(np.float32))
    got = tinterp.interp1d_dense(torch.from_numpy(np.stack(axes)),
                                 torch.from_numpy(np.stack(ys)),
                                 torch.from_numpy(np.stack(qs)),
                                 smooth=smooth).numpy()
    for c in range(3):
        want = np.asarray(jinterp.interp1d_dense(
            jnp.asarray(axes[c]), jnp.asarray(ys[c]), jnp.asarray(qs[c]),
            smooth=smooth))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=1e-4)
