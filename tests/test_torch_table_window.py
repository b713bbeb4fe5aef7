"""Kernel 1's sparse window (base_tpu_torch.ops.table): on the config-1
mass axis and on adversarial axes (ties, near ties, pads, unsorted), no
node with a non-zero hat weight falls outside it
(tests/test_torch_kernels_plain.py holds the shared builders)."""
import numpy as np
import pytest
import torch


torch.set_num_threads(1)


def _window_misses(x, q):
    """Entries outside the window of kernel 2's rule where the dense
    weight or a factor 6u(1-u) is not exactly 0.0, and the window widths,
    for sorted-or-not axes x [C, E2] and queries q [C, N] (float32)."""
    from base_tpu_torch.ops import table as ttb

    cols = ttb.base_axis_columns(torch.as_tensor(x, dtype=torch.float32))
    m2 = torch.as_tensor(q, dtype=torch.float32)[:, None, :]
    w, up, dn = ttb._weights(m2, *cols)                   # [C, E2, N]
    touched = ((w != 0.0) | (6.0 * up * (1.0 - up) != 0.0)
               | (6.0 * dn * (1.0 - dn) != 0.0))
    lo, hi = ttb.hat_window(m2, *ttb.hat_zero_bounds(*cols))
    e = torch.arange(x.shape[1])[None, :, None]
    inside = (e >= lo[:, None, :]) & (e <= hi[:, None, :])
    return int((touched & ~inside).sum()), (hi - lo + 1).clamp_min(0)


def _ulp_neighbours(v, k=2):
    """v with its float32 neighbours up to k ulps either side."""
    v = np.asarray(v, np.float32)
    out = [v]
    up, dn = v.copy(), v.copy()
    for _ in range(k):
        up = np.nextafter(up, np.float32(np.inf))
        dn = np.nextafter(dn, np.float32(-np.inf))
        out += [up, dn]
    return np.concatenate(out)


def test_table_window_config1_axis():
    """On the config-1 base axes (synthetic grid, 64 EEPs, pads above the
    valid masses) at 8 chain points, every node's non-zero hat weights and
    factors lie in its window, and the window is at most 3 entries of 64."""
    from base_tpu_torch.grids import synthetic as tsyn
    from base_tpu_torch.grids.isochrone import derive_isochrone as tderive

    grid = tsyn.make_grid(n_eep=64, device="cpu")
    rng = np.random.default_rng(11)
    pts = np.array([9.3, 0.27, -0.5]) + rng.normal(0, 0.05, (8, 3))
    pts[0] = (9.3, 0.27, -0.5)
    age, y, feh = (torch.as_tensor(pts[:, i], dtype=torch.float32)
                   for i in range(3))
    iso = tderive(grid, feh, y, age)
    q = (iso.mass[:, :, None] * torch.linspace(0.0, 1.0, 8)).reshape(8, -1)
    misses, width = _window_misses(iso.mass_sorted, q)
    assert misses == 0
    assert int(width.max()) <= 3


@pytest.mark.parametrize("case", ["ties", "near_ties", "pads", "unsorted"])
def test_table_window_adversarial_axes(case):
    """Axes with ties (inverse spacing 1e30), near-ties at float32
    resolution next to a wide gap, pad masses, and an unsorted axis; queries
    on every node and 1-2 ulps either side, below and above the axis, and
    between nodes.  Outside the window every weight and factor is exactly
    0.0; the sorted axes keep the window narrow."""
    f = np.float32
    one_up = np.nextafter(f(1.0), f(2.0))
    axes = {
        "ties": [0.1, 0.3, 0.3, 0.5, 0.5, 0.5, 0.9, 1.2],
        "near_ties": [0.2, 1.0, one_up, np.nextafter(one_up, f(2.0)),
                      1.0000004, 1000.0, 1.0e4, 1.0e4 + 1.0],
        "pads": [0.15, 0.4, 0.8, 1.6, 1.0e4, 1.0e4 + 1, 1.0e4 + 2,
                 1.0e4 + 3],
        "unsorted": [0.4, 0.1, 0.9, 0.3, 1.5, 0.3, 2.0, 0.7],
    }
    x = np.asarray(axes[case], np.float32)
    rng = np.random.default_rng(12)
    q = np.concatenate([
        _ulp_neighbours(x),
        [0.0, x.min() / 2, x.max() * 2, 1.0e5, 1.0e30],
        (x[1:] + x[:-1]) / 2,
        rng.uniform(0.0, 2.5, 64),
    ]).astype(np.float32)
    misses, width = _window_misses(x[None], q[None])
    assert misses == 0
    if case != "unsorted":
        assert int(width.max()) <= 5
