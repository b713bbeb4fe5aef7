"""The port's two-population model, continued (tests/test_torch_multipop.py
holds its log posterior, transforms and model against base_tpu): the
fold of both populations into one pass of the density (one call of each
kernel wrapper per evaluation, rows equal to single-population passes),
the label swap, and a short adaptive-MH run on the two-population
posterior."""
import numpy as np
import pytest
import torch

from base_tpu import constants as jC
from base_tpu.model import multipop as jmp
from base_tpu_torch.inference import mh
from base_tpu_torch.model import likelihood as tlk
from base_tpu_torch.model import multipop as tmp
from test_torch_multipop import (CENTER, CENTER_WD, TRUTH,  # noqa: F401
                                 _Counter, _models, _points, _t,
                                 two_pop_stars, wd_stars)

torch.set_num_threads(1)


@pytest.mark.parametrize("with_wd", [False, True])
def test_fold_calls_each_kernel_once(small_grid, two_pop_stars, wd_stars,
                                     monkeypatch, with_wd):
    """One evaluation of 3 chains builds one table of 6 rows and calls the
    fused table build and the fused marginal once each (the marginal
    twice with WDs: MS and WD tables), forward and backward; the folded
    rows equal single-population passes at Y_A and at Y_B within 1e-6."""
    _, tm = _models(small_grid, two_pop_stars, True, True, 2,
                    wd=wd_stars if with_wd else None)
    table = _Counter(tlk.fused_combined_node_mags)
    marg = _Counter(tlk.fused_log_marginals)
    monkeypatch.setattr(tlk, "fused_combined_node_mags", table)
    monkeypatch.setattr(tlk, "fused_log_marginals", marg)
    x = _t(_points(CENTER_WD if with_wd else CENTER, 3, 9, wd=with_wd))
    x.requires_grad_(True)
    lp = tmp.log_post(tm, x)
    lp.sum().backward()
    assert (table.calls, marg.calls) == (1, 2 if with_wd else 1)
    assert bool(torch.isfinite(x.grad).all())

    with torch.no_grad():
        p2 = tmp.population_params(x)
        folded, in_b = tmp.population_marginals(tm, p2)
        for rows in (slice(0, 3), slice(3, 6)):
            alone, in_alone = tmp.population_marginals(tm, p2[rows])
            torch.testing.assert_close(folded[rows], alone, rtol=1e-6,
                                       atol=0)
            assert torch.equal(in_b[rows], in_alone)
    np.testing.assert_array_equal(p2[:3, jC.Param.YYY].detach(),
                                  x[:, jmp.MP_YYA].detach())
    np.testing.assert_array_equal(p2[3:, jC.Param.YYY].detach(),
                                  x[:, jmp.MP_YYB].detach())


def test_label_swap_symmetry(small_grid, two_pop_stars):
    """Swapping (Y_A, Y_B) with lambda -> 1 - lambda gives the same
    log_post (rtol 1e-6); a one-population explanation and a wrong
    lambda are worse, as in tests/test_multipop.py."""
    _, tm = _models(small_grid, two_pop_stars, binaries=True)
    swap = TRUTH.copy()
    swap[[jmp.MP_YYA, jmp.MP_YYB]] = TRUTH[[jmp.MP_YYB, jmp.MP_YYA]]
    swap[jmp.MP_LAMBDA] = 1.0 - TRUTH[jmp.MP_LAMBDA]
    single = TRUTH.copy()
    single[[jmp.MP_YYA, jmp.MP_YYB]] = 0.28
    bad_lam = TRUTH.copy()
    bad_lam[jmp.MP_LAMBDA] = 0.95
    lp = tmp.log_post(tm, _t(np.stack([TRUTH, swap, single, bad_lam])))
    assert bool(torch.isfinite(lp).all())
    np.testing.assert_allclose(float(lp[1]), float(lp[0]), rtol=1e-6)
    assert float(lp[2]) < float(lp[0]) - 2.0
    assert float(lp[3]) < float(lp[0]) - 3.0


def test_multipop_mh_moves_toward_truth(small_grid, two_pop_stars):
    """Adaptive MH on 4 chains of the two-population posterior (MS only,
    no binaries), started at Y_A = 0.26 and Y_B = 0.29 with lambda 0.5:
    finite log posteriors, pinned dims unmoved, the stage-3 means of Y_A,
    Y_B and lambda as near the truth (0.25, 0.31, 0.6) as
    tests/test_multipop.py asks of base_tpu's MH, and Y_B nearer it than
    the start.  (Y_A trades off against FeH in these 80 stars: its
    posterior mean sits near 0.26.)"""
    _, tm = _models(small_grid, two_pop_stars)
    step = np.zeros(12, np.float32)
    step[[0, 2, 3, 4]] = (0.03, 0.05, 0.05, 0.03)
    step[[jmp.MP_YYA, jmp.MP_YYB, jmp.MP_LAMBDA]] = (0.01, 0.01, 0.08)
    start = TRUTH.copy()
    start[[jmp.MP_YYA, jmp.MP_YYB, jmp.MP_LAMBDA]] = (0.26, 0.29, 0.5)
    cfg = mh.MHConfig(n_stage1=150, n_stage2=150, n_main=200)
    samples, info = mh.run_adaptive_mh(
        tmp.make_logpost_fn(tm), _t(np.tile(start, (4, 1))),
        torch.Generator().manual_seed(54), _t(step), cfg)
    s = samples.numpy()
    assert np.isfinite(info["logposts"].numpy()).all()
    assert (info["logposts"].numpy() > -1e29).all()
    pinned = step == 0
    assert (s[:, :, pinned] == start[pinned]).all()
    ya, yb = s[:, :, jmp.MP_YYA].mean(), s[:, :, jmp.MP_YYB].mean()
    assert abs(ya - 0.25) < 0.03 and abs(yb - 0.31) < 0.03 - 1e-3
    assert abs(yb - 0.31) < abs(0.29 - 0.31)     # Y_B moved toward it
    lam = s[:, :, jmp.MP_LAMBDA]
    assert abs(lam.mean() - 0.6) < max(4 * lam.std(), 0.15)
    rate = float(info["accept_rate"].mean())
    assert 0.05 < rate < 0.7
