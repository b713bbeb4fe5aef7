"""Simulation-based calibration of the port (scripts/torch_sbc.py) on
base_tpu's own 64 data sets: the rank statistics against
tests/test_calibration.py's criteria, a short run of the batched path, and
(`slow`) the three SBC cases of tests/test_calibration.py on the CPU
through the kernels' plain versions, held to base_tpu's criteria."""
import os
import sys

import numpy as np
import pytest
import torch

import test_calibration as jcal

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_sbc  # noqa: E402

torch.set_num_threads(1)


def test_rank_stats_agree_with_base_tpu_criteria():
    """rank_stats' verdict per parameter is `_assert_uniform_ranks`'s on the
    same draws: calibrated draws pass, shifted and over-confident ones
    fail; its constants are tests/test_calibration.py's."""
    assert (torch_sbc.NBINS, torch_sbc.CHI2_CRIT, torch_sbc.R) == (
        jcal.NBINS, jcal.CHI2_CRIT, jcal.R)
    assert np.array_equal(torch_sbc.BASE, jcal.BASE)
    assert np.array_equal(torch_sbc.PRIOR_SIGMA, jcal.PRIOR_SIGMA)
    assert list(torch_sbc.CHECK.values()) == [int(p) for p in jcal.CHECK]
    rng = np.random.default_rng(0)
    truths = jcal._draw_truths(np.random.default_rng(7))
    verdicts = set()
    for shift, width in ((0.0, 1.0), (0.6, 1.0), (0.0, 0.3), (0.2, 1.0)):
        post = truths[None] + shift * np.abs(torch_sbc.PRIOR_SIGMA) \
            + width * np.abs(torch_sbc.PRIOR_SIGMA) * rng.standard_normal(
                (400, 64, 9)).astype(np.float32)
        # Truths drawn from the posterior around them: ranks are uniform
        # when shift = 0 and width = 1.
        post = post - np.abs(torch_sbc.PRIOR_SIGMA) * rng.standard_normal(
            (1, 64, 9)).astype(np.float32)
        got = torch_sbc.rank_stats(post, truths, 4)
        for name, p in torch_sbc.CHECK.items():
            ranks = (post[::4, :, p] < truths[None, :, p]).mean(0)
            try:
                jcal._assert_uniform_ranks(ranks, p)
                ok = True
            except AssertionError:
                ok = False
            assert got[name]["ok"] == ok, (shift, width, name)
            verdicts.add(ok)
    assert verdicts == {True, False}


def test_sbc_batched_run_short(monkeypatch):
    """The SBC HMC case cut to 4 replicas and 30 + 8 transitions at l_max
    4: one density call on all 4 chains an evaluation (1 + 38 x 4), finite
    draws, no kernel launch on the CPU, the metric per replica."""
    case = dict(torch_sbc.CASES["hmc"])
    case["settings"] = dict(case["settings"], n_warmup=30, n_samples=8,
                            l_max=4)
    monkeypatch.setitem(torch_sbc.CASES, "hmc", case)
    res = torch_sbc.run_case("hmc", "cpu", replicas=4)
    torch_sbc.check_launches(res, cuda=False)
    assert res["evaluations"] == 1 + 38 * 4
    assert res["samples"].shape == (8, 4, 9)
    assert set(res["ranks"]) == set(torch_sbc.CHECK)


@pytest.mark.slow
@pytest.mark.parametrize("case", list(torch_sbc.CASES))
def test_sbc_case_on_the_cpu(case):
    """One of tests/test_calibration.py's three SBC cases through the
    port's plain path, at base_tpu's settings on its 64 data sets, held to
    its criteria (chi-square over 8 bins < 24.32, 0.35 < mean rank <
    0.65) for age, [Fe/H], modulus and A_V."""
    res = torch_sbc.run_case(case, "cpu")
    torch_sbc.check_launches(res, cuda=False)
    misses = {p: st for p, st in res["ranks"].items() if not st["ok"]}
    assert not misses, misses
