"""Kernel 4's skip rules (base_tpu_torch.ops.marglik) on config-1 inputs,
on adversarial ones and near the threshold: never drop a non-zero term
(tests/test_torch_kernels_plain.py holds the shared builders; the rules
at 29 bands are in tests/test_torch_marglik_skip_wide.py)."""
import numpy as np
import pytest
import torch

from base_tpu_torch.ops import marglik as tml
from base_tpu_torch.ops.special import NEG_INF
from test_torch_kernels_plain import (_adversarial_args,
                                     _config1_marglik_args, _group_misses,
                                     _skip_misses, _t)

torch.set_num_threads(1)


@pytest.mark.parametrize("upsample", [1, 4])
def test_marglik_skip_config1(upsample):
    """On config-1 inputs at 4 chains the element rule marks no element
    whose weight is non-zero and marks >= 90% of the live elements (98%
    and 99% at 64 chains, upsample 1 and 4); the group rule marks no group
    holding a non-zero weight and marks >= 75% of the (group, star) pairs
    with a live segment (89% and 94% here)."""
    args = _config1_marglik_args(upsample)
    out = tml.marglik_fwd_plain(*args)
    misses, marked, live = _skip_misses(args, out)
    assert misses == 0
    assert marked >= 0.9 * live
    misses, marked, groups = _group_misses(args, out)
    assert misses == 0
    assert marked >= 0.75 * groups


@pytest.mark.parametrize("case", ["flat", "far_mu", "huge_gamma",
                                  "unobserved", "masked"])
def test_marglik_skip_adversarial_inputs(case):
    """Flat segments, mu far outside [0, 1], gamma ~ 1e7, unobserved
    bands, and a chain with every segment masked (out = NEG_INF): no marked
    element has a non-zero weight, and masked segments are never marked."""
    args = _adversarial_args(case)
    out = tml.marglik_fwd_plain(*args)
    if case == "masked":
        assert bool((out[1] == NEG_INF + args[2]).all())
    misses, marked, live = _skip_misses(args, out)
    assert misses == 0
    skip = tml.marglik_bwd_skip(*args, out)
    assert not bool((skip & ~(args[6] > 0.5)[:, None, :]).any())
    if case in ("far_mu", "huge_gamma"):
        assert marked > 0
    misses, marked, groups = _group_misses(args, out)
    assert misses == 0
    assert marked <= groups


def test_marglik_skip_outputs_near_threshold():
    """With out' set so that the elements' log weights lie around the
    rules' threshold, and out' = NEG_INF for one star, neither rule marks
    an element or a group with a non-zero weight (nor any of that star's);
    with g = 0 every weight is zero and the rules do not depend on g."""
    args = _adversarial_args("plain")
    obs, iv, ln, lo, hi, logw, mask = args
    alpha, beta, gamma, _, _, _ = tml._abg(obs, iv, lo, hi)
    live = (mask > 0.5)[:, None, :]
    core, width, _ = tml._core_width(alpha, beta, gamma, logw[:, None, :],
                                     live)
    peak = (core + torch.log(width)).amax(-1)                # [C, S]
    rng = np.random.default_rng(14)
    total = total_groups = 0
    for shift in (60.0, 90.0, 100.0, 104.0, 110.0, 125.0):
        jitter = _t(rng.uniform(-8.0, 8.0, peak.shape).astype(np.float32))
        out = peak + shift + jitter + ln
        out[0, 3] = NEG_INF + ln[3]
        misses, marked, _ = _skip_misses(args, out)
        assert misses == 0
        assert not bool(tml.marglik_bwd_skip(*args, out)[0, 3].any())
        total += marked
        g0 = torch.zeros_like(out)
        assert _skip_misses(args, out, g0)[:2] == (0, marked)
        misses, marked, _ = _group_misses(args, out)
        assert misses == 0
        assert not bool(tml.marglik_bwd_group_skip(*args, out)[0, 3].any())
        total_groups += marked
    assert total > 0 and total_groups > 0
