"""Kernel 4's skip rules (base_tpu_torch.ops.marglik) at 29 bands, on the
plain problem and adversarial ones: never drop a non-zero term
(tests/test_torch_kernels_plain.py holds the shared builders)."""
import pytest
import torch

from base_tpu_torch.ops import marglik as tml
from test_torch_kernels_plain import (_adversarial_args, _group_misses,
                                     _skip_misses)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", ["plain", "flat", "far_mu", "huge_gamma",
                                  "unobserved"])
def test_marglik_skip_rules_at_29_bands(case):
    """The adversarial inputs at B = 29, every filter of grids/filters.py
    (the kernels take up to 32 bands): neither rule marks an element or a
    group holding a non-zero weight, and both still mark."""
    args = _adversarial_args(case, B=29)
    out = tml.marglik_fwd_plain(*args)
    misses, marked, live = _skip_misses(args, out)
    assert misses == 0
    assert 0 < marked <= live
    misses, marked, groups = _group_misses(args, out)
    assert misses == 0
    assert marked <= groups
