"""base_tpu's last two slow checks on the port, on the CPU through the
kernels' plain versions (`slow`; scripts/torch_slow_checks.py runs them on
the card): tests/test_multipop.py's two-population HMC recovery through
the ordered transform (case A) and tests/test_vi.py's VI on the cluster
posterior (case C), on base_tpu's own catalogs, held to its criteria.
Their Tier-1 twins are in tests/test_torch_slow_checks_data.py."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import torch_slow_checks as sc  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.slow
@pytest.mark.parametrize("case", ["A", "C"])
def test_slow_check_on_the_cpu(case):
    """Case A: accept > 0.5, Y_B > Y_A in every draw, Y_A and Y_B within
    0.02 of the truth, lambda within max(4 sd, 0.15), split R-hat < 1.05
    on age, [Fe/H], modulus, A_V, Y_A, Y_B and lambda (8 chains, 500 +
    500, l_max 16, 4 windows, dense).  Case C: 500 finite draws of the
    fitted family (600 steps, n_mc 8), the mean age within 0.15."""
    res = sc.run_case(case, "cpu")
    misses = [c for c in res["criteria"] if not c["ok"]]
    assert not misses, (misses, res["posterior"])
