"""(h) tests/test_longaxis.py's recipe through the port's parallel layer
on the CPU: the sharded VI warm start into run_hmc_sharded with inv_mass0
and chain_chunk, at mesh (2, 2) in one spawned world of 4 gloo ranks
(tests/test_torch_parallel.py holds the models, the worker and the world;
see its docstring)."""
import numpy as np
import pytest
import torch

from test_torch_parallel import (LONGAXIS_HMC, N_CHAINS, TRUTH, _port_model,
                                 spawn_world)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(small_grid, tmp_path_factory):
    return spawn_world(small_grid, tmp_path_factory, "longaxis")


def test_longaxis_vi_into_chunked_sharded_hmc(world):
    """(h) The long-axis recipe at mesh (2, 2): every density call of a
    rank holds one block of chain_chunk of its 4 chains, and the calls
    are the run's evaluations (the start, then l_max a transition) times
    the blocks; the chains start at the VI draws (pinned dims at z0),
    move, accept and recover the age; the star shards of a chain block
    and the chain group's gathers agree bit for bit.  (Chunked against
    unchunked runs: tests/test_torch_hmc.py.  On this CPU the gradient of
    this model at 2 rows rounds a few ulp apart from its gradient at 4,
    which HMC's trajectories amplify.)"""
    from base_tpu_torch.inference import hmc
    from base_tpu_torch.model import posterior as post

    _, inp, ranks = world
    h = LONGAXIS_HMC
    local = N_CHAINS // 2
    blocks = local // h["chain_chunk"]
    evals = 1 + (h["n_warmup"] + h["n_samples"]) * h["l_max"]
    assert blocks == hmc.chain_blocks(local, h["chain_chunk"]) == 2
    for r in ranks:
        a = r["longaxis"]
        assert a["calls"] == evals * blocks
        assert a["rows"] == evals * local
    model = _port_model(inp)
    tr = post.default_transform(model)
    free = np.asarray(post.free_mask(model)) > 0
    z0 = tr.inverse(torch.from_numpy(TRUTH))
    a = ranks[0]["longaxis"]
    assert torch.equal(a["draws"][:, ~free],
                       z0[None, ~free].expand(N_CHAINS, -1))
    z = a["zs"]
    assert z.shape == (h["n_samples"], N_CHAINS, 9)
    assert torch.isfinite(z).all()
    assert (np.ptp(z.numpy(), axis=0)[:, free].min(axis=-1) > 1e-5).all()
    assert float(a["accept"]) > 0.5
    xs = tr.forward(z)
    assert abs(float(xs[..., 0].mean()) - TRUTH[0]) < 0.1
    for i, j in ((0, 1), (2, 3), (0, 2)):
        assert torch.equal(ranks[i]["longaxis"]["zs"],
                           ranks[j]["longaxis"]["zs"])
