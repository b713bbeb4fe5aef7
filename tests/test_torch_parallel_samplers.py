"""The port's sharded samplers on the CPU: (d) sharded HMC, MH (with and
without a burn-in model), NUTS, SMC and VI with tests/test_parallel.py's
checks, (e) the star shards of a chain block drawing bit for bit alike,
and (g) a sharded checkpointed run interrupted and resumed, at mesh
(2, 2) in one spawned world of 4 gloo ranks (tests/test_torch_parallel.py
holds the models, the worker and the world; see its docstring)."""
import numpy as np
import pytest
import torch

from test_torch_parallel import (N_CHAINS, RESUME_HMC, TRUTH, VI_CFG,
                                 _port_model, spawn_world)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(small_grid, tmp_path_factory):
    return spawn_world(small_grid, tmp_path_factory, "samplers")


def test_hmc_sharded_chains_move_and_recover(world):
    """(d) test_parallel.py's sharded HMC checks at mesh (2, 2): every
    chain moves, the step size is sane, the recorded logposts are the
    density at the recorded draws, the acceptance and the age are right;
    and the star shards of a block made the same density calls."""
    from base_tpu_torch.inference import diagnostics as diag
    from base_tpu_torch.model import posterior as post

    _, inp, ranks = world
    h = ranks[0]["hmc"]
    z = h["zs"]
    assert z.shape == (50, N_CHAINS, 9)
    assert (np.ptp(z.numpy(), axis=0).max(axis=-1) > 1e-4).all()
    assert float(h["step_size"]) > 1e-6
    assert float(h["accept"]) > 0.3
    model = _port_model(inp)
    tr = post.default_transform(model)
    with torch.no_grad():
        lp = post.make_logpost_z_fn(model, tr)(z.reshape(-1, 9))
    np.testing.assert_allclose(h["logposts"].numpy(),
                               lp.reshape(50, N_CHAINS).numpy(),
                               atol=0.5, rtol=1e-4)
    xs = tr.forward(z)
    assert abs(float(xs[..., 0].mean()) - TRUTH[0]) < 0.1
    assert torch.isfinite(diag.split_rhat(xs[..., :5])).all()
    calls = [r["hmc"]["calls"] for r in ranks]
    assert calls[0] == calls[1] and calls[2] == calls[3] and calls[0] > 0


def test_mh_sharded_runs_and_recovers(world):
    """(d) test_parallel.py's sharded MH."""
    s = world[2][0]["mh"]
    xs = s["xs"].numpy()
    assert xs.shape == (200, N_CHAINS, 9)
    assert np.isfinite(s["logposts"].numpy()).all()
    assert np.std(xs[-1, :, 0]) > 0
    assert abs(xs[100:, :, 0].mean() - TRUTH[0]) < 0.1
    assert 0.0 < float(s["accept"]) < 1.0


def test_mh_sharded_burn_model(world):
    """(d) useDuringBurnIn under a mesh: stages 1-2 on a 30-star subset
    model sharded over the same star axis."""
    x = world[2][0]["mh_burn"]["xs"].numpy()
    assert x.shape[1] == N_CHAINS
    assert np.isfinite(x).all()
    assert x[:, :, 0].std() > 0
    assert abs(x[:, :, 0].mean() - TRUTH[0]) < 0.15


def test_nuts_sharded_runs_and_recovers(world):
    """(d) test_parallel.py's sharded NUTS."""
    from base_tpu_torch.model import posterior as post

    _, inp, ranks = world
    n = ranks[0]["nuts"]
    assert n["zs"].shape == (30, N_CHAINS, 9)
    assert float(n["accept"]) > 0.3
    assert float(n["mean_leapfrogs"]) > 1.0
    xs = post.default_transform(_port_model(inp)).forward(n["zs"])
    assert abs(float(xs[..., 0].mean()) - TRUTH[0]) < 0.1


def test_smc_sharded_cluster(world):
    """(d) test_parallel.py's sharded SMC: 128 particles on each of 2
    chain shards, stars summed inside the tempered density; and two
    replicates folded on each chain shard."""
    from base_tpu_torch.model import posterior as post

    _, inp, ranks = world
    s = ranks[0]["smc"]
    assert s["particles"].shape == (256, 9)
    assert float(s["beta"]) == 1.0
    xs = post.default_transform(_port_model(inp)).forward(s["particles"])
    assert torch.isfinite(xs).all()
    assert abs(float(xs[:, 0].mean()) - TRUTH[0]) < 0.1
    assert np.isfinite(float(s["log_evidence"]))
    # Two replicates folded on each chain shard (32 particles of each):
    # both reach beta = 1, with an evidence per replicate and its SE.
    r = ranks[0]["smc_rep"]
    assert r["particles"].shape == (2 * 64, 9)
    assert r["betas"].shape == (2, 16) and float(r["beta"]) == 1.0
    assert r["log_evidences"].shape == (2,)
    assert np.isfinite(float(r["log_evidence_se"]))


def test_vi_sharded_matches_single_process(world):
    """(d) test_parallel.py's sharded VI against the port's VI in one
    process: the pooled ELBO no worse, the means within 6 sd, and the
    warm start a usable dense metric with the pinned dims at z0."""
    from base_tpu_torch.inference import vi
    from base_tpu_torch.model import posterior as post

    _, inp, ranks = world
    model = _port_model(inp)
    tr = post.default_transform(model)
    z0 = tr.inverse(torch.from_numpy(TRUTH))
    one = vi.run_vi(post.make_logpost_z_fn(model, tr), z0,
                    torch.Generator().manual_seed(31), VI_CFG)
    v = ranks[0]["vi"]
    assert np.isfinite(float(v["final_elbo"]))
    assert float(v["final_elbo"]) > float(one.final_elbo) - 3.0
    sd = np.sqrt(np.maximum(np.diag(vi.posterior_covariance(one).numpy()),
                            1e-12))
    free = np.asarray(post.free_mask(model)) > 0
    dmu = np.abs(v["mu"].numpy() - one.mu.numpy())
    assert (dmu[free] < 6 * sd[free]).all(), (dmu, sd)
    assert v["draws"].shape == (N_CHAINS, 9) and v["cov"].shape == (9, 9)
    assert (np.linalg.eigvalsh(v["cov"].numpy()) > 0).all()
    assert torch.equal(v["draws"][:, ~free],
                       z0[None, ~free].expand(N_CHAINS, -1))


def test_star_shards_draw_identically(world):
    """(e) Ranks 0 and 1 are the two star shards of chain block 0 (ranks
    2 and 3 of block 1); after the chain-group gather each holds its star
    index's copy of every chain: the copies agree bit for bit."""
    ranks = world[2]
    for a, b in ((0, 1), (2, 3), (0, 2)):
        ra, rb = ranks[a], ranks[b]
        assert torch.equal(ra["hmc"]["zs"], rb["hmc"]["zs"])
        assert torch.equal(ra["hmc"]["logposts"], rb["hmc"]["logposts"])
        assert torch.equal(ra["nuts"]["zs"], rb["nuts"]["zs"])
        assert torch.equal(ra["mh"]["xs"], rb["mh"]["xs"])
        assert torch.equal(ra["smc"]["particles"], rb["smc"]["particles"])
        assert torch.equal(ra["vi"]["mu"], rb["vi"]["mu"])


def test_sharded_checkpoint_resume_bit_identical(world):
    """(g) At mesh (2, 2), a checkpointed run interrupted after chunk 1
    (rank 0 wrote the whole run) and resumed on every rank equals an
    uninterrupted run bit for bit, on every rank."""
    for r in world[2]:
        (zs, lps, eps, im), (zs2, lps2, eps2, im2) = r["resume"]
        assert zs.shape == (RESUME_HMC["n_samples"], N_CHAINS, 9)
        assert torch.equal(zs, zs2) and torch.equal(lps, lps2)
        assert torch.equal(eps, eps2) and torch.equal(im, im2)
