"""The port's NUTS (base_tpu_torch.inference.nuts): the U-turn criterion and
the leapfrog leaf against base_tpu's on identical float32 inputs, the
checkpoint stack against a brute-force check of every complete balanced
subtree, and `group` over a world of one.  The moment tests, the chunked
runner and the lockstep are in tests/test_torch_nuts_runs.py (a file
holds at most 8 Tier-1 tests: pytest-xdist's loadfile hands out files
with more tests ahead of the JAX long pole, tests/test_cli_mesh.py);
chain_chunk's blocks in tests/test_torch_longaxis.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from base_tpu.inference import nuts as jnuts
from base_tpu_torch.inference import nuts
from base_tpu_torch.inference.hmc import _mass_matvec

torch.set_num_threads(1)

COV = np.array([[1.0, 0.9], [0.9, 1.0]], np.float32)
MEAN = np.array([0.5, -1.5], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def gauss_lp(z):
    d = z - torch.from_numpy(MEAN)
    return -0.5 * ((d @ torch.from_numpy(PREC)) * d).sum(-1)


def _metric(kind, P, rng):
    if kind == "diag":
        return rng.uniform(0.5, 2.0, P).astype(np.float32)
    a = rng.normal(size=(P, P)).astype(np.float32)
    return (a @ a.T + 0.5 * np.eye(P)).astype(np.float32)


def _init(seed, shape, scale=1.0):
    return scale * torch.randn(shape,
                               generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_uturn_and_leapfrog_match_jax(kind):
    """_uturn and _leapfrog_one on 16 chains (P = 3, a mask pinning one
    dim, both directions) equal base_tpu's vmapped ones: the U-turn flags
    exactly, the leaf's position, momentum, gradient and log density to
    1e-6 (relative, atol 1e-6)."""
    rng = np.random.default_rng(0 if kind == "diag" else 1)
    C, P = 16, 3
    inv_mass = _metric(kind, P, rng)
    prec = rng.normal(size=(P, P)).astype(np.float32)
    prec = (prec @ prec.T + np.eye(P)).astype(np.float32)
    z, p, z2, p2 = (rng.normal(size=(C, P)).astype(np.float32)
                    for _ in range(4))
    eps = rng.uniform(0.05, 0.5, C).astype(np.float32)
    direction = np.where(rng.random(C) < 0.5, 1.0, -1.0).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)

    want = jax.vmap(lambda a, b, c, d: jnuts._uturn(
        a, b, c, d, jnp.asarray(inv_mass)))(z, p, z2, p2)
    got = nuts._uturn(*map(torch.from_numpy, (z, p, z2, p2)),
                      torch.from_numpy(inv_mass))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < C

    def jlp(x):
        return -0.5 * x @ jnp.asarray(prec) @ x

    def tlp(x):
        return -0.5 * ((x @ torch.from_numpy(prec)) * x).sum(-1)

    jvg = jax.value_and_grad(jlp)
    lp0, g0 = jax.vmap(jvg)(jnp.asarray(z))
    jpt = jnuts._Point(z=jnp.asarray(z), p=jnp.asarray(p), grad=g0, lp=lp0)
    want = jax.vmap(lambda pt, e, d: jnuts._leapfrog_one(
        jvg, pt, e, jnp.asarray(inv_mass), d, mask=jnp.asarray(mask)))(
        jpt, jnp.asarray(eps), jnp.asarray(direction))
    vg = nuts.value_and_grad(tlp)
    tpt = nuts._Point(*(torch.from_numpy(np.asarray(v)) for v in jpt))
    got = nuts._leapfrog_one(vg, tpt, torch.from_numpy(eps),
                             torch.from_numpy(inv_mass),
                             torch.from_numpy(direction),
                             mask=torch.from_numpy(mask))
    for name, w, g in zip(nuts._Point._fields, want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def _blocks(lo, hi):
    """Every complete balanced subtree (lo, hi) of leaves lo..hi with at
    least two leaves, by recursion."""
    if hi == lo:
        return []
    mid = (lo + hi) // 2
    return [(lo, hi)] + _blocks(lo, mid) + _blocks(mid + 1, hi)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
def test_checkpoint_stack_matches_brute_force(depth):
    """Along leapfrog trajectories of 2^depth leaves on a Gaussian (8
    chains, both directions, a dense metric), the checkpoint stack flags
    at leaf s exactly the chains for which a complete balanced subtree
    ending at s makes a U-turn (its endpoints ordered along the direction,
    base_tpu's _uturn), found by brute force over every such subtree."""
    rng = np.random.default_rng(depth)
    C, P, D, n = 8, 2, 6, 2 ** depth
    inv_mass = torch.from_numpy(_metric("dense", P, rng))
    direction = torch.from_numpy(
        np.where(np.arange(C) % 2 == 0, 1.0, -1.0).astype(np.float32))
    vg = nuts.value_and_grad(gauss_lp)
    z = torch.from_numpy(rng.normal(size=(C, P)).astype(np.float32))
    lp, g = vg(z)
    pt = nuts._Point(z, torch.from_numpy(
        rng.normal(size=(C, P)).astype(np.float32)), g, lp)
    eps = torch.full((C,), 0.6)
    traj = []
    for _ in range(n):
        pt = nuts._leapfrog_one(vg, pt, eps, inv_mass, direction)
        traj.append(pt)

    ck_z, ck_v = torch.zeros(C, D, P), torch.zeros(C, D, P)
    got = torch.stack([nuts._checkpoint_turn(
        s, ck_z, ck_v, q.z, _mass_matvec(inv_mass, q.p), direction)
        for s, q in enumerate(traj)], 1)                         # [C, n]

    want = np.zeros((C, n), bool)
    im = jnp.asarray(inv_mass.numpy())
    for c in range(C):
        for lo, hi in _blocks(0, n - 1):
            a, b = traj[lo], traj[hi]
            if direction[c] < 0:
                a, b = b, a
            want[c, hi] |= bool(jnuts._uturn(
                jnp.asarray(a.z[c].numpy()), jnp.asarray(a.p[c].numpy()),
                jnp.asarray(b.z[c].numpy()), jnp.asarray(b.p[c].numpy()),
                im))
    np.testing.assert_array_equal(got.numpy(), want)
    if depth >= 3:
        assert want.any() and not want.all()


def test_axis_name_not_supported():
    """base_tpu's axis_name is the port's `group` (a chain process group):
    run_nuts over the group of a world of one equals run_nuts without a
    group, bit for bit (base_tpu_torch.parallel runs the wider worlds)."""
    import torch.distributed as dist

    from base_tpu_torch.parallel import distributed

    cfg = nuts.NUTSConfig(n_warmup=8, n_samples=4, max_depth=3, n_windows=2,
                          dense_mass=True)
    want, wi = nuts.run_nuts(gauss_lp, _init(1, (4, 2)),
                             torch.Generator().manual_seed(0), cfg)
    with distributed.world_of_one("cpu"):
        got, gi = nuts.run_nuts(gauss_lp, _init(1, (4, 2)),
                                torch.Generator().manual_seed(0), cfg,
                                group=dist.group.WORLD)
    assert torch.equal(got, want)
    for key in ("step_size", "inv_mass", "logposts", "accept_prob"):
        assert torch.equal(gi[key], wi[key]), key
