"""The (chains x stars) mesh of ranks (port of base_tpu.parallel.mesh).

base_tpu lays the devices out as a 2-D `jax.sharding.Mesh`:

  axis "chains" — data-parallel: independent MCMC chains / SMC particle
                  blocks;
  axis "stars"  — the long reduction: the per-star log-likelihood sum is
                  sharded, so no device holds all stars' workspace.

Here every mesh position is one rank of the world, in base_tpu's
`reshape(n_chain_shards, n_star_shards)` order: rank = ci * n_star_shards
+ si.  The star group of a rank holds the ranks of its chain block (same
ci, si = 0..S-1); its chain group holds the ranks at its star index (same
si, ci = 0..C-1), in chain-block order.  The likelihood's partial sums
ride the star group; mass-matrix, step-size and particle pooling, and the
assembly of outputs, ride the chain group (parallel.comm).  A 1 x 1 mesh
(a world of one) is legal and is what one card runs.

Random streams: base_tpu gives chain shard ci the key `fold_in(key, ci)`,
the same on every star shard of the block, so that their proposals and
accepts stay in lockstep.  Here `Mesh.chain_generator(gen)` draws one
62-bit integer k from `gen` (the same draw on every rank, whose `gen`
states are equal) and seeds chain shard ci's generator, on gen's device,
with (k + ci * 0x9E3779B97F4A7C15) mod 2**64.
"""
from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from base_tpu_torch.parallel import comm
from base_tpu_torch.parallel import distributed

CHAIN_AXIS = "chains"
STAR_AXIS = "stars"

_GOLDEN = 0x9E3779B97F4A7C15


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_chain_shards: int
    n_star_shards: int
    rank: int
    ci: int                  # this rank's chain block
    si: int                  # this rank's star shard
    chain_group: object      # ranks (0..C-1, si)
    star_group: object       # ranks (ci, 0..S-1)
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        return {CHAIN_AXIS: self.n_chain_shards, STAR_AXIS: self.n_star_shards}

    def chain_block(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of a chain-axis tensor (the axis must divide
        evenly over the chain shards)."""
        n = x.shape[dim]
        if n % self.n_chain_shards:
            raise ValueError(f"{n} chains do not split over "
                             f"{self.n_chain_shards} chain shards")
        k = n // self.n_chain_shards
        return x.narrow(dim, self.ci * k, k)

    def gather_chains(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every chain block's x, concatenated along `dim`."""
        return comm.all_gather(x, self.chain_group, dim)

    def chain_generator(self, gen: torch.Generator) -> torch.Generator:
        """Chain shard ci's generator (module docstring)."""
        k = int(torch.randint(0, 2**62, (1,), generator=gen,
                              device=gen.device))
        seed = (k + self.ci * _GOLDEN) % 2**64
        return torch.Generator(device=gen.device).manual_seed(seed)

    def describe(self) -> str:
        return (f"mesh {self.n_chain_shards}x{self.n_star_shards} rank "
                f"{self.rank} (chain block {self.ci}, star shard {self.si}) "
                f"backend {self.backend} on {self.device}")


def make_mesh(n_chain_shards: int | None = None,
              n_star_shards: int = 1) -> Mesh:
    """The (chains x stars) mesh over the initialised world; every rank
    must call it (creating groups is collective).  n_chain_shards
    defaults to world / n_star_shards."""
    if not distributed.is_initialized():
        raise RuntimeError("make_mesh: join the world first "
                           "(parallel.distributed.initialize)")
    n = dist.get_world_size()
    if n_chain_shards is None:
        if n % n_star_shards:
            raise ValueError(f"{n} ranks not divisible by {n_star_shards}")
        n_chain_shards = n // n_star_shards
    if n_chain_shards * n_star_shards != n:
        raise ValueError(f"mesh {n_chain_shards}x{n_star_shards} != {n} "
                         f"ranks")
    rank = dist.get_rank()
    ci, si = divmod(rank, n_star_shards)
    timeout = datetime.timedelta(seconds=distributed.timeout_s())
    chain_group = star_group = None
    for c in range(n_chain_shards):
        g = dist.new_group([c * n_star_shards + s
                            for s in range(n_star_shards)], timeout=timeout)
        if c == ci:
            star_group = g
    for s in range(n_star_shards):
        g = dist.new_group([c * n_star_shards + s
                            for c in range(n_chain_shards)], timeout=timeout)
        if s == si:
            chain_group = g
    info = distributed.process_info()
    return Mesh(n_chain_shards, n_star_shards, rank, ci, si, chain_group,
                star_group, distributed.device(), info["backend"])


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k
