"""The host-chunked HMC driver, with save/resume (port of
base_tpu.inference.driver).

Warmup runs window by window, sampling in chunks of recorded draws.  On
the GPU nothing limits how long one piece of work may run; the chunks are
where checkpoints and streaming diagnostics attach.  Given a checkpoint
path, `make_hmc_chunked_runner` saves the full run state atomically after
each chunk: chain states, metric, step size, the preallocated sample
store, the chunk cursor and the generator's state.  A re-launched run
restores it and continues from the cursor; because the generator state
travels with the chains, an interrupted and resumed run is bit-identical
to an uninterrupted one (on a deterministic density: the card's is, run
to run).

Under a mesh (parallel.run) every rank runs its block of chains with its
chain shard's generator, and the checkpoint holds the whole run: every
chain shard's states, samples and generator state, gathered over the
chain group; rank 0 writes it, and every rank restores its own block, so
a resumed sharded run equals an uninterrupted one bit for bit too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from base_tpu_torch.inference import hmc as hmc_mod
from base_tpu_torch.io import checkpoint as ckpt
from base_tpu_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    checkpoint_path: str | None = None
    chunk_size: int = 100        # recorded samples per chunk
    on_window: Callable | None = None   # (chunk_idx, zs, lps) stream hook


def make_hmc_chunked_runner(
    logpost_fn: Callable,
    cfg: hmc_mod.HMCConfig,
    chunk_draws: int = 256,
    *,
    checkpoint_path: str | None = None,
    on_window: Callable | None = None,
    mesh=None,
) -> Callable:
    """Returns `run(init_z, gen, inv_mass0=None) -> (samples [n_rec, C,
    P], info)` like run_hmc, and bit-identical to it under one generator
    seed (the same draws in the same order).

    With `checkpoint_path`, the run state is saved there after every
    chunk, and a run that finds a checkpoint skips warmup and continues
    from its cursor with its generator state.  After each chunk (and its
    checkpoint) `on_window(chunk_idx, zs, lps)` is called with the chunk's
    samples [n, C, P] and log posteriors [n, C].

    When the chunk size does not divide the recorded-draw count, the last
    chunk still runs a full chunk: samples, logposts and accept_prob
    cover exactly the first n_rec draws, but `final_states` and the
    generator sit past run_hmc's terminal position by the over-run.

    With a `mesh` (parallel.mesh.Mesh), logpost_fn is this rank's local
    density, `run` takes the whole init_z [C_total, P] and the run's
    generator, and runs this rank's chain block with
    `mesh.chain_generator(gen)`, pooling the warmup over the chain
    group.  The samples, the window hook's arguments and the outputs are
    gathered over the chain group on every rank; `on_window` must then be
    given on every rank or on none.
    """
    n_rec = cfg.n_samples // cfg.thin
    chunk = max(min(chunk_draws, n_rec), 1)
    n_chunks = -(-n_rec // chunk)

    group = None if mesh is None else mesh.chain_group
    gather = (lambda x, dim: x) if mesh is None else mesh.gather_chains

    def run(init_z: torch.Tensor, gen: torch.Generator,
            inv_mass0: torch.Tensor | None = None):
        if mesh is not None:
            init_z = mesh.chain_block(init_z)
            gen = mesh.chain_generator(gen)
        C, P = init_z.shape

        def store(states, inv_mass, eps):
            n = n_chunks * chunk
            return dict(chain_state=states, inv_mass=inv_mass, eps=eps,
                        samples=init_z.new_zeros(n, C, P),
                        logposts=init_z.new_zeros(n, C),
                        accepts=init_z.new_zeros(n, C), cursor=0,
                        gen_state=gen.get_state())

        if checkpoint_path and ckpt.checkpoint_exists(checkpoint_path):
            c, z = init_z.new_zeros(C), torch.zeros_like(init_z)
            like = store(
                hmc_mod.HMCChainState(z=z, logpost=c, grad=z,
                                      da=hmc_mod.DAState(c, c, c, c, c)),
                hmc_mod.initial_metric(cfg, P, init_z.device),
                init_z.new_zeros(()))
            if mesh is None:
                st = ckpt.restore_checkpoint(checkpoint_path, like)
            else:
                st = _block(ckpt.restore_checkpoint(
                    checkpoint_path, _whole(like, mesh, zeros=True)), mesh)
            gen.set_state(st["gen_state"])
        else:
            st = store(*hmc_mod.warmup(
                logpost_fn, hmc_mod.init_chains(logpost_fn, init_z, cfg),
                cfg, gen, inv_mass0, group))

        for ci in range(st["cursor"], n_chunks):
            states, zs, lps, aps = hmc_mod.sample_chunk(
                logpost_fn, st["chain_state"], st["inv_mass"], st["eps"],
                chunk, cfg, gen)
            rows = slice(ci * chunk, (ci + 1) * chunk)
            zs_t, lps_t = zs.transpose(0, 1), lps.transpose(0, 1)
            st["chain_state"], st["cursor"] = states, ci + 1
            st["samples"][rows] = zs_t
            st["logposts"][rows] = lps_t
            # Per-draw accepts, so that the final mean covers the recorded
            # draws only (an uneven last chunk's over-run does not enter it).
            st["accepts"][rows] = aps.transpose(0, 1)
            if checkpoint_path:
                st["gen_state"] = gen.get_state()
                if mesh is None:
                    ckpt.save_checkpoint(checkpoint_path, st)
                else:
                    whole = _whole(st, mesh)
                    if mesh.rank == 0:
                        ckpt.save_checkpoint(checkpoint_path, whole)
                    comm.barrier()
            if on_window is not None:
                on_window(ci, gather(zs_t, 1), gather(lps_t, 1))

        info = dict(
            accept_prob=gather(st["accepts"][:n_rec], 1).mean(),
            step_size=st["eps"],
            inv_mass=st["inv_mass"],
            logposts=gather(st["logposts"][:n_rec], 1),
            final_states=(st["chain_state"] if mesh is None else _map_state(
                st["chain_state"], lambda x: gather(x, 0))),
        )
        return gather(st["samples"][:n_rec], 1), info

    return run


# The run-state keys laid out along the chain axis, and that axis.
_CHAIN_DIM = {"samples": 1, "logposts": 1, "accepts": 1}


def _map_state(cs, fn):
    """fn applied to every tensor of an HMCChainState."""
    return hmc_mod.HMCChainState(*(fn(x) for x in cs[:3]),
                                 hmc_mod.DAState(*(fn(x) for x in cs.da)))


def _whole(st: dict, mesh, zeros: bool = False) -> dict:
    """The whole run's state from this rank's block: chain-axis tensors
    and the generator states ([n_chain_shards, L]) gathered over the
    chain group, or (zeros) a zero-filled tree of that shape."""
    def full(x, dim):
        if not zeros:
            return mesh.gather_chains(x, dim)
        shape = list(x.shape)
        shape[dim] *= mesh.n_chain_shards
        return x.new_zeros(shape)

    out = dict(st)
    out["chain_state"] = _map_state(st["chain_state"], lambda x: full(x, 0))
    for k, dim in _CHAIN_DIM.items():
        out[k] = full(st[k], dim)
    out["gen_state"] = full(st["gen_state"][None], 0)
    return out


def _block(st: dict, mesh) -> dict:
    """This rank's block of a whole run's state (_whole's inverse)."""
    out = dict(st)
    out["chain_state"] = _map_state(st["chain_state"],
                                    lambda x: mesh.chain_block(x, 0))
    for k, dim in _CHAIN_DIM.items():
        out[k] = mesh.chain_block(st[k], dim)
    out["gen_state"] = st["gen_state"][mesh.ci].clone()
    return out


def run_hmc_checkpointed(
    logpost_fn: Callable,
    init_z: torch.Tensor,   # [C, P]
    gen: torch.Generator,
    cfg: hmc_mod.HMCConfig,
    dcfg: DriverConfig = DriverConfig(),
):
    """make_hmc_chunked_runner with dcfg's chunk size, checkpoint and
    window hook: saved after every chunk, resumed when the checkpoint
    exists.  Returns (samples [n_rec, C, P], info) like run_hmc."""
    return make_hmc_chunked_runner(
        logpost_fn, cfg, dcfg.chunk_size,
        checkpoint_path=dcfg.checkpoint_path, on_window=dcfg.on_window,
    )(init_z, gen)
