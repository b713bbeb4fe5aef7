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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from base_tpu_torch.inference import hmc as hmc_mod
from base_tpu_torch.io import checkpoint as ckpt


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
    """
    n_rec = cfg.n_samples // cfg.thin
    chunk = max(min(chunk_draws, n_rec), 1)
    n_chunks = -(-n_rec // chunk)

    def run(init_z: torch.Tensor, gen: torch.Generator,
            inv_mass0: torch.Tensor | None = None):
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
            st = ckpt.restore_checkpoint(checkpoint_path, like)
            gen.set_state(st["gen_state"])
        else:
            st = store(*hmc_mod.warmup(
                logpost_fn, hmc_mod.init_chains(logpost_fn, init_z, cfg),
                cfg, gen, inv_mass0))

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
                ckpt.save_checkpoint(checkpoint_path, st)
            if on_window is not None:
                on_window(ci, zs_t, lps_t)

        info = dict(
            accept_prob=st["accepts"][:n_rec].mean(),
            step_size=st["eps"],
            inv_mass=st["inv_mass"],
            logposts=st["logposts"][:n_rec],
            final_states=st["chain_state"],
        )
        return st["samples"][:n_rec], info

    return run


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
