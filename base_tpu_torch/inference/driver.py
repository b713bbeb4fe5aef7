"""Host-chunked HMC runner (port of make_hmc_chunked_runner in
base_tpu.inference.driver).

Warmup runs window by window, sampling in chunks of recorded draws.  On
the GPU nothing limits how long one piece of work may run; the chunks are
where checkpoints and streaming diagnostics will attach.
"""
from __future__ import annotations

from typing import Callable

import torch

from base_tpu_torch.inference import hmc as hmc_mod


def make_hmc_chunked_runner(
    logpost_fn: Callable,
    cfg: hmc_mod.HMCConfig,
    chunk_draws: int = 256,
) -> Callable:
    """Returns `run(init_z, gen, n_samples=None, inv_mass0=None) ->
    (samples [n_rec, C, P], info)` like run_hmc, and bit-identical to it
    under one generator seed (the same draws in the same order).

    When the chunk size does not divide the recorded-draw count, the last
    chunk still runs a full chunk: samples, logposts and accept_prob
    cover exactly the first n_rec draws, but `final_states` and the
    generator sit past run_hmc's terminal position by the over-run.
    """
    window_fn = hmc_mod.make_warmup_window(logpost_fn, cfg)
    chunk = max(min(chunk_draws, cfg.n_samples // cfg.thin), 1)

    def run(init_z: torch.Tensor, gen: torch.Generator,
            n_samples: int | None = None,
            inv_mass0: torch.Tensor | None = None):
        P = init_z.shape[-1]
        inv_mass = (hmc_mod.initial_metric(cfg, P, init_z.device)
                    if inv_mass0 is None else inv_mass0)
        states = hmc_mod.init_chains(logpost_fn, init_z, cfg)
        for w in range(cfg.n_windows):
            states, inv_mass = window_fn(states, inv_mass, w, gen)
        eps = hmc_mod.freeze_step_size(states)

        n_rec = (cfg.n_samples if n_samples is None else n_samples) // cfg.thin
        n_chunks = (n_rec + chunk - 1) // chunk
        zs_all, lps_all, aps_all = [], [], []
        for _ in range(n_chunks):
            states, zs, lps, aps = hmc_mod.sample_chunk(
                logpost_fn, states, inv_mass, eps, chunk, cfg, gen)
            zs_all.append(zs.transpose(0, 1))
            lps_all.append(lps.transpose(0, 1))
            aps_all.append(aps.transpose(0, 1))          # [n, C]
        info = dict(
            # Weighted by recorded draws: over-run draws of an uneven last
            # chunk do not enter the acceptance statistic.
            accept_prob=torch.cat(aps_all)[:n_rec].mean(),
            step_size=eps,
            inv_mass=inv_mass,
            logposts=torch.cat(lps_all)[:n_rec],
            final_states=states,
        )
        return torch.cat(zs_all)[:n_rec], info

    return run
