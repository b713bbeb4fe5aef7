"""Process groups for the parallel layer (port of
base_tpu.parallel.distributed).

base_tpu runs one process over a mesh of devices (`jax.distributed` wires
the hosts, `shard_map` places the work).  Here every mesh position is one
process, a rank of a `torch.distributed` world, and the mesh's axes are
process groups (parallel.mesh).  `initialize` joins the world, from the
environment that `torchrun` sets (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or from explicit arguments:

    from base_tpu_torch.parallel import distributed, mesh
    dev = distributed.initialize("cuda")      # under torchrun
    m = mesh.make_mesh(n_chain_shards=2, n_star_shards=2)

Backend rule (`backend_for`): NCCL when the rank's device is CUDA and
every rank of the host has a card of its own (the rank takes card
LOCAL_RANK); gloo on the CPU, and gloo when several ranks share a card
(NCCL refuses two ranks on one device; those ranks take card
LOCAL_RANK % device_count).  The rule is applied once, here; nothing
swaps backend or device on a failure.  Every group gets a finite timeout,
so a rank left waiting for a collective that another rank never makes
fails instead of hanging.

Checkpoint/resume across ranks: rank 0 writes the whole run's state and
every rank restores its block (inference.driver); after a failure,
restart every rank and resume.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0

_state: dict = {}


def backend_for(device: torch.device, local_world_size: int) -> str:
    """The backend rule (module docstring)."""
    if device.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _env_int(name: str, default: int | None = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(f"{name} is not set: pass it to initialize() "
                               f"or start the ranks with torchrun")
        return default
    return int(value)


def initialize(
    device: str | torch.device = "cuda",
    *,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    local_rank: int | None = None,
    local_world_size: int | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the world and return this rank's device.

    Arguments left None come from the environment (torchrun's variables;
    `init_method` "env://").  `device` is the device type ("cuda" or
    "cpu"); a CUDA rank is pinned to its card by `torch.cuda.set_device`.
    Every rank runs its host work on one thread."""
    dev = torch.device(device)
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", rank)
    if local_world_size is None:
        local_world_size = _env_int("LOCAL_WORLD_SIZE", world_size)
    backend = backend_for(dev, local_world_size)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: torch.cuda.is_available() is "
                               "false")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(backend=backend, device=dev, local_rank=local_rank,
                  local_world_size=local_world_size, timeout_s=timeout_s)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_info() -> dict:
    """This rank's place in the world, its backend and its device."""
    if not is_initialized():
        return dict(rank=0, world_size=1, backend=None, device=None,
                    local_rank=0, local_world_size=1)
    return dict(rank=dist.get_rank(), world_size=dist.get_world_size(),
                backend=_state["backend"], device=str(_state["device"]),
                local_rank=_state["local_rank"],
                local_world_size=_state["local_world_size"])


def device() -> torch.device:
    """The device `initialize` gave this rank."""
    return _state["device"]


def timeout_s() -> float:
    return _state.get("timeout_s", DEFAULT_TIMEOUT_S)


@contextlib.contextmanager
def world_of_one(device: str | torch.device = "cuda",
                 timeout_s: float = DEFAULT_TIMEOUT_S):
    """A world of one rank in this process (a file store in a fresh
    temporary directory), left on exit; yields the rank's device.  What a
    1 x 1 mesh runs in without torchrun.  The host thread count is
    restored on exit."""
    store = tempfile.mkdtemp(prefix="btt_world_")
    threads = torch.get_num_threads()
    try:
        dev = initialize(device, init_method=f"file://{store}/store",
                         world_size=1, rank=0, local_rank=0,
                         local_world_size=1, timeout_s=timeout_s)
        yield dev
    finally:
        shutdown()
        torch.set_num_threads(threads)
        shutil.rmtree(store, ignore_errors=True)


def shutdown() -> None:
    """Leave the world (destroys every group)."""
    if is_initialized():
        dist.destroy_process_group()
    _state.clear()
