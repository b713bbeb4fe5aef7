"""Collectives over a mesh axis, and the gradient rule of the star-axis sum.

`psum`, `pmean`, `pmax` and `all_gather` take a process group, base_tpu's
`axis_name`; with the group None they return x itself, so the samplers
keep one code path for sharded and unsharded runs.  Otherwise they return
new tensors and leave their input as it was.

Where a collective runs: an NCCL group takes the tensor on the rank's
card; a gloo group takes it on the host.  A CUDA tensor given to a gloo
group (ranks that share a card) is copied to the host for the collective
and back, by that rule and nowhere else, and each such collective adds
one to `staged`.  The density's own work stays on the card.

The star-axis sum and its gradient.  Every rank's autograd sees only its
own graph, so a forward all-reduce alone would give every rank the full
log likelihood but only its local stars' gradient; an all-reduce whose
backward all-reduces again (torch.distributed.nn) would give every rank
S times it.  The pair below, in the manner of Megatron's copy / reduce
regions, gives every rank sum_r grad ll_r + grad prior:

  enter(params, group)   forward identity, backward all-reduce SUM;
                         applied to the parameters where they enter the
                         likelihood;
  reduce_sum(ll, group)  forward all-reduce SUM, backward identity;
                         applied to the local log-likelihood sum.

The prior and the log-Jacobian stay outside both, so their gradient
counts once.  On a group of one `enter` makes no autograd node (its
all-reduce would be a copy), so the gradient keeps the summation order of
the unsharded density.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

staged = 0   # collectives a gloo group ran through the host for CUDA data


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of x where the group's backend takes it."""
    global staged
    if dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
        return x.detach().to(dev, copy=True).contiguous()
    if x.is_cuda:
        staged += 1
    return x.detach().to("cpu", copy=True).contiguous()


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return x
    w = _wire(x, group)
    dist.all_reduce(w, op=op, group=group)
    return w.to(x.device)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    return psum(x, group) / size(group)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order
    (every rank's x has the same shape)."""
    if group is None:
        return x
    w = _wire(x, group)
    parts = [torch.empty_like(w) for _ in range(size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def barrier() -> None:
    """Every rank of the world has reached here."""
    psum(torch.zeros(1), dist.group.WORLD)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Forward identity, backward all-reduce SUM over the group."""
    if size(group) == 1:
        return x
    return _Enter.apply(x, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Forward all-reduce SUM over the group, backward identity."""
    if group is None:
        return x
    return _ReduceSum.apply(x, group)
