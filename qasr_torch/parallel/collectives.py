"""Collectives across ranks (counterpart of ``qasr/parallel/collectives.py``):
counters summed across processes, and the differentiable collectives the
sharded steps and the sequence-parallel ops are built from.

Every collective here is ``all_reduce``, ``broadcast`` or ``all_gather``,
the three that NCCL, gloo on the CPU and gloo on CUDA tensors all run (gloo
has no CUDA ``send``/``recv``), so ranks that share one card (gloo) run the
same code as ranks that own one each (NCCL).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from qasr_torch.parallel.mesh import world


def collective_device() -> torch.device:
    """Where a host counter goes for a collective: the current card under
    NCCL (which takes CUDA tensors only), else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allsum_across_hosts(values: np.ndarray) -> np.ndarray:
    """Sum an array of host counters across every process of the world.

    One process: the identity."""
    _, size = world()
    if size == 1:
        return np.asarray(values)
    t = torch.as_tensor(np.asarray(values)).to(collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def aggregate_per(errs: int, total: int) -> tuple[int, int]:
    out = allsum_across_hosts(np.array([errs, total], np.int64))
    return int(out[0]), int(out[1])


def gather_list(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x`` of ``group``, in rank order (not differentiable)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def all_gather_cat(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in rank order
    (not differentiable)."""
    return torch.cat(gather_list(x, group), dim=dim)


class AllSum(torch.autograd.Function):
    """Sum of ``x`` over ``group``, an output every rank holds. Backward: the
    identity, since each rank's cotangent of the shared output is the same
    logical one (it must not be summed again)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class Broadcast(torch.autograd.Function):
    """``x`` of the rank ``src`` (a global rank of ``group``) on every rank.
    Backward: the cotangents of all ranks summed onto ``src``; the others'
    ``x`` get zero."""

    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        if dist.get_rank() != ctx.src:
            g = torch.zeros_like(g)
        return g, None, None
