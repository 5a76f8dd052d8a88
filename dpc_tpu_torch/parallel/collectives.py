"""Collectives over a process group, with the gradients ``dpc_tpu``'s
``shard_map`` bodies get from JAX's transposes.

Made of ``all_reduce``, ``all_gather`` and ``broadcast`` alone, which
NCCL and gloo both take for CUDA tensors (gloo has no CUDA
``reduce_scatter``; the two ranks that share one card run gloo).  A group
of None is an axis of size 1: every function returns its input and calls
nothing.

  * ``all_gather(x, group)``: the group's tensors concatenated along dim
    0; its backward is JAX's transpose, the psum-scatter: the sum of
    every rank's cotangent, then this rank's slice.  Every rank that
    computes the same loss from the gathered tensor sends its own
    cotangent back, so each rank's gradient carries one copy a rank (the
    m-factor that the train step's mean over the model group removes,
    ``dpc_tpu/train/pretrain_step.py:205-214``).
  * ``psum(x, group)`` / ``pmean``: the sum (mean) over the group; the
    backward of ``psum`` is ``psum``, as in ``shard_map``.
  * ``gather_max(x, group)``: the elementwise max over the group, outside
    autograd (``pmax`` has no derivative in JAX; the sharded logsumexp
    uses it as a shift that cancels).
  * ``gather(x, group, dim)``, ``sum_(x, group)``, ``mean_(x, group)``,
    ``mean_flat_(tensors, group)``, ``broadcast_(tensors, group)``:
    outside autograd, for metrics, gradients, running statistics and the
    parameters a run starts from.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return _sum(g, ctx.group)[i * ctx.n:(i + 1) * ctx.n], None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[n·B, ...]`` from every rank's ``[B, ...]``, in group-rank order
    (``jax.lax.all_gather(x, axis, axis=0, tiled=True)``)."""
    return x if group is None else _AllGather.apply(x, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Psum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else psum(x, group) / size(group)


def gather_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group, detached."""
    x = x.detach()
    if group is None:
        return x
    return _gather(x[None], group).amax(dim=0)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim``, detached."""
    x = x.detach()
    return x if group is None else _gather(x, group, dim)


@torch.no_grad()
def sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` replaced by its sum over the group, in place."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


@torch.no_grad()
def mean_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` replaced by its mean over the group, in place."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        x.div_(size(group))
    return x


@torch.no_grad()
def mean_flat_(tensors, group) -> None:
    """Every tensor replaced by its mean over the group, in place, in one
    all-reduce of one flat f32 buffer (the steps' gradients, metrics and
    running statistics)."""
    if group is None:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    mean_(flat, group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def broadcast_(tensors, group) -> None:
    """Every tensor replaced by group rank 0's, in place."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)
