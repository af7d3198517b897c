"""Differentiable collectives over a process group.

Two collectives that both gloo and NCCL take on CUDA tensors (and gloo on
CPU tensors), so one code path runs on every backend: ``all_reduce`` (sum)
and ``all_gather`` (the list form); ``broadcast`` makes the replicas equal
(``sharded.Parallel``). Each autograd function states its backward:

- :func:`all_reduce`: the sum on every rank; backward the sum of the
  ranks' gradients (every rank's loss reads the sum).
- :func:`copy_to_group`: identity; backward the sum of the ranks'
  gradients. It stands before a layer whose ranks each compute a slice of
  the output channels from the whole input (tensor parallelism).
- :func:`gather_slices`: each rank's slice concatenated along ``dim``;
  backward the rank's own slice of the gradient. Every rank's consumer then
  computes the same function of the same whole, so each holds the whole
  gradient already.
- :func:`gather_shards`: the same forward; backward the sum over the ranks
  of the gradient, the rank's slice of it. The ranks' consumers differ (a
  ZeRO shard gathered for a forward over each rank's own batch), so the
  gradient of a shard is summed across them: a reduce-scatter, done as an
  all-reduce and a slice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return dist.get_world_size(group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x.chunk(_size(group), dim=dim)[dist.get_rank(group)].contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherSlices(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _own_slice(grad, ctx.dim, ctx.group), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return _own_slice(g, ctx.dim, ctx.group), None, None


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable."""
    return _AllReduce.apply(x, group)


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``; its gradient summed over ``group``'s ranks."""
    return _CopyToGroup.apply(x, group)


def gather_slices(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; gradient: the rank's
    slice."""
    return _GatherSlices.apply(x, dim, group)


def gather_shards(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``; gradient: the rank's
    slice of the gradient summed over the ranks."""
    return _GatherShards.apply(x, dim, group)


@torch.no_grad()
def gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (no gradient)."""
    return _gather(x, dim, group)


@torch.no_grad()
def bucketed_(tensors, collective) -> None:
    """Apply ``collective`` (an in-place collective of one tensor, e.g. a
    SUM all-reduce or a broadcast) to ``tensors`` as one flat buffer a dtype,
    and copy the result back in place: one call a dtype, not one a tensor."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        o = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[o:o + n].view(t.shape))
            o += n
