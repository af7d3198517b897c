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

Spatially split serving (``spatial``) adds two without gradients:
:func:`halo_exchange`, the rows of a map that a rank's slab reads beyond its
own, from an all-gather of every rank's edge rows; and :func:`gather_rows`,
maps split by rows put back whole on every rank.
"""

from __future__ import annotations

import math

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


@torch.no_grad()
def halo_exchange(x: torch.Tensor, owned, need, rank: int, group, up: int, down: int):
    """Rows ``need[rank]`` = [lo, hi) of a (bs, C, H, W) map split over
    ``group``'s ranks as ``owned`` (rank r holds rows owned[r]; ``x`` is this
    rank's), and how many of them came from other ranks.

    One all-gather of fixed-size edge buffers, no send/recv (gloo's on CUDA
    tensors ends the process): every rank sends its bottom ``up`` rows and
    its top ``down`` rows, (bs, up + down, W, C), zero-padded where it holds
    fewer (or none). ``up`` is at least the most rows any rank needs above
    its own, ``down`` below, so a rank's rows that another needs always lie
    in those edges, from a neighbour's or, past a short slab, the rank
    beyond it. Every rank of the group calls it, needing rows or not."""
    bs, c, _, w = x.shape
    s, e = owned[rank]
    nhwc = x.permute(0, 2, 3, 1)
    buf = x.new_zeros((bs, up + down, w, c))
    tail, head = min(up, e - s), min(down, e - s)
    if tail:
        buf[:, up - tail:up] = nhwc[:, e - s - tail:]
    if head:
        buf[:, up:up + head] = nhwc[:, :head]
    parts = [torch.empty_like(buf) for _ in range(len(owned))]
    dist.all_gather(parts, buf, group=group)
    lo, hi = need[rank]
    pieces, got = [], 0
    for r, (s2, e2) in enumerate(owned):
        x0, x1 = max(lo, s2), min(hi, e2)
        if x0 >= x1:
            continue
        if r == rank:
            pieces.append(nhwc[:, x0 - s:x1 - s])
            continue
        got += x1 - x0
        if r < rank:  # from its bottom rows
            if e2 - x0 > up:
                raise ValueError(f"rank {rank} needs rows {x0}..{x1} of rank {r} ({s2}..{e2}), "
                                 f"past its {up} edge rows")
            pieces.append(parts[r][:, up - (e2 - x0):up - (e2 - x1)])
        else:  # from its top rows
            if x1 - s2 > down:
                raise ValueError(f"rank {rank} needs rows {x0}..{x1} of rank {r} ({s2}..{e2}), "
                                 f"past its {down} edge rows")
            pieces.append(parts[r][:, up + x0 - s2:up + x1 - s2])
    out = torch.cat(pieces, 1) if pieces else nhwc[:, :0]
    if out.shape[1] != max(0, hi - lo):
        raise ValueError(f"rank {rank} assembled {out.shape[1]} of rows {lo}..{hi}")
    return out.permute(0, 3, 1, 2), got


@torch.no_grad()
def gather_rows(xs, owned, dim: int, group):
    """Each tensor of ``xs`` whole on every rank: tensor i is split along
    ``dim`` over ``group``'s ranks as ``owned[i]`` (rank r holds rows
    owned[i][r]). One all-gather of every tensor padded to its largest
    part, the parts then trimmed and joined in order. One rank: ``xs``."""
    n = len(owned[0])
    if n == 1:
        return list(xs)
    shapes, flat = [], []
    for x, parts in zip(xs, owned):
        shape = list(x.shape)
        shape[dim] = max(b - a for a, b in parts)
        buf = x.new_zeros(shape)
        buf.narrow(dim, 0, x.shape[dim]).copy_(x)
        shapes.append(shape)
        flat.append(buf.reshape(-1))
    flat = torch.cat(flat)
    got = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(got, flat, group=group)
    out, pos = [], 0
    for shape, parts in zip(shapes, owned):
        size = math.prod(shape)
        out.append(torch.cat([g[pos:pos + size].view(shape).narrow(dim, 0, b - a)
                              for g, (a, b) in zip(got, parts)], dim))
        pos += size
    return out
