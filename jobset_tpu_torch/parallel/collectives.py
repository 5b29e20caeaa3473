"""The collectives of the port's model code, with the gradients that
`lax.psum` has inside the reference's `shard_map`.

`psum` has two transposes there, and each is an autograd Function here:

- `reduce`: all-reduce (sum) forward, identity backward. The psum of a
  partial activation (the row-parallel `wo` and `w2` products, the
  vocab-sharded embedding, the loss's sums): every rank holds the same
  cotangent of the sum, which is the cotangent of its own part.
- `copy`: identity forward, all-reduce backward. The implicit `pvary`
  where a value replicated over the axis enters a sharded weight (the
  column-parallel QKV, `w1`, `we1` and unembedding products, and gate
  weights combined with partial expert outputs): each rank's cotangent
  is partial, and the transpose sums them.

`torch.distributed.nn.functional.all_reduce` is neither: its backward
all-reduces again, which would multiply gradients by the group size.

A group of None (an axis of size 1, or no process group) makes every
function here the identity. All of them work on CPU tensors under gloo
and on CUDA tensors under NCCL or gloo, so they use all-reduce only
(gloo has no all-gather of CUDA tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """psum of partial values: all-reduce forward, identity backward."""
    return x if group is None else _Reduce.apply(x, group)


def copy(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated value entering sharded work: identity forward,
    all-reduce of the cotangents backward."""
    return x if group is None else _Copy.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group, without a gradient (the reference
    takes it under stop_gradient)."""
    x = x.detach()
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MAX)


def all_reduce_(tensors: list, group) -> None:
    """Sum each tensor over the group in place, one all-reduce for each
    dtype (the tensors flattened into one buffer)."""
    if group is None or not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of x along `dim`, concatenated in group-rank
    order (no gradient). Each rank writes its shard into zeros and the
    group sums them, so it runs wherever all-reduce does."""
    if group is None:
        return x
    size, me = dist.get_world_size(group), dist.get_rank(group)
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] = width * size
    full = x.new_zeros(shape)
    full.narrow(dim, me * width, width).copy_(x.detach())
    dist.all_reduce(full, group=group)
    return full
