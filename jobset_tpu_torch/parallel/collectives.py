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

Sequence parallelism adds two more, with their own transposes:

- `rotate`: the ring's `lax.ppermute` by +1 (rank i's tensor goes to rank
  i + 1); its backward rotates the cotangent by -1.
- `all_to_all`: `lax.all_to_all(tiled=True)`, each rank's tensor split in
  group-size chunks along one dim, chunk j sent to rank j, the chunks a
  rank receives concatenated along another dim in group-rank order; its
  backward is the all-to-all with the two dims swapped.

Expert parallelism adds `gather` with a gradient: the reference's tiled
`lax.all_gather` of the routed layers' disjoint token chunks, whose
result is replicated over the group. A replicated value's cotangent is
whole on every rank here (`reduce`'s identity backward), so the
transpose keeps this rank's slice of it (a reduce-scatter would count it
once a rank).

Pipeline parallelism adds `shift`, the pipeline's `lax.ppermute` by a
step, cyclic or not, with no gradient: the pipeline loop
(`parallel.pipeline.drive`) moves activations and cotangents itself, so
that every rank of the pp group makes every call.

A group of None (an axis of size 1, or no process group) makes every
function here the identity, and every output is contiguous. All of them
work on CPU tensors under gloo and on CUDA tensors under NCCL or gloo
(ranks that share one card run gloo). The sums use all-reduce; `gather`,
`rotate` and `all_to_all` move values with one primitive,
`all_to_all_single`, which gloo runs on CUDA tensors where its send/recv
does not (gloo's send of a CUDA tensor hands the device pointer to the
socket as host memory and aborts; `chip_smoke.py` phase 16 probes both).
Each moves the bytes of the collective it stands for: `rotate` and
`shift` send this rank's tensor to one peer (split sizes of zero for the
others), `gather` sends it to every rank.
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


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise min over the group, without a gradient (the greedy
    pick's `lax.pmin` of the winning vocab index)."""
    x = x.detach()
    return x if group is None else _all_reduce(x, group, dist.ReduceOp.MIN)


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


def _exchange(rows: torch.Tensor, group, send=None, recv=None) -> torch.Tensor:
    """`all_to_all_single` over the group: row j of `rows` (dim 0, or the
    `send` split sizes) goes to group rank j, and the result holds what
    each rank sent this one, in group-rank order (no gradient)."""
    rows = rows.detach().contiguous()
    out = rows.new_empty((sum(recv), *rows.shape[1:]) if recv else rows.shape)
    dist.all_to_all_single(out, rows, recv, send, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        rows = _exchange(x.expand(dist.get_world_size(group), *x.shape), group)
        return torch.cat(rows.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank(ctx.group) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """`lax.all_gather(x, axis_name, axis=dim, tiled=True)` over the group:
    the group's shards of x along `dim`, concatenated in group-rank order.
    Backward: this rank's slice of the cotangent (the gathered value is
    replicated, so its cotangent is whole on every rank)."""
    return x if group is None else _Gather.apply(x, dim, group)


def _rotated(x: torch.Tensor, shift: int, group) -> torch.Tensor:
    """The x of the rank `shift` places before this one."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    n = x.numel()
    send = [n if j == (me + shift) % size else 0 for j in range(size)]
    recv = [n if j == (me - shift) % size else 0 for j in range(size)]
    return _exchange(x.reshape(-1), group, send, recv).view(x.shape)


def shift(x: torch.Tensor, group, step: int = 1, cyclic: bool = False) -> torch.Tensor:
    """`lax.ppermute` by `step` over the group, without a gradient: rank i's
    x goes to rank i + step. Cyclic, the ranks wrap around; not cyclic, the
    ranks past the edge send nothing and those with no source get zeros
    (the reference's `shift_perm`; its `cyclic_perm` when cyclic). A group
    of None is the identity."""
    if group is None:
        return x.contiguous()
    size, me = dist.get_world_size(group), dist.get_rank(group)
    dest, src = me + step, me - step
    if cyclic:
        dest, src = dest % size, src % size
    n = x.numel()
    send = [n if j == dest else 0 for j in range(size)]
    recv = [n if j == src else 0 for j in range(size)]
    got = _exchange(x.reshape(-1)[:sum(send)], group, send, recv)
    return got.view(x.shape) if 0 <= src < size else x.new_zeros(x.shape)


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rotated(x, 1, group)

    @staticmethod
    def backward(ctx, grad):
        return _rotated(grad, -1, ctx.group), None


def rotate(x: torch.Tensor, group) -> torch.Tensor:
    """The ring's step: rank i's x arrives at rank i + 1 (mod the group),
    so this rank gets rank i - 1's. Backward: the rotation by -1."""
    return x if group is None else _Rotate.apply(x, group)


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    size = dist.get_world_size(group)
    if x.shape[split_dim] % size:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} is not divisible "
                         f"by the group's {size} ranks")
    rows = _exchange(torch.stack(x.chunk(size, dim=split_dim)), group)
    return torch.cat(rows.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(grad, concat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group) -> torch.Tensor:
    """`lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)` over the group: x cut into group-size chunks along
    split_dim, chunk j to group rank j, the received chunks concatenated
    along concat_dim in group-rank order. Backward: the all-to-all with the
    dims swapped."""
    return x if group is None else _AllToAll.apply(x, split_dim, concat_dim, group)
