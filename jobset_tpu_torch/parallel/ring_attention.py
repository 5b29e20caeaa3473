"""Ring attention: exact attention over a sequence split across the sp
axis (counterpart of `jobset_tpu/parallel/ring_attention.py`).

Each sp rank holds a contiguous chunk of the sequence (rank r: positions
[r*T_local, (r+1)*T_local)). The K/V blocks travel around the ring, one
rank a step (`collectives.rotate`), and each rank folds the block it holds
into an online-softmax accumulator (`flash_block.merge_block_stats`), one
flash block step a ring step, then normalizes once. At step r rank i holds
chunk (i - r) mod sp, and its bias follows the reference: under `causal`
the triangle on the diagonal (step 0), zeros for an earlier chunk and a
fully masked block for a later one (`flash_block.constant_mask`'s
"causal", "zero" and "masked", each with its tile classes, so the card's
kernel skips every tile of the masked block); without `causal` zeros.

Every rank folds every block, the masked ones too, so that every rank of
the group builds an autograd graph of one shape: the backward's rotations
(by -1) then run in one order on every rank. K and V ride the ring
compact under GQA (broadcast per block at the kernel call, as a view) and
packed into one buffer, one rotation and one backward chain a step; sp - 1
rotations in all (the last block is folded where it arrives).

With `group=None` (sp = 1) the fold runs once, over the whole local
sequence, and the block's statistics are normalized directly: merging
one block into the empty accumulator returns it unchanged.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import flash_block
from .collectives import rotate


def _fold(q, k, v, group_size: int, kind: str):
    """One flash block step of q against k/v [B, Tk, H_kv, D] under the
    constant mask `kind`."""
    bias, classes = flash_block.constant_mask(kind, q.shape[1], k.shape[1], q.device)
    return flash_block.block_attention(
        q, flash_block._repeat_heads(k, group_size), flash_block._repeat_heads(v, group_size),
        bias, classes=classes,
    )


def ring_attention(q, k, v, group=None, causal: bool = True):
    """Exact attention over [B, T_local, H, D] q/k/v chunks laid out in ring
    order over the sp process group `group` (None: one rank). k/v may carry
    fewer heads than q (GQA). Returns [B, T_local, H, D] in q's dtype."""
    group_size = q.shape[2] // k.shape[2]
    if group is None:
        _, blk_sum, blk_out = _fold(q, k, v, group_size, "causal" if causal else "zero")
        return flash_block.normalize_block_stats(blk_sum, blk_out).to(q.dtype)
    sp, me = dist.get_world_size(group), dist.get_rank(group)
    acc = _fold(q, k, v, group_size, "causal" if causal else "zero")
    kv = torch.stack([k, v])
    for r in range(1, sp):
        kv = rotate(kv, group)
        held = (me - r) % sp  # the global chunk this block holds
        kind = "zero" if not causal or held < me else "masked"
        acc = flash_block.merge_block_stats(acc, _fold(q, kv[0], kv[1], group_size, kind))
    return flash_block.normalize_block_stats(acc[1], acc[2]).to(q.dtype)
