"""Ring attention, ported at sp = 1 (counterpart of
`jobset_tpu/parallel/ring_attention.py`).

At sp = 1 the ring has one rank: the fold runs once, over the whole local
sequence with the triangular (or, without `causal`, zero) bias. Merging
one block into the empty accumulator returns the block unchanged, so the
block's statistics are normalized directly; gradients flow back through
the normalization and `block_attention`'s backward. The K/V rotation for
sp > 1 comes with the multi-device slice.
"""

from __future__ import annotations

import torch

from ..ops import flash_block


def ring_attention(q, k, v, sp: int = 1, causal: bool = True):
    """Exact attention over [B, T, H, D] q/k/v (k/v may carry fewer heads:
    GQA). Returns [B, T, H, D] in q's dtype."""
    if sp != 1:
        raise NotImplementedError(
            f"ring_attention: sp={sp}; the port runs sp=1 only so far"
        )
    t_local, heads = q.shape[1], q.shape[2]
    group = heads // k.shape[2]
    if causal:
        bias = flash_block.causal_bias(t_local, q.device)
    else:
        bias = torch.zeros((t_local, t_local), dtype=torch.float32, device=q.device)
    _, blk_sum, blk_out = flash_block.block_attention(
        q, flash_block._repeat_heads(k, group), flash_block._repeat_heads(v, group), bias
    )
    return flash_block.normalize_block_stats(blk_sum, blk_out).to(q.dtype)
