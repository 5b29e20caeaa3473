"""Ulysses sequence parallelism: attention with the heads, not the
sequence, split over sp (counterpart of
`jobset_tpu/parallel/ulysses_attention.py`).

Where `ring_attention` keeps the sequence split and moves K/V around the
ring, Ulysses moves the split: one all-to-all (`collectives.all_to_all`)
turns each rank's [B, T_local, H, D] chunk into [B, T, H/sp, D], the whole
sequence for a slice of the heads; the attention runs locally and exactly
(`flash_block.blockwise_causal_attention` at chunks of T_local, the
strictly-future chunk pairs skipped: sp(sp+1)/2 flash block steps under
`causal`); a second all-to-all puts the sequence split back. It needs
every rank's head counts divisible by sp. The gathered tensors stay in
the input dtype and come out of the all-to-all contiguous, as the card's
bf16 kernel (TMA loads) takes them.

With `group=None` (sp = 1) both all-to-alls are the identity and the fold
is one block over the local sequence.
"""

from __future__ import annotations

import torch.distributed as dist

from ..ops.flash_block import blockwise_causal_attention
from .collectives import all_to_all


def ulysses_attention(q, k, v, group=None, causal: bool = True):
    """Exact attention over [B, T_local, H, D] q/k/v chunks laid out in ring
    order (rank r: positions [r*T_local, (r+1)*T_local), rotary already
    applied) over the sp process group `group` (None: one rank). k/v may
    carry fewer heads than q (GQA); both head counts must divide by sp.
    Returns [B, T_local, H, D] in q's dtype."""
    sp = dist.get_world_size(group) if group is not None else 1
    t_local, heads_local = q.shape[1], q.shape[2]
    if heads_local % sp or k.shape[2] % sp:
        raise ValueError(
            f"ulysses attention requires q heads ({heads_local}) and kv "
            f"heads ({k.shape[2]}) divisible by sp ({sp}); lower sp/tp, "
            "pre-broadcast K/V, or use ring attention"
        )
    qg, kg, vg = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    out = blockwise_causal_attention(qg, kg, vg, chunk=t_local, causal=causal).to(q.dtype)
    return all_to_all(out, 1, 2, group)
