"""Single-device forward of the flagship transformer at the small config
of the JAX package's `__graft_entry__.entry()`."""

from __future__ import annotations

import torch

from .device import resolve_device
from .models.transformer import TransformerConfig, build_forward, init_params


def entry(device=None):
    """Returns (fn, args): fn(params, tokens) -> logits [2, 64, 256], on
    `device` (the card unless the caller names another)."""
    device = resolve_device(device)
    cfg = TransformerConfig(
        vocab_size=256,
        d_model=128,
        n_heads=8,
        d_ff=512,
        n_layers=4,
        dtype=torch.bfloat16,
    )
    generator = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, generator, device)
    forward = build_forward(cfg, device)
    tokens = torch.zeros((2, 64), dtype=torch.long, device=device)

    def fn(params, tokens):
        return forward(params, tokens)

    return fn, (params, tokens)
