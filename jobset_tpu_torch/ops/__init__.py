"""Attention ops of the port: the flash block step and its folds."""

from .flash_block import (
    NEG_INF,
    block_attention,
    block_attention_reference,
    blockwise_causal_attention,
    merge_block_stats,
    normalize_block_stats,
)

__all__ = [
    "NEG_INF",
    "block_attention",
    "block_attention_reference",
    "blockwise_causal_attention",
    "merge_block_stats",
    "normalize_block_stats",
]
