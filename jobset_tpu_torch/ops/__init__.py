"""Ops of the port: the flash block step and its folds (exported here),
the auction kernel (`ops.auction`) and the int8 decode product
(`ops.int8_matmul`)."""

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
