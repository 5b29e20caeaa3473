"""The flagship transformer's forward, greedy serving path and
single-device training step in PyTorch."""

from .decode import build_generate
from .transformer import (
    TransformerConfig,
    build_eval_step,
    build_forward,
    build_train_step,
    init_params,
)

__all__ = [
    "TransformerConfig",
    "build_eval_step",
    "build_forward",
    "build_generate",
    "build_train_step",
    "init_params",
]
