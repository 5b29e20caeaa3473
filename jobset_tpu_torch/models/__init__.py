"""The flagship transformer's forward and greedy serving path in PyTorch."""

from .decode import build_generate
from .transformer import TransformerConfig, build_forward, init_params

__all__ = ["TransformerConfig", "build_forward", "build_generate", "init_params"]
