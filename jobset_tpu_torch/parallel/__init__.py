"""Sequence-parallel attention of the port (sp = 1 only in this slice)."""

from .ring_attention import ring_attention

__all__ = ["ring_attention"]
