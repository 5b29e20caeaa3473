"""Flagship decoder-only transformer in PyTorch: the dense single-device
subset of `jobset_tpu/models/transformer.py`.

Parameters are a plain dict that keeps the JAX tree's names and stacked
`[pp=1, layers, ...]` shapes, so a JAX param tree converts leaf for leaf
(`jobset_tpu_torch.convert.params_from_jax`). Compute runs in `cfg.dtype`
(bf16 by default) over f32 parameters, with f32 norm and softmax
statistics. Attention goes through `ring_attention` at sp = 1, that is one
flash block step (`ops.flash_block`) per layer. The GEMMs stay
`torch.matmul`, as the JAX package leaves them to XLA.

Not ported yet: MoE, tp/sp/pp/ep > 1, Ulysses attention and training;
`TransformerConfig.validate` rejects them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.flash_block import MAX_HEAD_DIM
from ..parallel.ring_attention import ring_attention
from .quant import weight_cast


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    # Grouped-query attention: K/V heads (0 = n_heads, i.e. MHA).
    n_kv_heads: int = 0
    d_ff: int = 2048
    n_layers: int = 8
    # MoE experts; 0 = dense MLP. Only 0 is ported so far.
    n_experts: int = 0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # Logits = x @ embed^T instead of a separate unembedding.
    tie_embeddings: bool = False
    # Sequence-parallel attention strategy; only "ring" (at sp = 1) is ported.
    attn_impl: str = "ring"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def validate(self, mesh_shape: Mapping[str, int] | None = None) -> None:
        """Reject what the port cannot run: bad widths, and every setting
        it has not ported (experts, any mesh axis > 1, Ulysses)."""
        for axis, size in (mesh_shape or {}).items():
            if size != 1:
                raise NotImplementedError(
                    f"mesh axis {axis}={size}: the port runs on one device "
                    "(every mesh axis 1) so far"
                )
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide evenly into heads")
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads {self.kv_heads}"
            )
        if self.head_dim % 2 or self.head_dim > MAX_HEAD_DIM:
            raise ValueError(
                f"head_dim {self.head_dim} must be even (rotary) and at most "
                f"{MAX_HEAD_DIM} (the flash kernel)"
            )
        if self.n_experts:
            raise NotImplementedError("n_experts > 0 (MoE) is not ported yet")
        if self.attn_impl != "ring":
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r}: only 'ring' (sp=1) is ported"
            )
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {self.dtype} is not float32 or bfloat16")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(config: TransformerConfig) -> dict:
    """Counterpart of the JAX `param_specs`: the param tree's names, each
    with (shape, fan_in); fan_in None marks a norm scale (ones). Layer
    leaves are stacked [pp=1, n_layers, ...]."""
    cfg = config
    d, h, dh, lps = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_layers
    shapes = {
        "embed": ((cfg.vocab_size, d), d),
        "final_norm": ((d,), None),
        "layers": {
            "ln1": ((1, lps, d), None),
            "ln2": ((1, lps, d), None),
            "wq": ((1, lps, d, h * dh), d),
            "wk": ((1, lps, d, cfg.kv_heads * dh), d),
            "wv": ((1, lps, d, cfg.kv_heads * dh), d),
            "wo": ((1, lps, h * dh, d), h * dh),
            "w1": ((1, lps, d, cfg.d_ff), d),
            "w2": ((1, lps, cfg.d_ff, d), cfg.d_ff),
        },
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = ((d, cfg.vocab_size), d)
    return shapes


def init_params(config: TransformerConfig, generator: torch.Generator, device=None) -> dict:
    """Random parameters: normal / sqrt(fan_in) for matrices, ones for norm
    scales, drawn on the generator's device and placed on `device`. The
    numbers differ from the JAX `init_params` for the same seed."""
    cfg = config
    device = resolve_device(device)

    def make(shape, fan_in):
        if fan_in is None:
            return torch.ones(shape, dtype=cfg.param_dtype, device=device)
        w = torch.randn(
            shape, generator=generator, dtype=cfg.param_dtype, device=generator.device
        )
        return (w / math.sqrt(fan_in)).to(device)

    def walk(tree):
        return {
            name: walk(v) if isinstance(v, dict) else make(*v)
            for name, v in tree.items()
        }

    return walk(param_shapes(cfg))


def layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked [pp=1, layers, ...] leaves (views)."""
    return {name: a[0, i] for name, a in params["layers"].items()}


def n_layers_of(params: dict) -> int:
    return params["layers"]["ln1"].shape[1]


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps):
    """f32 statistics, result cast back to x's dtype."""
    x32 = x.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (normed * scale.float()).to(x.dtype)


def rotary(x, positions, theta):
    """x: [..., T, H, D]; positions: [T] f32. cos/sin are cast to x's
    dtype, as in the JAX version."""
    half = x.shape[-1] // 2
    inv = theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    freqs = positions[:, None] / inv  # [T, half]
    cos = torch.cos(freqs)[None, :, None, :].to(x.dtype)
    sin = torch.sin(freqs)[None, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _embed_tokens(embed, tokens, cfg):
    """Embedding gather (tp = 1). Ids outside the vocab give a zero row,
    as the JAX version's masked gather does."""
    in_vocab = (tokens >= 0) & (tokens < embed.shape[0])
    rows = embed[torch.where(in_vocab, tokens, 0)]
    return rows.to(cfg.dtype) * in_vocab[..., None].to(cfg.dtype)


def _attention_block(p, x, cfg: TransformerConfig):
    """Pre-norm attention with the fused QKV GEMM, rotary, GQA and the
    output projection; returns the residual sum."""
    batch, t, _ = x.shape
    compute = cfg.dtype
    positions = torch.arange(t, dtype=torch.float32, device=x.device)
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)

    # Fused QKV: one [d, (h + 2*hkv)*dh] GEMM instead of three narrow ones.
    q_width = cfg.n_heads * cfg.head_dim
    kv_width = cfg.kv_heads * cfg.head_dim
    w_qkv = torch.cat([
        weight_cast(p["wq"], compute),
        weight_cast(p["wk"], compute),
        weight_cast(p["wv"], compute),
    ], dim=1)
    qkv = xn.to(compute) @ w_qkv
    q, key, value = torch.split(qkv, [q_width, kv_width, kv_width], dim=-1)

    def heads(y, n_heads):
        return y.reshape(batch, t, n_heads, cfg.head_dim)

    q = rotary(heads(q, cfg.n_heads), positions, cfg.rope_theta)
    key = rotary(heads(key, cfg.kv_heads), positions, cfg.rope_theta)
    attn = ring_attention(q, key, heads(value, cfg.kv_heads), causal=True)
    attn = attn.reshape(batch, t, q_width)
    out = attn.to(compute) @ weight_cast(p["wo"], compute)
    return x + out.to(x.dtype)


def _dense_mlp(p, xn, cfg):
    compute = cfg.dtype
    h = F.silu(xn.to(compute) @ weight_cast(p["w1"], compute))
    return h @ weight_cast(p["w2"], compute)


def _layer(p, x, cfg: TransformerConfig):
    """One dense layer: attention block, then the MLP on the residual."""
    x = _attention_block(p, x, cfg)
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _dense_mlp(p, xn, cfg).to(x.dtype)


def unembed_logits(params, xn, cfg):
    """Logits from final hidden states: the unembedding matrix, or the
    transposed embedding when tied."""
    if cfg.tie_embeddings:
        return xn.to(cfg.dtype) @ params["embed"].to(cfg.dtype).T
    return xn.to(cfg.dtype) @ weight_cast(params["unembed"], cfg.dtype)


def build_forward(config: TransformerConfig, device=None):
    """forward(params, tokens [B, T]) -> logits [B, T, vocab] in the compute
    dtype, on `device` (the card unless the caller names another)."""
    cfg = config
    cfg.validate()
    device = resolve_device(device)

    @torch.no_grad()
    def forward(params, tokens):
        x = _embed_tokens(params["embed"], tokens.to(device), cfg)
        for i in range(n_layers_of(params)):
            x = _layer(layer_params(params, i), x, cfg)
        xn = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed_logits(params, xn, cfg)

    return forward
