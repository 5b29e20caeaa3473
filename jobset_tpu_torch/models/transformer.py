"""Flagship decoder-only transformer in PyTorch: the dense single-device
subset of `jobset_tpu/models/transformer.py`.

Parameters are a plain dict that keeps the JAX tree's names and stacked
`[pp=1, layers, ...]` shapes, so a JAX param tree converts leaf for leaf
(`jobset_tpu_torch.convert.params_from_jax`). Compute runs in `cfg.dtype`
(bf16 by default) over f32 parameters, with f32 norm and softmax
statistics. Attention goes through `ring_attention` at sp = 1, that is one
flash block step (`ops.flash_block`) per layer. The GEMMs stay
`torch.matmul`, as the JAX package leaves them to XLA.

Training (`build_train_step`, `build_eval_step`) is the JAX package's on
one device: the per-token cross-entropy with label smoothing and z-loss,
the time-chunked loss (`loss_chunk`), per-layer rematerialization
(`torch.utils.checkpoint`, policies "full" and "dots"), gradient
accumulation, and an optimizer from `runtime.optim` applied as
`(p + u).to(p.dtype)`.

Not ported yet: MoE, tp/sp/pp/ep > 1, microbatched pipelines and Ulysses
attention; `TransformerConfig.validate` rejects them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from .. import tree
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
    # Training knobs, with the JAX package's defaults.
    # Per-layer rematerialization on the backward: "full" saves the layer
    # boundaries only; "dots" saves the GEMM outputs and the attention
    # output and recomputes norms, rotary and activations.
    remat: bool = True
    remat_policy: str = "full"
    # Time chunk of the loss (0 = off): only [B, loss_chunk, vocab] logits
    # are resident, each chunk recomputed on the backward.
    loss_chunk: int = 0
    label_smoothing: float = 0.0
    z_loss_coef: float = 0.0
    # Pipeline microbatches (0 = the pp size); only one is ported.
    n_microbatches: int = 0
    max_seq_len: int = 2048
    moe_aux_coef: float = 0.01
    pipeline_schedule: str = "gpipe"

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
        if self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be >= 0, got {self.loss_chunk}")
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError(f"label_smoothing must be in [0, 1), got {self.label_smoothing}")
        if self.z_loss_coef < 0.0:
            raise ValueError(f"z_loss_coef must be >= 0, got {self.z_loss_coef}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r} (expected 'full' or 'dots')"
            )
        if self.pipeline_schedule not in ("gpipe", "interleaved", "1f1b"):
            raise ValueError(f"unknown pipeline_schedule {self.pipeline_schedule!r}")
        if self.pipeline_schedule != "gpipe":
            raise NotImplementedError(
                f"pipeline_schedule={self.pipeline_schedule!r}: only 'gpipe' at pp=1 is ported"
            )
        if self.n_microbatches > 1:
            raise NotImplementedError(
                f"n_microbatches={self.n_microbatches}: the port runs one microbatch (pp=1)"
            )


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


def _attention_inputs(p, x, cfg: TransformerConfig):
    """Pre-norm, the fused QKV GEMM and rotary: x [B, T, d] -> q [B, T, H,
    D] and k, v [B, T, H_kv, D]."""
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
    return q, key, heads(value, cfg.kv_heads)


def _dense_mlp(p, xn, cfg):
    compute = cfg.dtype
    h = F.silu(xn.to(compute) @ weight_cast(p["w1"], compute))
    return h @ weight_cast(p["w2"], compute)


def _layer_out(p, x, attn, cfg: TransformerConfig):
    """The output projection of attn [B, T, H, D] onto the residual x,
    then the MLP on the residual."""
    batch, t, heads, dim = attn.shape
    out = attn.reshape(batch, t, heads * dim).to(cfg.dtype) @ weight_cast(p["wo"], cfg.dtype)
    x = x + out.to(x.dtype)
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _dense_mlp(p, xn, cfg).to(x.dtype)


def _layer(p, x, cfg: TransformerConfig):
    """One dense layer: attention block, then the MLP on the residual."""
    attn = ring_attention(*_attention_inputs(p, x, cfg), causal=True)
    return _layer_out(p, x, attn, cfg)


# The GEMMs whose outputs remat_policy="dots" saves (`x @ w` reaches aten
# as mm; the attention products are bmm).
_SAVED_BY_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default]


def _remat_layer(p, x, cfg: TransformerConfig):
    """`_layer` under the configured rematerialization while gradients are
    recorded. "full" checkpoints the whole layer, so the backward runs its
    forward again, attention kernel included. "dots" keeps the attention
    call outside any checkpoint (its output and the saved q, k, v stay;
    selective checkpointing sees aten ops, not the attention's autograd
    Function) and checkpoints the pieces before and after it, saving their
    GEMM outputs and recomputing norms, rotary and silu."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _layer(p, x, cfg)
    if cfg.remat_policy == "full":
        return checkpoint(_layer, p, x, cfg, use_reentrant=False)
    dots = partial(create_selective_checkpoint_contexts, _SAVED_BY_DOTS)
    q, k, v = checkpoint(_attention_inputs, p, x, cfg, use_reentrant=False, context_fn=dots)
    attn = ring_attention(q, k, v, causal=True)
    return checkpoint(_layer_out, p, x, attn, cfg, use_reentrant=False, context_fn=dots)


def unembed_logits(params, xn, cfg):
    """Logits from final hidden states: the unembedding matrix, or the
    transposed embedding when tied."""
    if cfg.tie_embeddings:
        return xn.to(cfg.dtype) @ params["embed"].to(cfg.dtype).T
    return xn.to(cfg.dtype) @ weight_cast(params["unembed"], cfg.dtype)


def _layer_views(params: dict) -> list:
    """Per-layer views of the stacked leaves, cut with one unbind per leaf
    so that the backward stacks each leaf's gradient once."""
    stacked = {name: a[0].unbind(0) for name, a in params["layers"].items()}
    return [{name: s[i] for name, s in stacked.items()} for i in range(n_layers_of(params))]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _softmax_xent(logits, targets, cfg: TransformerConfig):
    """Per-token cross-entropy [B, T] from logits [B, T, V] (tp = 1), in f32,
    with label smoothing eps (target (1-eps)*one_hot + eps/V: the loss is
    lse - (1-eps)*tgt - eps*mean_v(logits)) and z-loss (+ coef * lse^2).
    The max shift is a constant of the log-sum-exp (detached). The target
    logit is gathered; an id outside the vocab contributes 0 to it."""
    logits = logits.float()
    row_max = logits.detach().amax(dim=-1)
    lse = torch.log(torch.exp(logits - row_max[..., None]).sum(dim=-1)) + row_max
    in_vocab = (targets >= 0) & (targets < logits.shape[-1])
    ids = torch.where(in_vocab, targets, 0).long()
    tgt = logits.gather(-1, ids[..., None])[..., 0] * in_vocab
    eps = cfg.label_smoothing
    if eps:
        tgt = (1.0 - eps) * tgt + eps * (logits.sum(dim=-1) / cfg.vocab_size)
    loss = lse - tgt
    if cfg.z_loss_coef:
        loss = loss + cfg.z_loss_coef * torch.square(lse)
    return loss


def _token_ce(params, xn, targets, cfg: TransformerConfig):
    """Per-token cross-entropy [B, T] from final hidden states, honoring
    `loss_chunk`: time chunks run under checkpoint, so only [B, chunk, V]
    logits are resident, each recomputed on the backward (exact: the loss
    is a per-token sum). The chunk must divide T; at or above T it is off."""
    t = xn.shape[1]

    def token_losses(xn_c, targets_c):
        return _softmax_xent(unembed_logits(params, xn_c, cfg), targets_c, cfg)

    chunk = cfg.loss_chunk
    if not chunk or chunk >= t:
        return token_losses(xn, targets)
    if t % chunk:
        raise ValueError(f"loss_chunk {chunk} must divide the local sequence length {t}")
    run = (partial(checkpoint, token_losses, use_reentrant=False)
           if torch.is_grad_enabled() else token_losses)
    return torch.cat([run(xn[:, i:i + chunk], targets[:, i:i + chunk])
                      for i in range(0, t, chunk)], dim=1)


def _local_loss(params, inputs, targets, mask, cfg: TransformerConfig):
    """(loss_sum, token_count, aux) of one batch on one device; aux, the
    MoE balancing loss, is 0 on the dense model."""
    x = _embed_tokens(params["embed"], inputs, cfg)
    for p in _layer_views(params):
        x = _remat_layer(p, x, cfg)
    xn = rms_norm(x, params["final_norm"], cfg.norm_eps)
    per_token = _token_ce(params, xn, targets, cfg)
    return (per_token * mask).sum(), mask.sum(), per_token.new_zeros(())


def _batch_on(batch: dict, device):
    """(inputs, targets, mask) on `device`; the mask defaults to ones, f32."""
    inputs = torch.as_tensor(batch["inputs"]).to(device, non_blocking=True)
    targets = torch.as_tensor(batch["targets"]).to(device, non_blocking=True)
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32, device=device) if mask is None
            else torch.as_tensor(mask).to(device, torch.float32, non_blocking=True))
    return inputs, targets, mask


def build_train_step(config: TransformerConfig, optimizer, accum_steps: int = 1, device=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss) on
    `device` (the card unless the caller names another). The loss is
    ce / max(token count, 1) (+ moe_aux_coef * aux); `optimizer` is a
    `runtime.optim.Optimizer` (init/update over param trees).

    accum_steps: the batch splits into that many equal chunks along its
    first axis, run in sequence; their losses and gradients are averaged
    before one update. The step returns new tensors and leaves its
    arguments as they were."""
    cfg = config
    cfg.validate()
    device = resolve_device(device)

    def loss_and_grads(params, inputs, targets, mask):
        live = tree.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss_sum, count, aux = _local_loss(live, inputs, targets, mask, cfg)
        loss = loss_sum / torch.clamp(count, min=1.0) + cfg.moe_aux_coef * aux
        grads = torch.autograd.grad(loss, tree.leaves(live))
        return loss.detach(), list(grads)

    def train_step(params, opt_state, batch):
        inputs, targets, mask = _batch_on(batch, device)
        if accum_steps > 1:
            b = inputs.shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} not divisible by accum_steps {accum_steps}")
            loss, grads = 0.0, None
            for part in zip(*(t.chunk(accum_steps) for t in (inputs, targets, mask))):
                loss_k, grads_k = loss_and_grads(params, *part)
                loss = loss + loss_k
                if grads is None:
                    grads = grads_k
                else:
                    torch._foreach_add_(grads, grads_k)
            loss = loss * (1.0 / accum_steps)
            torch._foreach_mul_(grads, 1.0 / accum_steps)
        else:
            loss, grads = loss_and_grads(params, inputs, targets, mask)
        updates, opt_state = optimizer.update(tree.rebuild(params, grads), opt_state, params)
        new_params = tree.tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
        return new_params, opt_state, loss

    return train_step


def build_eval_step(config: TransformerConfig, device=None):
    """eval_step(params, batch) -> mean per-token cross-entropy (a 0-dim f32
    tensor): the loss half of `build_train_step`, without gradients. Label
    smoothing and z-loss are off, so exp(loss) stays a perplexity."""
    cfg = replace(config, label_smoothing=0.0, z_loss_coef=0.0)
    cfg.validate()
    device = resolve_device(device)

    @torch.no_grad()
    def eval_step(params, batch):
        loss_sum, count, _ = _local_loss(params, *_batch_on(batch, device), cfg)
        return loss_sum / torch.clamp(count, min=1.0)

    return eval_step


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
