"""Autoregressive decoding for the flagship transformer: the serving path
of `jobset_tpu/models/decode.py`, on one device.

A prompt is prefilled in one batched causal pass per layer through
`blockwise_causal_attention` (the flash block kernel on the card), which
fills a KV cache; then each new token runs one cached step, whose
attention over the cache is plain matmuls. Unlike the JAX version the
cache is updated in place: each step writes one position of a
preallocated [layers, B, max_len, H_kv, D] buffer (for an int8 cache, of
its values and of its scales) instead of returning a new array.

Tokens are picked greedily or sampled (Gumbel-max at a temperature,
optionally over the exact top k logits). A mixture-of-experts model
serves as the reference serves it: top-k routing runs the prefill
through the sorted ragged products (`ops.grouped_matmul`) and the decode
step through every expert weighted by the top-k gates (every expert's
weights stream each step either way); expert choice, not causal, serves
through soft dispatch. Weights may be int8
(`quant.quantize_params_for_serving`; every matmul site goes through
`quant.matmul`, which sends a decode step's products to the int8 kernel
on the card, a layer's Q, K and V in one launch), and the KV cache may
be int8 with one scale per cached vector.

Not ported yet: dp/tp meshes.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.flash_block import NEG_INF, blockwise_causal_attention
from .quant import (
    QUANTIZED_WEIGHTS,
    QuantizedTensor,
    matmul,
    matmul_group,
    quantize_int8,
    weight_cast,
)
from .transformer import (
    TransformerConfig,
    _dense_mlp,
    _all_experts,
    _embed_tokens,
    _moe_mlp,
    _router_gates,
    layer_params,
    n_layers_of,
    renormalized_topk,
    rms_norm,
    rotary,
    sorted_ragged_expert_ffn,
    unembed_logits,
)


def init_kv_cache(config: TransformerConfig, batch: int, max_len: int, device,
                  quantized_kv: bool = False) -> dict:
    """Zeroed K/V caches [layers, B, max_len, H_kv, D] in the compute dtype.
    With GQA the cache holds only the n_kv_heads heads.

    quantized_kv: each cache is a QuantizedTensor, int8 values with one
    f32 scale per [layer, batch, position, head] vector. Unwritten
    positions read as exactly 0 (q = 0, scale = 1)."""
    cfg = config
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    if quantized_kv:
        def part():
            return QuantizedTensor(
                q=torch.zeros(shape, dtype=torch.int8, device=device),
                scale=torch.ones((*shape[:-1], 1), dtype=torch.float32, device=device),
            )

        return {"k": part(), "v": part()}
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _cache_write(cache_part, value, pos: int):
    """Store value [B, T, H, D] at positions pos..pos+T-1, in place: a
    dtype cast for a plain cache; for an int8 cache, the values quantized
    per vector (scale = absmax over D / 127), values and scales written at
    the same positions."""
    end = pos + value.shape[1]
    if isinstance(cache_part, QuantizedTensor):
        qt = quantize_int8(value, axis=-1)
        cache_part.q[:, pos:end] = qt.q
        cache_part.scale[:, pos:end] = qt.scale
        return cache_part
    cache_part[:, pos:end] = value.to(cache_part.dtype)
    return cache_part


def _cache_read(cache_part, dtype):
    """The whole cache in the compute dtype: identity for a plain cache,
    the int8 values dequantized for an int8 one (`weight_cast`)."""
    return weight_cast(cache_part, dtype)


def _layer_qkv(p, xn, base: int, cfg: TransformerConfig):
    """q/k/v for the tokens of xn at positions base..base+T-1, rotary
    applied; k/v with the kv head count, as the cache stores them. The
    three products share xn: with int8 weights a decode step's are one
    kernel launch (`quant.matmul_group`)."""
    positions = base + torch.arange(xn.shape[1], dtype=torch.float32, device=xn.device)
    q, k, v = (
        y.reshape(*y.shape[:-1], n_heads, cfg.head_dim)
        for y, n_heads in zip(matmul_group(xn, [p["wq"], p["wk"], p["wv"]], cfg.dtype),
                              (cfg.n_heads, cfg.kv_heads, cfg.kv_heads))
    )
    q = rotary(q, positions, cfg.rope_theta)
    return q, rotary(k, positions, cfg.rope_theta), v


def _topk_gates(p, xn, cfg: TransformerConfig):
    """The top-k serving formulations' router: f32 softmax gates, the top-k
    pick and renormalized weights. Returns (top_w, top_i), each [B, T, k]."""
    return renormalized_topk(_router_gates(xn, p["wg"]), cfg.moe_top_k)


def _moe_mlp_topk_decode(p, xn, cfg: TransformerConfig):
    """Token-choice top-k, all experts on every token, weighted by the
    top-k gates (zero elsewhere): the decode step's formulation. Its time
    is every expert's weights streaming from memory either way; with int8
    weights each expert stack is one `int8_matmul` launch."""
    n = xn.shape[0] * xn.shape[1]
    top_w, top_i = _topk_gates(p, xn, cfg)
    # [B*T, E]: each token's k gate weights at its experts, 0 elsewhere (a
    # token's k experts are distinct, so a scatter sets what the
    # reference's one-hot sum adds to 0).
    weights = torch.zeros((n, cfg.n_experts), dtype=torch.float32, device=xn.device)
    weights.scatter_(-1, top_i.reshape(n, -1), top_w.reshape(n, -1))
    return _all_experts(p, xn, weights, cfg)


def _moe_mlp_topk_sorted(p, xn, cfg: TransformerConfig):
    """Token-choice top-k for the prefill: the sorted ragged dispatch at
    activated FLOPs (`transformer.sorted_ragged_expert_ffn`); int8 expert
    stacks are dequantized once for the grouped products."""
    b, t, d = xn.shape
    k = cfg.moe_top_k
    top_w, top_i = _topk_gates(p, xn, cfg)
    out, _ = sorted_ragged_expert_ffn(p, xn.reshape(b * t, d), top_w.reshape(b * t, k),
                                      top_i.reshape(b * t, k), cfg)
    return out.reshape(b, t, d).to(cfg.dtype)


def _decode_mlp(p, xn, cfg: TransformerConfig):
    """Serving's feed-forward: dense; top-k MoE, sorted ragged for the
    prefill (T > 1) and all experts for the decode step; soft dispatch for
    soft-dispatch models and for expert choice (not causal: served at its
    full-capacity limit, as the reference does)."""
    if "wg" not in p:
        return _dense_mlp(p, xn, cfg)
    if cfg.moe_router == "token" and cfg.moe_top_k > 0:
        if xn.shape[1] > 1:
            return _moe_mlp_topk_sorted(p, xn, cfg)
        return _moe_mlp_topk_decode(p, xn, cfg)
    return _moe_mlp(p, xn, cfg)


def _layer_tail(p, x, attn, cfg: TransformerConfig):
    """Output projection and MLP: attn [B, T, H, D]."""
    compute = cfg.dtype
    attn = attn.reshape(*attn.shape[:-2], attn.shape[-2] * attn.shape[-1])
    x = x + matmul(attn, p["wo"], compute).to(x.dtype)
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _decode_mlp(p, xn2, cfg).to(x.dtype)


def _decode_layer(p, x, cache_k, cache_v, pos: int, cfg: TransformerConfig):
    """One layer, one token: x [B, 1, d]; cache_k/v [B, T_max, H_kv, D],
    written at `pos` in place. Returns x."""
    batch = x.shape[0]
    group = cfg.n_heads // cfg.kv_heads
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _layer_qkv(p, xn, pos, cfg)
    _cache_write(cache_k, k, pos)
    _cache_write(cache_v, v, pos)

    # GQA without a broadcast copy: q heads are grouped [n_kv, group] and
    # each group reads its kv head. Operands in the compute dtype, upcast
    # to f32 for the product; softmax statistics in f32.
    full_k = _cache_read(cache_k, cfg.dtype)
    full_v = _cache_read(cache_v, cfg.dtype)
    q5 = q.reshape(batch, 1, cfg.kv_heads, group, cfg.head_dim)
    logits = torch.einsum("bqngd,bknd->bngqk", q5.float(), full_k.float())
    logits = logits.reshape(batch, cfg.n_heads, 1, -1) * cfg.head_dim ** -0.5
    visible = torch.arange(logits.shape[-1], device=x.device) <= pos
    logits = torch.where(visible, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs5 = probs.reshape(batch, cfg.kv_heads, group, 1, -1)
    attn = torch.einsum(
        "bngqk,bknd->bqngd", probs5.to(full_v.dtype).float(), full_v.float()
    ).reshape(batch, 1, cfg.n_heads, cfg.head_dim)
    return _layer_tail(p, x, attn, cfg)


def _prefill_layer(p, x, cache_k, cache_v, cfg: TransformerConfig):
    """One layer over the whole prompt: x [B, Tp, d]. Writes K/V for
    positions 0..Tp-1 and folds attention blockwise over the flash step."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _layer_qkv(p, xn, 0, cfg)
    _cache_write(cache_k, k, 0)
    _cache_write(cache_v, v, 0)
    attn = blockwise_causal_attention(q, k, v)  # GQA broadcast inside
    return _layer_tail(p, x, attn, cfg)


def _run_stack(params, x, cache, cfg, layer_fn):
    """Run layer_fn over the layers (cache slices per layer), final-norm
    the last position and unembed it. Returns logits [B, vocab] f32."""
    for i in range(n_layers_of(params)):
        x = layer_fn(layer_params(params, i), x, cache["k"][i], cache["v"][i])
    xn = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed_logits(params, xn, cfg)[:, 0].float()


def _prefill_logits(params, prompt, cache, cfg):
    """prompt [B, Tp] -> last-position logits [B, vocab]; fills the cache."""
    x = _embed_tokens(params["embed"], prompt, cfg)
    return _run_stack(
        params, x, cache, cfg,
        lambda p, x, ck, cv: _prefill_layer(p, x, ck, cv, cfg),
    )


def _token_logits(params, token, cache, pos: int, cfg):
    """token [B] at position pos -> logits [B, vocab]; writes the cache."""
    x = _embed_tokens(params["embed"], token[:, None], cfg)
    return _run_stack(
        params, x, cache, cfg,
        lambda p, x, ck, cv: _decode_layer(p, x, ck, cv, pos, cfg),
    )


def _global_argmax(logits):
    """Greedy pick over the whole vocab (tp = 1); the lowest index wins a
    tie, as torch.argmax returns the first maximum."""
    return torch.argmax(logits, dim=-1)


def _gumbel(generator, shape, device):
    """Standard Gumbel noise, f32: -log(-log(u)) with u uniform in
    [tiny, 1), as jax.random.gumbel draws it (other bits than JAX's). The
    one source of sampling noise, so a test can feed both packages the
    same numbers."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def _top_k_mask(logits, top_k: int):
    """Keep exactly the top_k largest logits [B, V], ties broken by the
    lowest vocab index: a stable descending sort picks the k winners, and a
    logit tied with the k-th is kept only up to the highest index among
    the winners that share its value. A top_k above the vocab keeps all."""
    k = min(top_k, logits.shape[-1])
    sel_vals, sel_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    sel_vals, sel_idx = sel_vals[..., :k], sel_idx[..., :k]
    thresh = sel_vals[..., -1:]
    idx_cut = torch.where(sel_vals == thresh, sel_idx, -1).amax(dim=-1, keepdim=True)
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return (logits > thresh) | ((logits == thresh) & (idx <= idx_cut))


def _pick_token(logits, generator=None, temperature: float = 0.0, top_k: int = 0):
    """Greedy (temperature 0) or sampled pick from logits [B, V] f32.

    Sampling is Gumbel-max: argmax(logits / T + G) is an exact draw from
    softmax(logits / T). top_k > 0 restricts it to exactly the k largest
    logits (`_top_k_mask`), as the reference's `_pick_token` does at
    tp = 1."""
    if temperature <= 0.0:
        return _global_argmax(logits)
    # True division on the card too (see quant.quantize_int8), as on the CPU.
    z = logits.float() / torch.full((), temperature, device=logits.device)
    if top_k > 0:
        z = torch.where(_top_k_mask(logits, top_k), z, NEG_INF)
    return _global_argmax(z + _gumbel(generator, z.shape, z.device))


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Every float leaf cast once to the compute dtype (serving streams the
    whole parameter set each step; this halves its bytes from f32 to
    bf16). Norm scales are rounded to the compute dtype too, as in JAX.
    QuantizedTensors stay whole: int8 values and f32 scales. The MoE
    router `wg` stays as it is: routing reads it in f32, and a rounded
    copy would flip near-tied routes."""
    return {
        name: cast_params(v, dtype) if isinstance(v, dict)
        else v if isinstance(v, QuantizedTensor) or name == "wg"
        else v.to(dtype) if v.is_floating_point() else v
        for name, v in params.items()
    }


def _check_quantized(params: dict, quantized: bool) -> None:
    """The parameters must match the `quantized` flag: every serving matmul
    weight (QUANTIZED_WEIGHTS) int8 with it, none without it."""
    def walk(tree):
        for name, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v)
            elif name in QUANTIZED_WEIGHTS:
                yield name, isinstance(v, QuantizedTensor)

    wrong = sorted(name for name, is_q in walk(params) if is_q != quantized)
    if wrong:
        raise ValueError(
            f"build_generate(quantized={quantized}): weights {wrong} are "
            f"{'not ' if quantized else ''}int8 QuantizedTensors"
            + ("; quantize them with quantize_params_for_serving" if quantized else "")
        )


def build_generate(config: TransformerConfig, max_new_tokens: int, device=None,
                   temperature: float = 0.0, top_k: int = 0, quantized: bool = False,
                   quantized_kv: bool = False):
    """generate(params, prompt [B, Tp], generator=None) -> tokens
    [B, Tp + max_new_tokens], on `device` (the card unless the caller names
    another).

    temperature 0 decodes greedily; above 0 each token is drawn from
    softmax(logits / temperature), optionally over the top_k logits only
    (`_pick_token`). `generator` (a torch.Generator on the device) seeds
    the sampling; without one, a generator seeded with 0 is made on the
    device for each call. Greedy decoding ignores it.

    quantized: the parameters came through `quantize_params_for_serving`
    (int8 matmul weights); parameters that do not match the flag raise.
    quantized_kv: the KV cache is int8, one scale per cached vector.

    The prompt is prefilled in one batched pass, then new tokens decode
    through the cached step. max_new_tokens == 0 returns the prompt."""
    cfg = config
    cfg.validate()
    device = resolve_device(device)

    @torch.no_grad()
    def generate(params, prompt, generator=None):
        _check_quantized(params, quantized)
        prompt = prompt.to(device)
        if max_new_tokens == 0:
            return prompt
        if generator is None and temperature > 0.0:
            generator = torch.Generator(device=device).manual_seed(0)

        def pick(logits):
            return _pick_token(logits, generator, temperature, top_k).to(prompt.dtype)

        params = cast_params(params, cfg.dtype)
        t_prompt = prompt.shape[1]
        cache = init_kv_cache(cfg, prompt.shape[0], t_prompt + max_new_tokens, device,
                              quantized_kv=quantized_kv)
        token = pick(_prefill_logits(params, prompt, cache, cfg))
        parts = [prompt, token[:, None]]
        for pos in range(t_prompt, t_prompt + max_new_tokens - 1):
            token = pick(_token_logits(params, token, cache, pos, cfg))
            parts.append(token[:, None])
        return torch.cat(parts, dim=1)

    return generate
