"""Autoregressive decoding for the flagship transformer: the serving path
of `jobset_tpu/models/decode.py`, on one device or over a dp x tp mesh.

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

Over a mesh (`mesh`, a `parallel.mesh.Mesh` with pp, sp and ep at 1, as
the reference's) each rank serves its dp rows of the prompt with its tp
shards of the parameters (`param_specs`; an int8 tree cut by
`quant.quantize_specs`): its query and kv heads, hidden and expert
columns, and vocab rows. Its cache is [layers, B / dp, max_len,
H_kv / tp, D]. The row-parallel products (wo, w2, the experts' outputs)
and the embedding are reduced over tp, and tokens are picked over the
tp-sharded vocab without gathering the logits: the greedy pick takes the
max over tp, then the lowest index among the shards that hold it; the
top-k mask gathers each shard's k best (value, index) pairs. Each rank
draws its own sampling noise.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.flash_block import NEG_INF, blockwise_causal_attention
from ..parallel.collectives import gather, pmax, pmin, reduce
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
    _top_k,
    _tp,
    _tp_index,
    _tp_size,
    layer_params,
    n_layers_of,
    renormalized_topk,
    rms_norm,
    rotary,
    sorted_ragged_expert_ffn,
    unembed_logits,
)

# The mesh axes serving runs over; the others must be 1 (the reference's).
SERVING_AXES = ("dp", "tp")


def init_kv_cache(config: TransformerConfig, batch: int, max_len: int, device,
                  quantized_kv: bool = False, mesh=None) -> dict:
    """Zeroed K/V caches [layers, batch, max_len, H_kv / tp, D] in the
    compute dtype: `batch` the rows this rank serves (its dp rows), its tp
    share of the kv heads (the reference's cache split P(None, "dp", None,
    "tp", None)). With GQA the cache holds only the n_kv_heads heads.

    quantized_kv: each cache is a QuantizedTensor, int8 values with one
    f32 scale per [layer, batch, position, head] vector. Unwritten
    positions read as exactly 0 (q = 0, scale = 1)."""
    cfg = config
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads // _tp_size(mesh), cfg.head_dim)
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


def _layer_qkv(p, xn, base: int, cfg: TransformerConfig, mesh=None):
    """q/k/v for the tokens of xn at positions base..base+T-1, rotary
    applied, with this rank's heads (its tp share); k/v with the kv head
    count, as the cache stores them. The three products share xn: with
    int8 weights a decode step's are one kernel launch
    (`quant.matmul_group`)."""
    positions = base + torch.arange(xn.shape[1], dtype=torch.float32, device=xn.device)
    tp = _tp_size(mesh)
    q, k, v = (
        y.reshape(*y.shape[:-1], n_heads, cfg.head_dim)
        for y, n_heads in zip(matmul_group(xn, [p["wq"], p["wk"], p["wv"]], cfg.dtype),
                              (cfg.n_heads // tp, cfg.kv_heads // tp, cfg.kv_heads // tp))
    )
    q = rotary(q, positions, cfg.rope_theta)
    return q, rotary(k, positions, cfg.rope_theta), v


def _topk_gates(p, xn, cfg: TransformerConfig):
    """The top-k serving formulations' router: f32 softmax gates, the top-k
    pick and renormalized weights. Returns (top_w, top_i), each [B, T, k]."""
    return renormalized_topk(_router_gates(xn, p["wg"]), cfg.moe_top_k)


def _moe_mlp_topk_decode(p, xn, cfg: TransformerConfig, mesh=None):
    """Token-choice top-k, all experts on every token, weighted by the
    top-k gates (zero elsewhere): the decode step's formulation. Its time
    is every expert's weights streaming from memory either way; with int8
    weights each expert stack is one `int8_matmul` launch. Over tp each
    rank runs its expert columns, the outputs reduced over tp."""
    n = xn.shape[0] * xn.shape[1]
    top_w, top_i = _topk_gates(p, xn, cfg)
    # [B*T, E]: each token's k gate weights at its experts, 0 elsewhere (a
    # token's k experts are distinct, so a scatter sets what the
    # reference's one-hot sum adds to 0).
    weights = torch.zeros((n, cfg.n_experts), dtype=torch.float32, device=xn.device)
    weights.scatter_(-1, top_i.reshape(n, -1), top_w.reshape(n, -1))
    return _all_experts(p, xn, weights, cfg, mesh)


def _moe_mlp_topk_sorted(p, xn, cfg: TransformerConfig, mesh=None):
    """Token-choice top-k for the prefill: the sorted ragged dispatch at
    activated FLOPs (`transformer.sorted_ragged_expert_ffn`); int8 expert
    stacks are dequantized once for the grouped products. Over tp each
    rank runs its expert columns, the outputs reduced over tp."""
    b, t, d = xn.shape
    k = cfg.moe_top_k
    top_w, top_i = _topk_gates(p, xn, cfg)
    out, _ = sorted_ragged_expert_ffn(p, xn.reshape(b * t, d), top_w.reshape(b * t, k),
                                      top_i.reshape(b * t, k), cfg)
    return reduce(out.reshape(b, t, d).to(cfg.dtype), _tp(mesh))


def _decode_mlp(p, xn, cfg: TransformerConfig, mesh=None):
    """Serving's feed-forward: dense; top-k MoE, sorted ragged for the
    prefill (T > 1) and all experts for the decode step; soft dispatch for
    soft-dispatch models and for expert choice (not causal: served at its
    full-capacity limit, as the reference does). Each reduces its output
    over tp."""
    if "wg" not in p:
        return _dense_mlp(p, xn, cfg, mesh)
    if cfg.moe_router == "token" and cfg.moe_top_k > 0:
        if xn.shape[1] > 1:
            return _moe_mlp_topk_sorted(p, xn, cfg, mesh)
        return _moe_mlp_topk_decode(p, xn, cfg, mesh)
    return _moe_mlp(p, xn, cfg, mesh)


def _layer_tail(p, x, attn, cfg: TransformerConfig, mesh=None):
    """Output projection (row-parallel, reduced over tp) and MLP: attn
    [B, T, H / tp, D]."""
    compute = cfg.dtype
    attn = attn.reshape(*attn.shape[:-2], attn.shape[-2] * attn.shape[-1])
    x = x + reduce(matmul(attn, p["wo"], compute), _tp(mesh)).to(x.dtype)
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _decode_mlp(p, xn2, cfg, mesh).to(x.dtype)


def _decode_layer(p, x, cache_k, cache_v, pos: int, cfg: TransformerConfig, mesh=None):
    """One layer, one token: x [B, 1, d]; cache_k/v [B, T_max, H_kv / tp,
    D], written at `pos` in place. Returns x."""
    batch = x.shape[0]
    group = cfg.n_heads // cfg.kv_heads
    kv_heads, heads = cfg.kv_heads // _tp_size(mesh), cfg.n_heads // _tp_size(mesh)
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _layer_qkv(p, xn, pos, cfg, mesh)
    _cache_write(cache_k, k, pos)
    _cache_write(cache_v, v, pos)

    # GQA without a broadcast copy: q heads are grouped [n_kv, group] and
    # each group reads its kv head. Operands in the compute dtype, upcast
    # to f32 for the product; softmax statistics in f32.
    full_k = _cache_read(cache_k, cfg.dtype)
    full_v = _cache_read(cache_v, cfg.dtype)
    q5 = q.reshape(batch, 1, kv_heads, group, cfg.head_dim)
    logits = torch.einsum("bqngd,bknd->bngqk", q5.float(), full_k.float())
    logits = logits.reshape(batch, heads, 1, -1) * cfg.head_dim ** -0.5
    visible = torch.arange(logits.shape[-1], device=x.device) <= pos
    logits = torch.where(visible, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs5 = probs.reshape(batch, kv_heads, group, 1, -1)
    attn = torch.einsum(
        "bngqk,bknd->bqngd", probs5.to(full_v.dtype).float(), full_v.float()
    ).reshape(batch, 1, heads, cfg.head_dim)
    return _layer_tail(p, x, attn, cfg, mesh)


def _prefill_layer(p, x, cache_k, cache_v, cfg: TransformerConfig, mesh=None):
    """One layer over the whole prompt: x [B, Tp, d]. Writes K/V for
    positions 0..Tp-1 and folds attention blockwise over the flash step."""
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _layer_qkv(p, xn, 0, cfg, mesh)
    _cache_write(cache_k, k, 0)
    _cache_write(cache_v, v, 0)
    attn = blockwise_causal_attention(q, k, v)  # GQA broadcast inside
    return _layer_tail(p, x, attn, cfg, mesh)


def _run_stack(params, x, cache, cfg, layer_fn, mesh=None):
    """Run layer_fn over the layers (cache slices per layer), final-norm
    the last position and unembed it. Returns this rank's vocab shard of
    the logits [B, vocab / tp], f32."""
    for i in range(n_layers_of(params)):
        x = layer_fn(layer_params(params, i), x, cache["k"][i], cache["v"][i])
    xn = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return unembed_logits(params, xn, cfg, mesh)[:, 0].float()


def _prefill_logits(params, prompt, cache, cfg, mesh=None):
    """prompt [B, Tp] -> last-position logits [B, vocab / tp]; fills the
    cache."""
    x = _embed_tokens(params["embed"], prompt, cfg, mesh)
    return _run_stack(
        params, x, cache, cfg,
        lambda p, x, ck, cv: _prefill_layer(p, x, ck, cv, cfg, mesh), mesh,
    )


def _token_logits(params, token, cache, pos: int, cfg, mesh=None):
    """token [B] at position pos -> logits [B, vocab / tp]; writes the
    cache."""
    x = _embed_tokens(params["embed"], token[:, None], cfg, mesh)
    return _run_stack(
        params, x, cache, cfg,
        lambda p, x, ck, cv: _decode_layer(p, x, ck, cv, pos, cfg, mesh), mesh,
    )


def _global_argmax(logits, mesh=None):
    """Greedy pick over the vocab, sharded over tp: logits [B, V / tp] ->
    global token ids [B], the same on every tp rank. Each shard's max and
    its first index, the max of the values over tp, then the least global
    index among the shards that hold it (`collectives.pmin`), so the lowest index
    wins a tie, as torch.argmax returns the first maximum (at tp = 1, that
    argmax itself)."""
    group = _tp(mesh)
    if group is None:
        return torch.argmax(logits, dim=-1)
    local_val, local_idx = torch.max(logits, dim=-1)
    global_val = pmax(local_val, group)
    start = _tp_index(mesh) * logits.shape[-1]
    candidate = torch.where(local_val >= global_val, start + local_idx,
                            torch.iinfo(torch.int64).max)
    return pmin(candidate, group)


def _gumbel(generator, shape, device):
    """Standard Gumbel noise, f32: -log(-log(u)) with u uniform in
    [tiny, 1), as jax.random.gumbel draws it (other bits than JAX's). The
    one source of sampling noise, so a test can feed both packages the
    same numbers."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def _top_k_mask(logits, top_k: int, mesh=None):
    """Keep exactly the top_k largest logits of the vocab, sharded over tp
    (this rank's shard [B, V / tp]), ties broken by the lowest vocab index.
    Each shard's k best values and their global indices (a stable
    descending sort: lower indices first among equals) are gathered over
    tp in rank order, so among equal values the gathered order is the
    index order; a stable descending sort of those picks the k winners,
    and a logit tied with the k-th is kept only up to the highest index
    among the winners that share its value. Each rank masks its own shard.
    A top_k above the vocab keeps all."""
    group, v_local = _tp(mesh), logits.shape[-1]
    start = _tp_index(mesh) * v_local
    local_vals, local_idx = _top_k(logits, min(top_k, v_local))
    all_vals = gather(local_vals, -1, group)
    all_idx = gather(start + local_idx, -1, group)
    sel_vals, order = torch.sort(all_vals, dim=-1, descending=True, stable=True)
    k = min(top_k, all_vals.shape[-1])
    sel_vals, sel_idx = sel_vals[..., :k], all_idx.gather(-1, order[..., :k])
    thresh = sel_vals[..., -1:]
    idx_cut = torch.where(sel_vals == thresh, sel_idx, -1).amax(dim=-1, keepdim=True)
    idx = start + torch.arange(v_local, device=logits.device)
    return (logits > thresh) | ((logits == thresh) & (idx <= idx_cut))


def _pick_token(logits, generator=None, temperature: float = 0.0, top_k: int = 0, mesh=None):
    """Greedy (temperature 0) or sampled pick from this rank's vocab shard
    of the logits [B, V / tp] f32: global token ids [B], the same on every
    tp rank.

    Sampling is Gumbel-max: argmax(logits / T + G) is an exact draw from
    softmax(logits / T), and that argmax is the greedy path's pick over
    tp, so no logits are gathered; each rank adds its own noise to its
    shard (`generator` is the rank's). top_k > 0 restricts it to exactly
    the k largest logits (`_top_k_mask`), as the reference's `_pick_token`
    does."""
    if temperature <= 0.0:
        return _global_argmax(logits, mesh)
    # True division on the card too (see quant.quantize_int8), as on the CPU.
    z = logits.float() / torch.full((), temperature, device=logits.device)
    if top_k > 0:
        z = torch.where(_top_k_mask(logits, top_k, mesh), z, NEG_INF)
    return _global_argmax(z + _gumbel(generator, z.shape, z.device), mesh)


def rank_generator(generator, device, mesh=None):
    """The generator a rank draws its sampling noise from. At one rank (no
    mesh, or dp = tp = 1): the caller's generator, or a new one on the
    device seeded 0. Over dp or tp each rank needs noise of its own (tp
    ranks hold other vocab slices of the same rows, dp ranks other rows:
    alike noise would tie their draws), as the reference folds the dp and
    tp index into its key: a new generator on the device, seeded from one
    draw of the caller's generator (0 without one) and the rank's place
    on the (dp, tp) grid."""
    shards = 1 if mesh is None else mesh.size(SERVING_AXES)
    if shards == 1:
        return generator or torch.Generator(device=device).manual_seed(0)
    base = 0 if generator is None else int(torch.randint(
        0, 2 ** 62, (), generator=generator, device=generator.device))
    place = mesh.index("dp") * mesh.size("tp") + mesh.index("tp")
    # SplitMix64's increment spreads the places over the seeds (mod 2^63).
    return torch.Generator(device=device).manual_seed(
        (base + (place + 1) * 0x9E3779B97F4A7C15) % 2 ** 63)


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
                   quantized_kv: bool = False, mesh=None):
    """generate(params, prompt [B, Tp], generator=None) -> tokens
    [B, Tp + max_new_tokens], on `device` (the card unless the caller names
    another).

    temperature 0 decodes greedily; above 0 each token is drawn from
    softmax(logits / temperature), optionally over the top_k logits only
    (`_pick_token`). `generator` (a torch.Generator on the device) seeds
    the sampling; without one, a generator seeded with 0 is made on the
    device for each call (over a mesh, each rank's from it:
    `rank_generator`). Greedy decoding ignores it.

    quantized: the parameters came through `quantize_params_for_serving`
    (int8 matmul weights); parameters that do not match the flag raise.
    quantized_kv: the KV cache is int8, one scale per cached vector.

    mesh: a `parallel.mesh.Mesh` over dp and tp (None: one device); pp, sp
    or ep above 1 raises ValueError, as the reference's. Then params are
    this rank's shards (`convert.shard_params`) and the prompt its dp rows;
    generate returns those rows' tokens, the same on every tp rank.

    The prompt is prefilled in one batched pass, then new tokens decode
    through the cached step. max_new_tokens == 0 returns the prompt."""
    cfg = config
    if mesh is not None:
        for axis in ("pp", "sp", "ep"):
            if mesh.size(axis) != 1:
                raise ValueError(f"build_generate needs {axis}=1 (got {mesh.size(axis)}); "
                                 "use a dp/tp serving mesh")
    cfg.validate(mesh.config if mesh is not None else None)
    device = resolve_device(device)

    @torch.no_grad()
    def generate(params, prompt, generator=None):
        _check_quantized(params, quantized)
        prompt = prompt.to(device)
        if max_new_tokens == 0:
            return prompt
        if temperature > 0.0:
            generator = rank_generator(generator, device, mesh)

        def pick(logits):
            return _pick_token(logits, generator, temperature, top_k, mesh).to(prompt.dtype)

        params = cast_params(params, cfg.dtype)
        t_prompt = prompt.shape[1]
        cache = init_kv_cache(cfg, prompt.shape[0], t_prompt + max_new_tokens, device,
                              quantized_kv=quantized_kv, mesh=mesh)
        token = pick(_prefill_logits(params, prompt, cache, cfg, mesh))
        parts = [prompt, token[:, None]]
        for pos in range(t_prompt, t_prompt + max_new_tokens - 1):
            token = pick(_token_logits(params, token, cache, pos, cfg, mesh))
            parts.append(token[:, None])
        return torch.cat(parts, dim=1)

    return generate
