"""Flagship decoder-only transformer in PyTorch: the port of
`jobset_tpu/models/transformer.py`, dense or mixture-of-experts, on one
device or over a gang's mesh.

Parameters are a plain dict that keeps the JAX tree's names and stacked
`[pp, layers / pp, ...]` layer shapes, so a JAX param tree converts leaf for leaf
(`jobset_tpu_torch.convert.params_from_jax`). Compute runs in `cfg.dtype`
(bf16 by default) over f32 parameters, with f32 norm and softmax
statistics. Attention goes through `ring_attention` (or, with `attn_impl`
"ulysses", `ulysses_attention`): on one device one flash block step
(`ops.flash_block`) per layer. The GEMMs stay
`torch.matmul`, as the JAX package leaves them to XLA; every matmul site
goes through `quant.matmul`, so int8 serving weights (`QuantizedTensor`)
work here too.

Training (`build_train_step`, `build_eval_step`) is the JAX package's on
one device: the per-token cross-entropy with label smoothing and z-loss,
the MoE balancing aux loss, the time-chunked loss (`loss_chunk`),
per-layer rematerialization (`torch.utils.checkpoint`, policies "full"
and "dots"), gradient accumulation, and an optimizer from `runtime.optim`
applied as `(p + u).to(p.dtype)`.

Mixture-of-experts layers (`n_experts > 0`) run every router of the
reference: soft dispatch, token-choice top-k with a capacity
buffer or dropless (the experts' products over sorted ragged row
segments, `ops.grouped_matmul`), and expert choice. The router's product
is taken in f64 and rounded to f32 (`_router_logits`), so no TF32 setting
reaches it. Each layer returns its balancing statistics with its output;
the loss pools them into the aux loss (`_balancing_aux`), and the
forward and serving paths drop them. The grouped products differentiate
through `ops.grouped_matmul`'s autograd Function (hand kernels for the
backward on the card).

Over a gang (`mesh`, a `parallel.mesh.Mesh`) the train and eval steps
and the forward (`build_forward`) run dp, pp, ep, sp and tp, with the
reference's collectives (`parallel.collectives`): each rank holds its dp rows and its sp chunk of
positions of the batch and its tp shards of the parameters
(`param_specs`: heads, hidden and expert columns, and the vocab split
over tp, as Megatron's column and row parallel products); the
row-parallel outputs, the embedding and the loss's vocab sums are reduced
over tp ("reduce"), a replicated activation entering a sharded weight
carries the transpose psum ("copy"), attention spans the sp chunks (the
ring rotates K/V, Ulysses moves the split onto the heads; rotary
positions are global), the loss's token count and sum are pooled over
(dp, sp) and the MoE balancing statistics over (dp, sp, ep) before the
aux loss's product, and the gradients are summed over (dp, sp) once a
step, after accumulation, in one all-reduce (a tp- or ep-sharded leaf is
never reduced over its axis). Without a mesh, or at size 1, every
collective is the identity.

Expert parallelism (ep > 1) shards the experts: a rank holds its
E / ep experts' `we1` and `we2`, and the batch is replicated over ep.
Soft dispatch runs the rank's experts on every token and dropless its
experts' slots of every token (the others sorted into a trailing group no
weight covers, their combine weights zeroed), each summing the partial
outputs over (ep, tp); the capacity and expert-choice routers each take
their rank's chunk of the tokens, send every slot to the rank that holds
its expert (`all_to_all`), and gather the chunks' outputs back over ep.
Every value replicated over ep keeps its whole cotangent on every rank,
as over tp: where ranks see parts of it (an expert's share of the gates
and slot weights, a chunk of the tokens and the router that routes it,
dropless' statistics, which every rank counts whole and divides by ep)
the backward sums over ep (`copy`), so no leaf's gradient is summed over
ep after the step.

Pipeline parallelism (pp > 1, or more than one microbatch) splits the
layer stack over pp: a rank holds its stage's [1, n_layers / pp, ...]
slice of each layer leaf, and the microbatches run through the stages on
`parallel.pipeline.drive` under the configured schedule ("gpipe",
"interleaved" with `pipeline_virtual` chunks a rank, or "1f1b"). The
embedding runs on pp rank 0 and the loss head on the last; the loss's
sum and count reduce over (dp, sp, pp), the MoE statistics pool over a
rank's microbatches and then (dp, sp, ep) before each layer's product, and
the gradients of the layer leaves sum over (dp, sp), those of the
embedding, final norm and unembedding over (dp, sp, pp).
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
from ..ops.grouped_matmul import grouped_matmul
from ..parallel.collectives import all_reduce_, all_to_all, copy, gather, pmax, reduce
from ..parallel.mesh import DATA_AXES, EXPERT_AXES, LOSS_AXES, STATS_AXES, MeshConfig
from ..parallel.pipeline import drive, timetable
from ..parallel.ring_attention import ring_attention
from ..parallel.ulysses_attention import ulysses_attention
from .quant import QuantizedTensor, matmul, matmul_experts, weight_cast


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    # Grouped-query attention: K/V heads (0 = n_heads, i.e. MHA).
    n_kv_heads: int = 0
    d_ff: int = 2048
    n_layers: int = 8
    # MoE: 0 experts = dense MLP in every layer.
    n_experts: int = 0
    d_ff_expert: int = 512
    # 0 = soft dispatch (every expert on every token, gate-weighted);
    # k > 0 = token-choice top-k routing.
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    # Token-choice formulation: "capacity" (a static per-expert buffer,
    # overflow drops) or "dropless" (sorted ragged grouped products).
    moe_dispatch: str = "capacity"
    # "token" = token choice; "expert" = expert choice (each expert takes
    # its top-C tokens; moe_top_k ignored).
    moe_router: str = "token"
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # Logits = x @ embed^T instead of a separate unembedding.
    tie_embeddings: bool = False
    # Sequence-parallel attention over sp: "ring" rotates K/V around the
    # ring (any head count); "ulysses" re-splits the heads with two
    # all-to-alls (needs n_heads / (tp * sp) whole). Both are exact.
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
    # Pipeline microbatches (0 = the pp size).
    n_microbatches: int = 0
    max_seq_len: int = 2048
    moe_aux_coef: float = 0.01
    # "gpipe", "interleaved" (pipeline_virtual chunks a rank, the bubble
    # ~pipeline_virtual-fold smaller) or "1f1b" (at most 2 * (pp - r) - 1
    # microbatches in flight on rank r).
    pipeline_schedule: str = "gpipe"
    pipeline_virtual: int = 1  # chunks a rank (interleaved only)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def validate(self, mesh_shape: MeshConfig | Mapping[str, int] | None = None) -> None:
        """Reject what the port cannot run on the mesh (a MeshConfig or a
        payload's `mesh` mapping; None: one device): bad widths and MoE
        settings, widths that tp does not divide, experts that ep does not
        divide, Ulysses' head split and the pipeline's rules (the
        reference's rules)."""
        mc = MeshConfig.of(mesh_shape)
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide evenly into heads")
        if self.n_layers % mc.pp:
            raise ValueError(f"n_layers {self.n_layers} not divisible by pp {mc.pp}")
        if self.n_heads % mc.tp:
            raise ValueError(f"n_heads {self.n_heads} not divisible by tp {mc.tp}")
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads {self.kv_heads}"
            )
        if self.kv_heads % mc.tp:
            raise ValueError(f"n_kv_heads {self.kv_heads} not divisible by tp {mc.tp}")
        if self.d_ff % mc.tp or (self.n_experts and self.d_ff_expert % mc.tp):
            raise ValueError("feed-forward widths must be divisible by tp")
        if self.vocab_size % mc.tp:
            raise ValueError(f"vocab {self.vocab_size} not divisible by tp {mc.tp}")
        if self.n_experts % mc.ep:
            raise ValueError(f"n_experts {self.n_experts} must be divisible by ep {mc.ep}")
        if self.head_dim % 2 or self.head_dim > MAX_HEAD_DIM:
            raise ValueError(
                f"head_dim {self.head_dim} must be even (rotary) and at most "
                f"{MAX_HEAD_DIM} (the flash kernel)"
            )
        if self.n_experts < 0:
            raise ValueError(f"n_experts must be >= 0, got {self.n_experts}")
        if self.moe_router not in ("token", "expert"):
            raise ValueError(f"unknown moe_router {self.moe_router!r}")
        if self.moe_router == "expert" and not self.n_experts:
            raise ValueError("moe_router='expert' requires n_experts > 0")
        if self.moe_top_k and not self.n_experts:
            raise ValueError("moe_top_k requires n_experts > 0")
        if self.moe_dispatch not in ("capacity", "dropless"):
            raise ValueError(
                f"unknown moe_dispatch {self.moe_dispatch!r} (expected 'capacity' or 'dropless')"
            )
        if self.moe_dispatch == "dropless" and (self.moe_top_k == 0 or self.moe_router == "expert"):
            raise ValueError(
                "moe_dispatch='dropless' applies to token-choice top-k routing only "
                "(set moe_top_k > 0 and moe_router='token')"
            )
        if self.moe_top_k > self.n_experts > 0:
            raise ValueError(
                f"MoE routing: moe_top_k {self.moe_top_k} exceeds n_experts {self.n_experts}"
            )
        if self.attn_impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
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
            raise ValueError(
                f"unknown pipeline_schedule {self.pipeline_schedule!r} "
                "(expected 'gpipe', 'interleaved' or '1f1b')"
            )
        if self.pipeline_virtual < 1:
            raise ValueError("pipeline_virtual must be >= 1")
        if self.pipeline_schedule != "interleaved" and self.pipeline_virtual != 1:
            raise ValueError("pipeline_virtual > 1 requires 'interleaved'")
        if self.pipeline_schedule == "1f1b" and self.moe_top_k > 0 and self.moe_router == "token":
            raise ValueError(
                "pipeline_schedule='1f1b' does not support token-choice top-k routing "
                "(moe_top_k > 0): its balancing aux is normalized over the global batch, which "
                "a schedule that starts backwards before all forwards finish cannot see. "
                "Dense, soft-dispatch and expert-choice MoE models work (none carries a "
                "batch-global aux)."
            )
        if self.pipeline_schedule == "interleaved":
            lps = self.n_layers // max(mc.pp, 1)
            if lps % self.pipeline_virtual:
                raise ValueError(
                    f"layers per stage ({lps}) not divisible by "
                    f"pipeline_virtual ({self.pipeline_virtual})"
                )
        if self.attn_impl == "ulysses" and (self.n_heads // mc.tp) % mc.sp:
            raise ValueError(
                f"ulysses attention requires heads-per-tp-rank "
                f"({self.n_heads // mc.tp}) divisible by sp ({mc.sp})"
            )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_specs(config: TransformerConfig) -> dict:
    """The reference's `param_specs`: for each leaf, the mesh axis each of
    its dims is split over (None: replicated), as a tuple. Layer leaves are
    stacked [pp, layers, ...]; tensor dims split over tp, expert dims over
    ep."""
    specs = {
        "embed": ("tp", None),  # vocab-sharded
        "final_norm": (None,),
        "layers": {
            "ln1": ("pp", None, None),
            "ln2": ("pp", None, None),
            "wq": ("pp", None, None, "tp"),
            "wk": ("pp", None, None, "tp"),
            "wv": ("pp", None, None, "tp"),
            "wo": ("pp", None, "tp", None),
        },
    }
    if not config.tie_embeddings:
        specs["unembed"] = (None, "tp")
    if config.n_experts:
        specs["layers"].update({
            "wg": ("pp", None, None, None),
            "we1": ("pp", None, "ep", None, "tp"),
            "we2": ("pp", None, "ep", "tp", None),
        })
    else:
        specs["layers"].update({
            "w1": ("pp", None, None, "tp"),
            "w2": ("pp", None, "tp", None),
        })
    return specs


def local_shape(shape, spec, mesh_config: MeshConfig | None) -> tuple:
    """A leaf's shape on one rank: each dim divided by the size of the axis
    `spec` splits it over."""
    mc = mesh_config or MeshConfig()
    return tuple(n // (getattr(mc, axis) if axis else 1) for n, axis in zip(shape, spec))


def param_shapes(config: TransformerConfig, mesh_config: MeshConfig | None = None) -> dict:
    """The param tree's names, each with (shape, fan_in); fan_in None marks
    a norm scale (ones). Layer leaves are stacked [1, n_layers, ...]. With
    `mesh_config`, the shapes are one rank's shards (`param_specs`), its
    stage [1, n_layers / pp, ...]; fan_in stays the global one."""
    shapes = _global_param_shapes(config, mesh_config.pp if mesh_config else 1)
    if mesh_config is None:
        return shapes
    specs = param_specs(config)

    def walk(shape_tree, spec_tree):
        return {name: walk(v, spec_tree[name]) if isinstance(v, dict)
                else (local_shape(v[0], spec_tree[name], mesh_config), v[1])
                for name, v in shape_tree.items()}

    return walk(shapes, specs)


def global_shapes(config: TransformerConfig, mesh_config: MeshConfig | None = None) -> dict:
    """The param tree's global shapes (tuples), leaf for leaf, the layer
    leaves stacked [pp, n_layers / pp, ...] for `mesh_config`'s pp."""
    def walk(shape_tree):
        return {name: walk(v) if isinstance(v, dict) else tuple(v[0])
                for name, v in shape_tree.items()}

    return walk(_global_param_shapes(config, mesh_config.pp if mesh_config else 1))


def _global_param_shapes(config: TransformerConfig, pp: int = 1) -> dict:
    cfg = config
    d, h, dh, lps = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_layers // pp
    shapes = {
        "embed": ((cfg.vocab_size, d), d),
        "final_norm": ((d,), None),
        "layers": {
            "ln1": ((pp, lps, d), None),
            "ln2": ((pp, lps, d), None),
            "wq": ((pp, lps, d, h * dh), d),
            "wk": ((pp, lps, d, cfg.kv_heads * dh), d),
            "wv": ((pp, lps, d, cfg.kv_heads * dh), d),
            "wo": ((pp, lps, h * dh, d), h * dh),
        },
    }
    if cfg.n_experts:
        e, f = cfg.n_experts, cfg.d_ff_expert
        shapes["layers"].update({
            "wg": ((pp, lps, d, e), d),
            "we1": ((pp, lps, e, d, f), d),
            "we2": ((pp, lps, e, f, d), f),
        })
    else:
        shapes["layers"].update({
            "w1": ((pp, lps, d, cfg.d_ff), d),
            "w2": ((pp, lps, cfg.d_ff, d), cfg.d_ff),
        })
    if not cfg.tie_embeddings:
        shapes["unembed"] = ((d, cfg.vocab_size), d)
    return shapes


def init_params(config: TransformerConfig, generator: torch.Generator, device=None,
                mesh_config: MeshConfig | None = None) -> dict:
    """Random parameters: normal / sqrt(fan_in) for matrices, ones for norm
    scales, drawn on the generator's device and placed on `device`; the
    whole tree, its layer leaves stacked [pp, n_layers / pp, ...] for
    `mesh_config`'s pp (drawn in one order, so the numbers are pp = 1's,
    reshaped). The numbers differ from the JAX `init_params` for the same
    seed."""
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

    return walk(_global_param_shapes(cfg, mesh_config.pp if mesh_config else 1))


def layer_params(params: dict, i: int) -> dict:
    """Layer i's slice of the stacked [1, layers, ...] leaves (views): of a
    tree of one stage (pp = 1, or a rank's shard)."""
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


def _tp(mesh):
    """The tp group of `mesh` (None without a mesh or at tp = 1)."""
    return mesh.group("tp") if mesh is not None else None


def _tp_size(mesh) -> int:
    return mesh.size("tp") if mesh is not None else 1


def _tp_index(mesh) -> int:
    return mesh.index("tp") if mesh is not None else 0


def _sp(mesh):
    """The sp group of `mesh` (None without a mesh or at sp = 1)."""
    return mesh.group("sp") if mesh is not None else None


def _data(mesh):
    """The (dp, sp) group the batch is split over (None: one rank)."""
    return mesh.group(DATA_AXES) if mesh is not None else None


def _ep(mesh):
    """The ep group of `mesh` (None without a mesh or at ep = 1)."""
    return mesh.group("ep") if mesh is not None else None


def _ep_size(mesh) -> int:
    return mesh.size("ep") if mesh is not None else 1


def _ep_index(mesh) -> int:
    return mesh.index("ep") if mesh is not None else 0


def _experts(mesh):
    """The (ep, tp) group an MoE layer's partial outputs sum over."""
    return mesh.group(EXPERT_AXES) if mesh is not None else None


def _stats(mesh):
    """The (dp, sp, ep) group the balancing statistics pool over."""
    return mesh.group(STATS_AXES) if mesh is not None else None


def _pp_size(mesh) -> int:
    return mesh.size("pp") if mesh is not None else 1


def _embed_tokens(embed, tokens, cfg, mesh=None):
    """Vocab-sharded embedding: a masked gather of this rank's rows, then
    a reduce over tp. Ids outside the shard (or the vocab) give a zero row,
    as the JAX version's masked gather does."""
    v_local = embed.shape[0]
    local_ids = tokens - _tp_index(mesh) * v_local
    in_shard = (local_ids >= 0) & (local_ids < v_local)
    rows = embed[torch.where(in_shard, local_ids, 0)]
    return reduce(rows.to(cfg.dtype) * in_shard[..., None].to(cfg.dtype), _tp(mesh))


def _attention_inputs(p, x, cfg: TransformerConfig, mesh=None):
    """Pre-norm, the fused QKV GEMM (column-parallel over tp) and rotary at
    the chunk's global positions (sp index * T + arange(T)): x [B, T, d] ->
    q [B, T, H/tp, D] and k, v [B, T, H_kv/tp, D]."""
    batch, t, _ = x.shape
    compute = cfg.dtype
    start = mesh.index("sp") * t if mesh is not None else 0
    positions = start + torch.arange(t, dtype=torch.float32, device=x.device)
    xn = copy(rms_norm(x, p["ln1"], cfg.norm_eps), _tp(mesh))
    heads_local = cfg.n_heads // _tp_size(mesh)
    kv_heads_local = cfg.kv_heads // _tp_size(mesh)

    # Fused QKV: one [d, (h + 2*hkv)*dh] GEMM instead of three narrow ones
    # (int8 weights are joined as int8, each column keeping its scale).
    q_width = heads_local * cfg.head_dim
    kv_width = kv_heads_local * cfg.head_dim
    parts = [p["wq"], p["wk"], p["wv"]]
    if isinstance(parts[0], QuantizedTensor):
        w_qkv = QuantizedTensor.cat(parts)
    else:
        w_qkv = torch.cat([weight_cast(w, compute) for w in parts], dim=1)
    qkv = matmul(xn, w_qkv, compute)
    q, key, value = torch.split(qkv, [q_width, kv_width, kv_width], dim=-1)

    def heads(y, n_heads):
        return y.reshape(batch, t, n_heads, cfg.head_dim)

    q = rotary(heads(q, heads_local), positions, cfg.rope_theta)
    key = rotary(heads(key, kv_heads_local), positions, cfg.rope_theta)
    return q, key, heads(value, kv_heads_local)


def _dense_mlp(p, xn, cfg, mesh=None):
    """w1 column-parallel, w2 row-parallel, the output reduced over tp."""
    compute = cfg.dtype
    h = F.silu(matmul(copy(xn, _tp(mesh)), p["w1"], compute))
    return reduce(matmul(h, p["w2"], compute), _tp(mesh))


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------


def _router_logits(x, wg):
    """x [..., d] @ wg [d, E] as an f32 product, taken in f64 and rounded
    to f32: every f32 product is exact in f64, and no TF32 setting of the
    process reaches an f64 product (an f32 matmul on the card may run in
    TF32). No [..., d, E] temporary: the prefill routes 8192 tokens a
    layer at the flagship."""
    return (x.double() @ wg.double()).float()


def _router_gates(x, wg):
    """The reference's f32 routing distribution: softmax of the router
    logits over the experts, [..., E]."""
    return torch.softmax(_router_logits(x, wg), dim=-1)


def _top_k(values, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index first, as `lax.top_k` picks (`torch.topk` promises no order
    among equal values; a stable descending sort keeps the index order)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def renormalized_topk(gates, k: int):
    """Top-k gate pick and sum-renormalization, the routing weights of
    every token-choice formulation. gates [..., E] f32 -> (top_w, top_i),
    each [..., k]."""
    top_w, top_i = _top_k(gates, k)
    return top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9), top_i


def aux_stat_width(cfg: TransformerConfig) -> int:
    """Width of a layer's balancing statistics [2, width]: the expert count
    on the routed path, 1 (a zero placeholder) elsewhere."""
    return max(cfg.n_experts, 1)


def _zero_stats(cfg, device):
    return torch.zeros((2, aux_stat_width(cfg)), dtype=torch.float32, device=device)


def _expert_ffn(p, x, cfg):
    """Every expert's FFN: x [E or 1, R, d] (1: shared by all) -> [E, R, d]
    in the compute dtype."""
    compute = cfg.dtype
    return matmul_experts(F.silu(matmul_experts(x, p["we1"], compute)), p["we2"], compute)


def _all_experts(p, xn, weights, cfg, mesh=None):
    """Every expert of this rank on every token of xn [B, T, d], the
    outputs weighted by its experts' columns of weights [B*T, E] (f32,
    cast to the compute dtype) and summed; the ranks' partial sums are
    reduced over (ep, tp)."""
    b, t, d = xn.shape
    g = _experts(mesh)
    e_local = p["we1"].shape[0]
    start = _ep_index(mesh) * e_local
    y = _expert_ffn(p, copy(xn, g).reshape(1, b * t, d), cfg)  # [E / ep, n, d]
    mine = copy(weights, g)[:, start:start + e_local]
    out = torch.einsum("end,ne->nd", y, mine.to(cfg.dtype))
    return reduce(out, g).reshape(b, t, d)


def _moe_mlp(p, xn, cfg, mesh=None):
    """Soft dispatch: every expert on every token, gate-weighted (gates
    over all E experts; each ep rank runs its own)."""
    return _all_experts(p, xn, _router_gates(xn.reshape(-1, xn.shape[-1]), p["wg"]), cfg,
                        mesh)


class _SlotGather(torch.autograd.Function):
    """rows = src[index // k], for `index` a permutation of the n * k slots
    and `back` its inverse (k = 1: a permutation of src's rows), with a
    backward that gathers too: each source row's k slot gradients, found
    through `back`, added in f32 in slot order. No scatter, so two runs of
    the backward give the same bits (an accumulating `index_put_`, the
    backward of a plain gather, adds in no fixed order on the card)."""

    @staticmethod
    def forward(ctx, src, index, back, k):
        ctx.save_for_backward(back)
        ctx.k = k
        return src[index // k] if k > 1 else src[index]

    @staticmethod
    def backward(ctx, grad):
        (back,) = ctx.saved_tensors
        rows = grad[back]
        if ctx.k > 1:
            parts = rows.float().reshape(-1, ctx.k, grad.shape[-1])
            total = parts[:, 0]
            for j in range(1, ctx.k):
                total = total + parts[:, j]
            rows = total.to(grad.dtype)
        return rows, None, None, None


def sorted_ragged_expert_ffn(p, x_flat, top_w, top_i, cfg, local_experts=None):
    """The sorted ragged core of the dropless forward and the serving
    prefill.

    x_flat [n, d]; top_w/top_i [n, k]. Each token's k slots are sorted by
    expert (stable, as `jnp.argsort`), the experts' FFNs run as two grouped
    products over the contiguous segments (`ops.grouped_matmul`, the hand
    kernel on the card; the segment sizes stay on the device), and each
    token's k gate-weighted results are added in f32 in slot order,
    gathered through the inverse permutation, so two runs give the same
    bits (an `index_add_` on the card adds in no fixed order); the slot
    gathers' backward gathers as well (`_SlotGather`). Returns (out [n, d]
    f32, group_sizes int32 [E]).

    local_experts=(ep_idx, e_local): the expert-parallel form, p["we1"] and
    p["we2"] this rank's e_local experts. The sort key puts the slots of
    its experts first, by local expert, and every other slot in a trailing
    group e_local that no weight covers (the grouped products write zeros
    there); those slots' combine weights are zeroed, so `out` is this
    rank's experts' part, and group_sizes is [e_local]."""
    k = top_i.shape[-1]
    n, d = x_flat.shape
    compute = cfg.dtype
    expert_of = top_i.reshape(n * k)  # slot order: token-major
    weights = top_w.reshape(n * k)
    key, n_groups = expert_of, cfg.n_experts
    if local_experts is not None:
        ep_idx, n_groups = local_experts
        mine = expert_of // n_groups == ep_idx
        key = torch.where(mine, expert_of - ep_idx * n_groups, n_groups)
        weights = torch.where(mine, weights, 0.0)
    order = torch.argsort(key, stable=True)
    inverse = torch.empty_like(order).scatter_(0, order, torch.arange(n * k, device=order.device))
    # Counted on the device: a bincount on the card reads its length back.
    counts = torch.zeros(n_groups + 1, dtype=torch.int32, device=x_flat.device)
    counts.scatter_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    group_sizes = counts[:n_groups]
    xs = _SlotGather.apply(x_flat, order, inverse, k).to(compute)  # the slots' tokens, by expert
    h = F.silu(grouped_matmul(xs, weight_cast(p["we1"], compute), group_sizes))
    y = grouped_matmul(h, weight_cast(p["we2"], compute), group_sizes)
    parts = (_SlotGather.apply(y, inverse, order, 1).float()
             * weights.reshape(n * k, 1)).reshape(n, k, d)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out, group_sizes


def _moe_mlp_dropless(p, xn, cfg, mesh=None):
    """Dropless token-choice top-k: exact routed math through the sorted
    ragged products, no capacity and no drops; over tp each rank runs its
    d_ff_expert columns, over ep its experts' slots of every token (each
    rank routes the whole token set, replicated over ep), and the partial
    outputs are reduced over (ep, tp). Returns (out, stats [2, E]: choice
    counts and gate-probability sums). Over ep the statistics are the
    whole set's divided by ep, so that their pool over (dp, sp, ep) is the
    global batch's; their backward sums over ep, so that the router's
    gradient keeps the whole aux term on every rank."""
    b, t, d = xn.shape
    g, ep = _experts(mesh), _ep_size(mesh)
    x = xn.reshape(b * t, d)
    gates = _router_gates(x, p["wg"])
    top_w, top_i = renormalized_topk(gates, cfg.moe_top_k)
    local = (_ep_index(mesh), p["we1"].shape[0])
    out, _ = sorted_ragged_expert_ffn(p, copy(x, g), copy(top_w, g), top_i, cfg, local)
    chosen = top_i.reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int32, device=x.device)
    counts.scatter_add_(0, chosen, torch.ones_like(chosen, dtype=torch.int32))
    stats = copy(torch.stack([counts.float(), gates.sum(dim=0)]) / ep, _ep(mesh))
    return reduce(out.to(cfg.dtype), g).reshape(b, t, d), stats


def _route_prologue(p, xn, cfg, mesh=None):
    """The routers' head: this ep rank's chunk of the token set (replicated
    over ep; the ep-th part in rank order) and its f32 gates: (chunk
    [n / ep, d], gates [n / ep, E], n / ep). Over ep the tokens and the
    router enter with `copy`: each rank's cotangents reach its own chunk's
    part, and the backward sums them."""
    b, t, d = xn.shape
    n_tok, ep = b * t, _ep_size(mesh)
    if n_tok % ep:
        raise ValueError(f"routed MoE needs local tokens ({n_tok}) divisible by ep ({ep})")
    n_chunk, start = n_tok // ep, _ep_index(mesh) * (n_tok // ep)
    x = copy(xn.reshape(n_tok, d), _ep(mesh))[start:start + n_chunk]
    return x, _router_gates(x, copy(p["wg"], _ep(mesh))), n_chunk


def _dispatch_combine_experts(p, chunk, dispatch, combine, cfg, mesh=None):
    """Pack this ep rank's chunk into expert-major [E, C, d] slot buffers
    per `dispatch` [n, E, C], send each expert's slots to the rank that
    holds it (`all_to_all` over ep: [ep, E / ep, C, d]), run the experts'
    FFNs on [E / ep, ep * C, d] (their outputs reduced over tp), send the
    results back, weight them into token positions per `combine` [n, E, C],
    and gather the chunks over ep in rank order: the whole token set's
    [n * ep, d]. At ep = 1 the all-to-alls and the gather are identities."""
    compute = cfg.dtype
    g, ep, e_local = _tp(mesh), _ep_size(mesh), p["we1"].shape[0]
    capacity, d = dispatch.shape[-1], chunk.shape[-1]
    send = torch.einsum("nd,nec->ecd", chunk.to(compute), dispatch.to(compute))
    recv = all_to_all(send.reshape(ep, e_local, capacity, d), 0, 0, _ep(mesh))
    # recv[s, e] holds source rank s's slots for this rank's expert e.
    tokens = recv.transpose(0, 1).reshape(e_local, ep * capacity, d)
    y = reduce(_expert_ffn(p, copy(tokens, g), cfg), g)
    back = y.reshape(e_local, ep, capacity, d).transpose(0, 1)
    y = all_to_all(back, 0, 0, _ep(mesh)).reshape(ep * e_local, capacity, d)
    return gather(torch.einsum("ecd,nec->nd", y, combine.to(compute)), 0, _ep(mesh))


def _moe_mlp_routed(p, xn, cfg, mesh=None):
    """Token-choice top-k with a static per-expert capacity C (switch
    style): slot-major positions, so first choices win capacity over
    second ones; overflow drops. Over ep each rank routes its chunk of the
    tokens (the capacity is the chunk's). Returns (out, stats [2, E]: the
    chunk's)."""
    num_experts, k = cfg.n_experts, cfg.moe_top_k
    b, t, d = xn.shape
    chunk, gates, n = _route_prologue(p, xn, cfg, mesh)
    top_w, top_i = renormalized_topk(gates, k)
    choice = F.one_hot(top_i, num_experts).float()  # [n, k, E]
    stats = torch.stack([choice.sum(dim=(0, 1)), gates.sum(dim=0)])
    capacity = max(1, math.ceil(k * n / num_experts * cfg.moe_capacity_factor))
    flat = choice.transpose(0, 1).reshape(k * n, num_experts)
    pos = torch.cumsum(flat, dim=0) - flat  # [k*n, E]
    kept = flat * (pos < capacity)
    # A position past the capacity has no slot (the reference's one_hot
    # row of zeros); `kept` is 0 there, so the clamped slot never counts.
    slot = F.one_hot(pos.long().clamp(max=capacity - 1), capacity).float()
    dispatch = (kept[..., None] * slot).reshape(k, n, num_experts, capacity)
    combine = (dispatch * top_w.T[..., None, None]).sum(dim=0)
    out = _dispatch_combine_experts(p, chunk, dispatch.sum(dim=0), combine, cfg, mesh)
    return out.reshape(b, t, d), stats


def _moe_mlp_expert_choice(p, xn, cfg, mesh=None):
    """Expert choice: each expert takes its top-C tokens by gate score
    (ties to the lower token index) among this ep rank's chunk, so the
    routing depends on ep, as the reference's does. Balanced by
    construction; no balancing statistics (zeros)."""
    num_experts = cfg.n_experts
    b, t, d = xn.shape
    chunk, gates, n = _route_prologue(p, xn, cfg, mesh)
    capacity = min(n, max(1, math.ceil(n / num_experts * cfg.moe_capacity_factor)))
    top_w, top_i = _top_k(gates.T, capacity)  # [E, C]
    dispatch = F.one_hot(top_i, n).float().permute(2, 0, 1)  # [n, E, C]
    out = _dispatch_combine_experts(p, chunk, dispatch, dispatch * top_w[None], cfg, mesh)
    return out.reshape(b, t, d), _zero_stats(cfg, xn.device)


def _mlp(p, xn, cfg, mesh=None):
    """The layer's feed-forward: (out [B, T, d] in the compute dtype, stats
    [2, aux_stat_width]), the routed paths' balancing statistics (zeros on
    the dense and soft-dispatch paths)."""
    if "wg" not in p:
        return _dense_mlp(p, xn, cfg, mesh), _zero_stats(cfg, xn.device)
    if cfg.moe_router == "expert":
        return _moe_mlp_expert_choice(p, xn, cfg, mesh)
    if cfg.moe_top_k > 0:
        if cfg.moe_dispatch == "dropless":
            return _moe_mlp_dropless(p, xn, cfg, mesh)
        return _moe_mlp_routed(p, xn, cfg, mesh)
    return _moe_mlp(p, xn, cfg, mesh), _zero_stats(cfg, xn.device)


def _layer_out(p, x, attn, cfg: TransformerConfig, mesh=None):
    """The output projection of attn [B, T, H/tp, D] (row-parallel, reduced
    over tp) onto the residual x, then the MLP on the residual: (x, the
    MLP's balancing statistics [2, aux_stat_width])."""
    batch, t, heads, dim = attn.shape
    out = reduce(matmul(attn.reshape(batch, t, heads * dim), p["wo"], cfg.dtype), _tp(mesh))
    x = x + out.to(x.dtype)
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    out, stats = _mlp(p, xn, cfg, mesh)
    return x + out.to(x.dtype), stats


def _attend(q, k, v, cfg: TransformerConfig, mesh=None):
    """Causal attention over the sp chunks: the ring, or Ulysses, which
    broadcasts K/V to q's heads first where sp does not divide the kv heads
    (so that each rank's q heads keep their kv heads)."""
    if cfg.attn_impl == "ulysses":
        if k.shape[2] % (mesh.size("sp") if mesh is not None else 1):
            k, v = (x.repeat_interleave(q.shape[2] // k.shape[2], dim=2) for x in (k, v))
        return ulysses_attention(q, k, v, _sp(mesh), causal=True)
    return ring_attention(q, k, v, _sp(mesh), causal=True)


def _layer(p, x, cfg: TransformerConfig, mesh=None):
    """One layer: attention block, then the MLP on the residual. Returns
    (x, stats), as the reference's `_layer`."""
    attn = _attend(*_attention_inputs(p, x, cfg, mesh), cfg, mesh)
    return _layer_out(p, x, attn, cfg, mesh)


# The GEMMs whose outputs remat_policy="dots" saves (`x @ w` reaches aten
# as mm; the attention products are bmm).
_SAVED_BY_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default]


def _remat_layer(p, x, cfg: TransformerConfig, mesh=None):
    """`_layer` under the configured rematerialization while gradients are
    recorded. "full" checkpoints the whole layer, so the backward runs its
    forward again, attention kernel included. "dots" keeps the attention
    call outside any checkpoint (its output and the saved q, k, v stay;
    selective checkpointing sees aten ops, not the attention's autograd
    Function) and checkpoints the pieces before and after it, saving their
    GEMM outputs and recomputing norms, rotary and silu. The grouped expert
    products are no GEMM there (`ragged_dot_general` is not a `dot_general`
    to the reference's `checkpoint_dots` either): their autograd Function
    runs again in the backward, as the reference recomputes them. Returns
    (x, stats). Over tp the recomputed forward runs its collectives
    again: the same values, at the cost of their traffic."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return _layer(p, x, cfg, mesh)
    if cfg.remat_policy == "full":
        return checkpoint(_layer, p, x, cfg, mesh, use_reentrant=False)
    dots = partial(create_selective_checkpoint_contexts, _SAVED_BY_DOTS)
    q, k, v = checkpoint(_attention_inputs, p, x, cfg, mesh, use_reentrant=False,
                         context_fn=dots)
    attn = _attend(q, k, v, cfg, mesh)
    return checkpoint(_layer_out, p, x, attn, cfg, mesh, use_reentrant=False, context_fn=dots)


def unembed_logits(params, xn, cfg, mesh=None):
    """This rank's vocab shard of the logits from final hidden states: the
    unembedding matrix, or the transposed embedding when tied."""
    xn = copy(xn, _tp(mesh))
    if cfg.tie_embeddings:
        return xn.to(cfg.dtype) @ params["embed"].to(cfg.dtype).T
    return matmul(xn, params["unembed"], cfg.dtype)


def _layer_views(params: dict) -> list:
    """Per-layer views of the stacked leaves, cut with one unbind per leaf
    so that the backward stacks each leaf's gradient once."""
    stacked = {name: a[0].unbind(0) for name, a in params["layers"].items()}
    return [{name: s[i] for name, s in stacked.items()} for i in range(n_layers_of(params))]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _softmax_xent(logits, targets, cfg: TransformerConfig, mesh=None):
    """Per-token cross-entropy [B, T] from this rank's vocab shard of the
    logits [B, T, V/tp], in f32 (the reference's `_sharded_softmax_xent`),
    with label smoothing eps (target (1-eps)*one_hot + eps/V: the loss is
    lse - (1-eps)*tgt - eps*mean_v(logits)) and z-loss (+ coef * lse^2).
    The max shift is a constant of the log-sum-exp (detached, pmax over
    tp). The target logit is gathered from the shard that holds it; an id
    outside the vocab contributes 0. The shards' exp sums, target logits
    and (with smoothing) logit sums are reduced over tp in one all-reduce."""
    g = _tp(mesh)
    logits = logits.float()
    v_local = logits.shape[-1]
    row_max = pmax(logits.detach().amax(dim=-1), g)
    sumexp = torch.exp(logits - row_max[..., None]).sum(dim=-1)
    local_ids = targets - _tp_index(mesh) * v_local
    in_shard = (local_ids >= 0) & (local_ids < v_local)
    ids = torch.where(in_shard, local_ids, 0).long()
    tgt = logits.gather(-1, ids[..., None])[..., 0] * in_shard
    eps = cfg.label_smoothing
    if g is not None:
        parts = reduce(torch.stack([sumexp, tgt] + ([logits.sum(dim=-1)] if eps else [])), g)
        sumexp, tgt, vocab_sum = parts[0], parts[1], parts[2] if eps else None
    elif eps:
        vocab_sum = logits.sum(dim=-1)
    lse = torch.log(sumexp) + row_max
    if eps:
        tgt = (1.0 - eps) * tgt + eps * (vocab_sum / cfg.vocab_size)
    loss = lse - tgt
    if cfg.z_loss_coef:
        loss = loss + cfg.z_loss_coef * torch.square(lse)
    return loss


def _token_ce(params, xn, targets, cfg: TransformerConfig, mesh=None):
    """Per-token cross-entropy [B, T] from final hidden states, honoring
    `loss_chunk`: time chunks run under checkpoint, so only [B, chunk, V]
    logits are resident, each recomputed on the backward (exact: the loss
    is a per-token sum). The chunk must divide T; at or above T it is off."""
    t = xn.shape[1]

    def token_losses(xn_c, targets_c):
        return _softmax_xent(unembed_logits(params, xn_c, cfg, mesh), targets_c, cfg, mesh)

    chunk = cfg.loss_chunk
    if not chunk or chunk >= t:
        return token_losses(xn, targets)
    if t % chunk:
        raise ValueError(f"loss_chunk {chunk} must divide the local sequence length {t}")
    run = (partial(checkpoint, token_losses, use_reentrant=False)
           if torch.is_grad_enabled() else token_losses)
    return torch.cat([run(xn[:, i:i + chunk], targets[:, i:i + chunk])
                      for i in range(0, t, chunk)], dim=1)


def _balancing_aux(stats, cfg: TransformerConfig):
    """The GShard balancing loss from the layers' statistics [layers, 2, E]
    (choice counts, gate-probability sums, pooled over the mesh), as the
    reference's `_local_loss_fn` forms it: each layer's E * sum_e
    f_e * P_e (f_e the share of routing choices that picked expert e, P_e
    its mean gate probability), averaged over the layers."""
    choices, probs = stats[:, 0], stats[:, 1]
    total = torch.clamp(choices.sum(dim=-1, keepdim=True), min=1e-9)
    frac = choices / total
    pbar = probs / torch.clamp(total / cfg.moe_top_k, min=1e-9)
    return (cfg.n_experts * frac * pbar).sum() / cfg.n_layers


def _local_loss(params, inputs, targets, mask, cfg: TransformerConfig, mesh=None):
    """(loss_sum, token_count, aux) of the global batch, from this rank's
    rows and positions: the sum and the count are reduced over (dp, sp),
    and the MoE balancing statistics over (dp, sp, ep) before the aux
    loss's nonlinear product (each rank then adds the global aux once; the
    (dp, sp) sum of the gradients makes its gradient exact). aux is 0
    unless routing is token-choice top-k (the reference's condition,
    moe_top_k > 0)."""
    data = _data(mesh)
    x = _embed_tokens(params["embed"], inputs, cfg, mesh)
    stats = []
    for p in _layer_views(params):
        x, layer_stats = _remat_layer(p, x, cfg, mesh)
        stats.append(layer_stats)
    xn = rms_norm(x, params["final_norm"], cfg.norm_eps)
    per_token = _token_ce(params, xn, targets, cfg, mesh)
    aux = (_balancing_aux(reduce(torch.stack(stats), _stats(mesh)), cfg) if cfg.moe_top_k > 0
           else per_token.new_zeros(()))
    loss_sum, count = (per_token * mask).sum(), mask.sum()
    if data is not None:
        loss_sum, count = reduce(torch.stack([loss_sum, count]), data).unbind()
    return loss_sum, count, aux


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------


def _n_micro(cfg: TransformerConfig, mesh) -> int:
    """The microbatches of a step: `n_microbatches`, or the pp size."""
    return cfg.n_microbatches or _pp_size(mesh)


def _pipelined(cfg: TransformerConfig, mesh) -> bool:
    """Whether a step runs on the pipeline loop (`drive`): over pp stages or in
    several microbatches. One stage and one microbatch is `_local_loss`'s
    single pass (`drive`'s one F and one B)."""
    return _pp_size(mesh) > 1 or _n_micro(cfg, mesh) > 1


def _stage(slots: list, x, cfg: TransformerConfig, mesh=None):
    """One chunk of a stage: its layers (`slots`, each a layer's parameter
    dict) in order on microbatch x, under the configured remat. Returns (y,
    per-layer stats [len(slots), 2, aux_stat_width])."""
    stats = []
    for p in slots:
        x, layer_stats = _remat_layer(p, x, cfg, mesh)
        stats.append(layer_stats)
    return x, torch.stack(stats)


class _Pipeline:
    """A step's pieces on this rank: the timetable, the parameters as
    detached leaves that require grad under training (`live`, and `slots`,
    one dict a layer of this rank's stage, so that every B event adds into
    its slots' gradients), the microbatches of the batch, the token count
    over (dp, sp), and the loss head."""

    def __init__(self, params, inputs, targets, mask, cfg: TransformerConfig, mesh, train: bool):
        self.cfg, self.mesh = cfg, mesh
        n_micro = _n_micro(cfg, mesh)
        b_local = inputs.shape[0]
        if b_local % n_micro:
            raise ValueError(
                f"per-device batch {b_local} must be divisible by n_microbatches {n_micro} "
                f"(global batch % (dp * n_microbatches) == 0)")
        self.n_micro, self.mb = n_micro, b_local // n_micro
        self.pp = _pp_size(mesh)
        self.rank = mesh.index("pp") if mesh is not None else 0
        self.group = mesh.group("pp") if mesh is not None else None
        self.table = timetable(cfg.pipeline_schedule, n_micro, self.pp, cfg.pipeline_virtual)
        self.live = {k: v.detach().requires_grad_(train) for k, v in params.items()
                     if k != "layers"}
        lps = n_layers_of(params)
        self.slots = [{name: a[0, i].detach().requires_grad_(train)
                       for name, a in params["layers"].items()} for i in range(lps)]
        self.lpc = lps // self.table.n_virtual
        self.targets, self.mask = targets, mask
        count = mask.sum()
        self.count = reduce(count, _data(mesh)) if mesh is not None else count
        self.like = torch.empty((self.mb, inputs.shape[1], cfg.d_model), dtype=cfg.dtype,
                                device=inputs.device)
        # The embedding runs on the first stage only (its tp reduce among
        # the first stage's tp peers).
        self.x = (_embed_tokens(self.live["embed"], inputs, cfg, mesh)
                  if self.rank == 0 else None)

    def stage(self, b, c, x):
        return _stage(self.slots[c * self.lpc:(c + 1) * self.lpc], x, self.cfg, self.mesh)

    def feed(self, b):
        return self.x.detach()[self.rows(b)]

    def head_sum(self, y, rows: slice):
        """The masked per-token cross-entropy summed over `rows` of this
        rank's batch, from the last stage's output y."""
        xn = rms_norm(y, self.live["final_norm"], self.cfg.norm_eps)
        per_token = _token_ce(self.live, xn, self.targets[rows], self.cfg, self.mesh)
        return (per_token * self.mask[rows]).sum()

    def rows(self, b) -> slice:
        return slice(b * self.mb, (b + 1) * self.mb)

    def outputs_sum(self, outputs: dict):
        """head_sum over the whole batch from the last stage's outputs by
        microbatch (0 on a rank that holds none)."""
        if not outputs:
            return self.like.new_zeros((), dtype=torch.float32)
        y = torch.cat([outputs[b] for b in range(self.n_micro)])
        return self.head_sum(y, slice(None))


def _pipeline_loss_and_grads(params, inputs, targets, mask, cfg: TransformerConfig, mesh=None):
    """(loss, gradient tree) of one pass over the pipeline, the gradients
    this rank's, before any reduction: the layer slots' in its stage's
    leaves, the embedding's on the first stage, the head's on the last.
    The loss is the global batch's on every rank."""
    pipe = _Pipeline(params, inputs, targets, mask, cfg, mesh, train=True)
    scale = 1.0 / torch.clamp(pipe.count, min=1.0)
    values = {"sum": pipe.like.new_zeros((), dtype=torch.float32),
              "aux": pipe.like.new_zeros((), dtype=torch.float32)}

    def finish(outputs, extras):
        """gpipe, interleaved: the last stage's loss head over every
        microbatch, and each rank's layers' aux term from the pooled
        statistics of its units, pooled again over (dp, sp, ep)."""
        loss_sum = pipe.outputs_sum(outputs)
        values["sum"] = loss_sum.detach()
        objective = loss_sum * scale if outputs else None
        if cfg.moe_top_k > 0:
            width = aux_stat_width(cfg)
            per_slot = [pipe.like.new_zeros((2, width), dtype=torch.float32)
                        for _ in pipe.slots]
            for (b, c), stats in sorted(extras.items()):
                for i in range(pipe.lpc):
                    per_slot[c * pipe.lpc + i] = per_slot[c * pipe.lpc + i] + stats[i]
            aux = _balancing_aux(reduce(torch.stack(per_slot), _stats(mesh)), cfg)
            values["aux"] = aux.detach()
            term = cfg.moe_aux_coef * aux
            objective = term if objective is None else objective + term
        return objective

    def head(b, y):
        """1f1b: microbatch b's loss head on the last stage, the global 1 /
        token count folded in."""
        return pipe.head_sum(y, pipe.rows(b)) * scale

    result = drive(pipe.table, pipe.rank, pipe.group, pipe.stage, pipe.feed, pipe.like,
                   finish=finish, head=head)
    if pipe.x is not None:
        torch.autograd.backward(pipe.x, torch.cat([result.feed_grads[b]
                                                   for b in range(pipe.n_micro)]))
    loss_group = mesh.group(LOSS_AXES) if mesh is not None else None
    if pipe.table.fused:
        loss = reduce(sum(result.head_values, values["sum"]), loss_group)
    else:
        loss = reduce(values["sum"], loss_group) * scale
        if cfg.moe_top_k > 0:
            loss = loss + cfg.moe_aux_coef * reduce(values["aux"], pipe.group)

    def grad(t):
        return t.grad if t.grad is not None else torch.zeros_like(t)

    grads = {k: grad(v) for k, v in pipe.live.items()}
    grads["layers"] = {name: torch.stack([grad(s[name]) for s in pipe.slots]).unsqueeze(0)
                       for name in params["layers"]}
    return loss.detach(), grads


def _pipeline_eval_sum(params, inputs, targets, mask, cfg: TransformerConfig, mesh=None):
    """(loss sum, token count) of the global batch: the schedule's F events
    alone (1f1b's are gpipe's), the loss head on the last stage."""
    pipe = _Pipeline(params, inputs, targets, mask, cfg, mesh, train=False)
    result = drive(pipe.table, pipe.rank, pipe.group, pipe.stage, pipe.feed, pipe.like,
                   train=False)
    loss_sum = pipe.outputs_sum(result.outputs)
    return reduce(loss_sum, mesh.group(LOSS_AXES) if mesh is not None else None), pipe.count


def _all_reduce_grads(grads: dict, mesh) -> None:
    """Sum a step's gradients in place: the layer leaves over (dp, sp), the
    others over (dp, sp, pp); one all-reduce a group (one in all at pp =
    1). Never over tp or ep: a leaf replicated over them has its whole
    gradient on every rank (the `copy` transposes sum its partial parts),
    one sharded over them its own shard's."""
    if mesh is None:
        return
    if mesh.size("pp") == 1:
        all_reduce_(tree.leaves(grads), mesh.group(DATA_AXES))
        return
    all_reduce_(tree.leaves(grads["layers"]), mesh.group(DATA_AXES))
    all_reduce_([g for k, g in sorted(grads.items()) if k != "layers"],
                mesh.group(LOSS_AXES))


def _batch_on(batch: dict, device):
    """(inputs, targets, mask) on `device`; the mask defaults to ones, f32."""
    inputs = torch.as_tensor(batch["inputs"]).to(device, non_blocking=True)
    targets = torch.as_tensor(batch["targets"]).to(device, non_blocking=True)
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32, device=device) if mask is None
            else torch.as_tensor(mask).to(device, torch.float32, non_blocking=True))
    return inputs, targets, mask


def build_train_step(config: TransformerConfig, optimizer, accum_steps: int = 1, device=None,
                     mesh=None):
    """train_step(params, opt_state, batch) -> (params, opt_state, loss) on
    `device` (the card unless the caller names another). The loss is
    ce / max(token count, 1) (+ moe_aux_coef * aux); `optimizer` is a
    `runtime.optim.Optimizer` (init/update over param trees).

    mesh: a `parallel.mesh.Mesh` (None: one device). Then params are this
    rank's shards (`param_shapes(cfg, mesh.config)`: its tp and ep shards
    of its pp stage), the batch is its dp rows and its sp chunk of
    positions (the same on every ep, tp and pp rank), and
    the loss is the global batch's on every rank; the gradients are summed
    over (dp, sp), and those outside the layers over pp as well, once,
    after accumulation. Over pp stages, or with more than one microbatch
    (`n_microbatches`, default the pp size), each pass runs on the
    pipeline loop (`parallel.pipeline.drive`) under `pipeline_schedule`.

    accum_steps: the batch splits into that many equal chunks along its
    first axis, run in sequence; their losses and gradients are averaged
    before one update. The step returns new tensors and leaves its
    arguments as they were."""
    cfg = config
    cfg.validate(mesh.config if mesh is not None else None)
    device = resolve_device(device)

    def loss_and_grads(params, inputs, targets, mask):
        if _pipelined(cfg, mesh):
            loss, grads = _pipeline_loss_and_grads(params, inputs, targets, mask, cfg, mesh)
            return loss, tree.leaves(grads)
        live = tree.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss_sum, count, aux = _local_loss(live, inputs, targets, mask, cfg, mesh)
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
        grads = tree.rebuild(params, grads)
        _all_reduce_grads(grads, mesh)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return tree.apply_updates(params, updates), opt_state, loss

    return train_step


def build_eval_step(config: TransformerConfig, device=None, mesh=None):
    """eval_step(params, batch) -> mean per-token cross-entropy (a 0-dim f32
    tensor): the loss half of `build_train_step`, without gradients, over
    `mesh` as the train step (over pp, the schedule's forward events: 1f1b
    evaluates on gpipe's wavefront, as the reference does). Label
    smoothing and z-loss are off, so exp(loss) stays a perplexity."""
    cfg = replace(config, label_smoothing=0.0, z_loss_coef=0.0)
    cfg.validate(mesh.config if mesh is not None else None)
    device = resolve_device(device)

    @torch.no_grad()
    def eval_step(params, batch):
        if _pipelined(cfg, mesh):
            loss_sum, count = _pipeline_eval_sum(params, *_batch_on(batch, device), cfg, mesh)
        else:
            loss_sum, count, _ = _local_loss(params, *_batch_on(batch, device), cfg, mesh)
        return loss_sum / torch.clamp(count, min=1.0)

    return eval_step


def _forward_pipelined(params, tokens, mb_count: int, cfg: TransformerConfig, mesh):
    """The forward's layers over pp stages: the embedding on pp rank 0,
    the schedule's F events (1f1b's are gpipe's) on
    `parallel.pipeline.drive` in mb_count microbatches, and the last
    stage's outputs broadcast over pp (the reference's psum of
    where(is_last, out, 0)). Returns [B, T, d] on every rank."""
    rank, group = mesh.index("pp"), mesh.group("pp")
    table = timetable(cfg.pipeline_schedule, mb_count, mesh.size("pp"), cfg.pipeline_virtual)
    slots = [layer_params(params, i) for i in range(n_layers_of(params))]
    lpc = len(slots) // table.n_virtual
    b, t = tokens.shape
    mb = b // mb_count
    x = _embed_tokens(params["embed"], tokens, cfg, mesh) if rank == 0 else None
    like = torch.empty((mb, t, cfg.d_model), dtype=cfg.dtype, device=tokens.device)
    result = drive(table, rank, group,
                   lambda _, c, h: _stage(slots[c * lpc:(c + 1) * lpc], h, cfg, mesh),
                   lambda i: x[i * mb:(i + 1) * mb], like, train=False)
    out = (torch.cat([result.outputs[i] for i in range(mb_count)]) if result.outputs
           else like.new_zeros((b, t, cfg.d_model)))
    return reduce(out, group)


def build_forward(config: TransformerConfig, device=None, mesh=None):
    """forward(params, tokens [B, T]) -> logits [B, T, vocab] in the compute
    dtype, on `device` (the card unless the caller names another). The
    batch runs in the largest count of equal microbatches at most
    `n_microbatches` (over pp: default the pp size) that divides it, as
    the reference's forward cuts it (MoE routing sees a microbatch's
    tokens); the MoE statistics are dropped.

    mesh: a `parallel.mesh.Mesh` (None: one device), any axis. Then params
    are this rank's shards (`convert.shard_params`), tokens its dp rows
    and sp chunk of positions, and forward returns its block of the global
    logits, [B / dp, T / sp, vocab / tp] (the reference's out_spec
    P("dp", "sp", "tp")): the layers run as in training (sp through the
    ring or Ulysses, ep through every router), over pp the schedule's F
    events on the pipeline loop, the last stage's output broadcast over
    pp, and every rank unembeds its vocab shard."""
    cfg = config
    cfg.validate(mesh.config if mesh is not None else None)
    device = resolve_device(device)

    @torch.no_grad()
    def forward(params, tokens):
        tokens = tokens.to(device)
        b = tokens.shape[0]
        count = next(m for m in range(min(_n_micro(cfg, mesh), b), 0, -1) if b % m == 0)
        if _pp_size(mesh) > 1:
            x = _forward_pipelined(params, tokens, count, cfg, mesh)
        else:
            outs = []
            for part in tokens.chunk(count):
                x = _embed_tokens(params["embed"], part, cfg, mesh)
                for i in range(n_layers_of(params)):
                    x = _layer(layer_params(params, i), x, cfg, mesh)[0]
                outs.append(x)
            x = outs[0] if count == 1 else torch.cat(outs)
        xn = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return unembed_logits(params, xn, cfg, mesh)

    return forward
