"""Single-device model benchmarks: step time, tokens/s and MFU of the
flagship transformer's train step (the method of
`jobset_tpu/runtime/model_bench.py::run_model_bench`), and the serving
path's decode throughput and time to first token (`run_decode_bench`).

* The flagship config with remat off, adam at lr 1e-3, one fixed batch of
  random tokens, `warmup` untimed steps, then `steps` timed ones. Each step
  ends with `torch.cuda.synchronize()` on the card, and its time is the
  host clock around it.
* FLOPs per token are the standard training estimate (PaLM appendix B):
  6 per matmul parameter (forward and backward) plus the causal attention
  score and context products, 12 * L * T * d halved. The embedding lookup
  is not counted; the vocab projection is, through its parameters. An MoE
  model counts its router and every expert; token-choice top-k is
  credited at activated FLOPs (a token touches its k experts), as the
  reference counts it.
* MFU is achieved FLOP/s over the card's peak dense bf16 rate from a table
  keyed on `torch.cuda.get_device_name()`; an unlisted card gives
  mfu_pct None (set BENCH_PEAK_TFLOPS to name a peak).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Optional

import torch

from ..device import resolve_device
from ..models import transformer
from . import optim
from .runner import profiled

# Peak dense bf16 tensor-core FLOP/s (NVIDIA data sheets), matched as
# lowercase substrings of the device name; "NVIDIA H100 80GB HBM3" is the
# SXM part.
PEAK_BF16_FLOPS = {
    "h100 80gb hbm3": 989e12,
    "h100 sxm": 989e12,
}


def peak_flops_for(device_name: str) -> Optional[float]:
    override = os.environ.get("BENCH_PEAK_TFLOPS")
    if override:
        try:
            return float(override) * 1e12
        except ValueError:
            pass
    name = device_name.lower()
    for key in sorted(PEAK_BF16_FLOPS, key=len, reverse=True):
        if key in name:
            return PEAK_BF16_FLOPS[key]
    return None


def expert_ffn_params(cfg) -> int:
    """Matmul parameters of one expert's FFN (both the total count and the
    activated-FLOPs rule use it)."""
    return 2 * cfg.d_model * cfg.d_ff_expert


def matmul_param_count(cfg) -> int:
    """Parameters that take part in matmuls: per layer wq and wo at full
    head width, wk and wv at the kv head width, the MLP (an MoE layer: the
    router and every expert); plus the vocab projection once. Norm scales
    are left out."""
    d, dh = cfg.d_model, cfg.head_dim
    per_layer = 2 * d * cfg.n_heads * dh + 2 * d * cfg.kv_heads * dh
    if cfg.n_experts:
        per_layer += d * cfg.n_experts + cfg.n_experts * expert_ffn_params(cfg)
    else:
        per_layer += 2 * d * cfg.d_ff
    return cfg.n_layers * per_layer + cfg.vocab_size * d


def active_param_count(cfg) -> Optional[int]:
    """Matmul parameters a token touches, where that is not all of them:
    token-choice top-k routing skips n_experts - k experts a layer. None
    otherwise (soft dispatch runs every expert; expert choice's compute is
    set by its capacity)."""
    if cfg.n_experts and cfg.moe_top_k and cfg.moe_router == "token":
        inactive = cfg.n_experts - cfg.moe_top_k
        return matmul_param_count(cfg) - cfg.n_layers * inactive * expert_ffn_params(cfg)
    return None


def train_flops_per_token(cfg, seq_len: int, active_params: Optional[int] = None) -> float:
    """6 * P_matmul + the causal attention term (PaLM appendix B); an MoE
    model passes its activated parameters."""
    p = active_params if active_params is not None else matmul_param_count(cfg)
    return 6.0 * p + 12 * cfg.n_layers * seq_len * cfg.d_model * 0.5


def flagship_config(seq_len: int = 1024, **overrides) -> transformer.TransformerConfig:
    """The bench's flagship: vocab 32000, d_model 1024, 16 heads of 64,
    d_ff 4096, 8 layers, bf16 compute over f32 params, remat off (the
    6*P accounting does not credit a recomputed forward)."""
    base = dict(vocab_size=32000, d_model=1024, n_heads=16, d_ff=4096, n_layers=8,
                max_seq_len=seq_len, dtype=torch.bfloat16, remat=False)
    return transformer.TransformerConfig(**{**base, **overrides})


def run_model_bench(steps: int = 20, warmup: int = 3, batch: int = 8, seq_len: int = 1024,
                    config: Optional[transformer.TransformerConfig] = None,
                    learning_rate: float = 1e-3, loss_chunk: int = 0,
                    profile_dir: Optional[str] = None, device=None) -> dict:
    """Train `config` (default: the flagship) and return step time,
    tokens/s and MFU. `profile_dir` wraps the timed steps in a
    torch.profiler trace (<profile_dir>/trace.json)."""
    device = resolve_device(device)
    cfg = config or flagship_config(seq_len)
    if loss_chunk:
        from dataclasses import replace

        cfg = replace(cfg, loss_chunk=loss_chunk)
    cfg.validate()
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    params = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    optimizer = optim.adam(learning_rate)
    opt_state = optimizer.init(params)
    train_step = transformer.build_train_step(cfg, optimizer, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq_len + 1), generator=gen, device=device)
    batch_data = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:],
                  "mask": torch.ones((batch, seq_len), dtype=torch.float32, device=device)}

    losses = []
    for _ in range(max(warmup, 1)):
        params, opt_state, loss = train_step(params, opt_state, batch_data)
        losses.append(float(loss))
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    step_s = []
    trace = profiled(profile_dir, device) if profile_dir else contextlib.nullcontext()
    with trace:
        for _ in range(steps):
            t0 = time.perf_counter()
            params, opt_state, loss = train_step(params, opt_state, batch_data)
            sync()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))

    median_s = statistics.median(step_s)
    tokens_per_sec = batch * seq_len / median_s
    active_params = active_param_count(cfg)
    flops_per_token = train_flops_per_token(cfg, seq_len, active_params)
    achieved = tokens_per_sec * flops_per_token
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peak = peak_flops_for(kind) if on_card else None
    return {
        "model": "transformer",
        "device": str(device),
        "device_kind": kind,
        "batch": batch,
        "seq_len": seq_len,
        "d_model": cfg.d_model,
        "n_layers": cfg.n_layers,
        "n_heads": cfg.n_heads,
        "d_ff": cfg.d_ff,
        "vocab_size": cfg.vocab_size,
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "remat": bool(cfg.remat),
        "remat_policy": cfg.remat_policy if cfg.remat else None,
        "loss_chunk": cfg.loss_chunk,
        "params_m": round(matmul_param_count(cfg) / 1e6, 1),
        # An MoE run records its routing (a soft-dispatch or expert-choice
        # record must not read as a dense run), and top-k its activated count.
        **({"n_experts": cfg.n_experts, "moe_top_k": cfg.moe_top_k,
            "d_ff_expert": cfg.d_ff_expert, "moe_router": cfg.moe_router,
            "moe_dispatch": cfg.moe_dispatch} if cfg.n_experts else {}),
        **({"active_params_m": round(active_params / 1e6, 1)}
           if active_params is not None else {}),
        "steps": steps,
        "step_time_ms": 1e3 * sum(step_s) / steps,
        "step_time_ms_median": 1e3 * median_s,
        "step_time_ms_range": [1e3 * min(step_s), 1e3 * max(step_s)],
        "tokens_per_sec": tokens_per_sec,
        "flops_per_token": flops_per_token,
        "achieved_tflops": achieved / 1e12,
        "peak_tflops": peak / 1e12 if peak else None,
        "mfu_pct": 100 * achieved / peak if peak else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
        "losses": losses,
        "final_loss": losses[-1],
        **({"profile_dir": profile_dir} if profile_dir else {}),
    }


def run_decode_bench(batch: int = 8, prompt_len: int = 32, max_new_tokens: int = 96,
                     config: Optional[transformer.TransformerConfig] = None,
                     quantized: bool = False, quantized_kv: Optional[bool] = None,
                     measure_ttft: bool = False, device=None) -> dict:
    """Serving benchmark (the reference's `run_decode_bench`): new tokens/s
    of a greedy `build_generate` call, timed after one warm call, on
    `device` (the card unless the caller names another). `config` may be
    an MoE model.

    quantized: int8 weights (`quantize_params_for_serving`); quantized_kv
    (None: as `quantized`) the int8 KV cache. measure_ttft also times a
    max_new_tokens=1 call (the batched prefill and the first pick, no
    cached step) after its own warm call. The default config is the
    reference's: vocab 32000, d_model 1024, 16 heads, d_ff 4096, 8 layers,
    bf16 compute over f32 parameters."""
    from ..models.decode import build_generate
    from ..models.quant import quantize_params_for_serving

    device = resolve_device(device)
    cfg = config or transformer.TransformerConfig(
        vocab_size=32000, d_model=1024, n_heads=16, d_ff=4096, n_layers=8,
        max_seq_len=prompt_len + max_new_tokens)
    cfg.validate()
    on_card = device.type == "cuda"

    def timed(fn):
        out = fn()  # warm call
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    params = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    if quantized:
        params = quantize_params_for_serving(params)
    if quantized_kv is None:
        quantized_kv = quantized
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator(device=device).manual_seed(1),
                           device=device, dtype=torch.int32)
    flags = dict(quantized=quantized, quantized_kv=quantized_kv)
    generate = build_generate(cfg, max_new_tokens, device, **flags)
    _, elapsed = timed(lambda: generate(params, prompt))
    ttft_ms = None
    if measure_ttft:
        first = build_generate(cfg, 1, device, **flags)
        ttft_ms = 1e3 * timed(lambda: first(params, prompt))[1]

    return {
        "phase": "decode",
        "quantized": quantized,
        "quantized_kv": quantized_kv,
        "backend": device.type,
        "device_kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "batch": batch,
        "prompt_len": prompt_len,
        "max_new_tokens": max_new_tokens,
        "params_m": round(matmul_param_count(cfg) / 1e6, 1),
        "decode_tokens_per_sec": batch * max_new_tokens / elapsed,
        "per_token_latency_ms": 1e3 * elapsed / (prompt_len + max_new_tokens),
        **({"ttft_ms": ttft_ms} if ttft_ms is not None else {}),
    }
