"""Single-device model benchmark: step time, tokens/s and MFU of the
flagship transformer's train step (the method of
`jobset_tpu/runtime/model_bench.py::run_model_bench`).

* The flagship config with remat off, adam at lr 1e-3, one fixed batch of
  random tokens, `warmup` untimed steps, then `steps` timed ones. Each step
  ends with `torch.cuda.synchronize()` on the card, and its time is the
  host clock around it.
* FLOPs per token are the standard training estimate (PaLM appendix B):
  6 per matmul parameter (forward and backward) plus the causal attention
  score and context products, 12 * L * T * d halved. The embedding lookup
  is not counted; the vocab projection is, through its parameters.
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


def matmul_param_count(cfg) -> int:
    """Parameters that take part in matmuls: per layer wq and wo at full
    head width, wk and wv at the kv head width, the MLP; plus the vocab
    projection once. Norm scales are left out."""
    d, dh = cfg.d_model, cfg.head_dim
    per_layer = 2 * d * cfg.n_heads * dh + 2 * d * cfg.kv_heads * dh + 2 * d * cfg.d_ff
    return cfg.n_layers * per_layer + cfg.vocab_size * d


def train_flops_per_token(cfg, seq_len: int) -> float:
    """6 * P_matmul + the causal attention term (PaLM appendix B)."""
    return 6.0 * matmul_param_count(cfg) + 12 * cfg.n_layers * seq_len * cfg.d_model * 0.5


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
    flops_per_token = train_flops_per_token(cfg, seq_len)
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
