#!/usr/bin/env python3
"""Smoke run of the PyTorch port (jobset_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--out RESULTS.json]

Phases, in order; any failure exits non-zero before the result line:
  1. the card's name and power limit (nvidia-smi); TF32 off;
  2. build every CUDA kernel from this checkout (one nvcc per source, all
     started together) and print the build seconds and ptxas report;
  3. hold each kernel against its plain PyTorch version on the card, at
     the flagship prefill shape and at edge shapes, and time the kernel,
     the plain version and the nearest PyTorch library call;
  4. the flagship forward (`build_forward`) at B=8, T=1024: finite logits
     that match the plain path on the card, and a small config that
     matches the plain path on the CPU;
  5. the flagship greedy `build_generate` at B=8, prompt 1024, 32 new
     tokens: kernel launches counted across the run, prefill logits
     against the plain path, tokens/s and time to first token;
  6. one `kernels` JSON line, then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The flagship is the repo's training/decode bench config: vocab 32000,
d_model 1024, 16 heads (head_dim 64), d_ff 4096, 8 layers, bf16 compute,
f32 params, weights random from a seed. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16
# tensor-core FLOP/s, and f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Stated tolerances (rtol, atol), kernel against plain version on the same
# inputs; each bound is max|got - want| <= atol + rtol * max|want| over the
# tensor. f32: same arithmetic in another order. bf16: operands are exact
# in the f32 products, but p is rounded to bf16 for the PV product against
# the running max (kernel) or the block max (plain).
KERNEL_TOL = {
    torch.float32: {"max": (1e-4, 1e-5), "sum": (1e-4, 1e-5), "weighted": (1e-4, 1e-5)},
    torch.bfloat16: {"max": (1e-5, 1e-4), "sum": (2e-2, 1e-5), "weighted": (2e-2, 1e-5)},
}
# The flagship run: batch, prompt length and new tokens of `generate`, and
# the forward at the same batch and length. A 1024-token prompt prefills in
# chunks of 512: per layer two diagonal blocks (triangle bias) and one
# below the diagonal (zero bias), so 3 kernel launches; the forward runs
# one block per layer.
LAYERS, BATCH, PROMPT, NEW_TOKENS = 8, 8, 1024, 32
GENERATE_LAUNCHES, FORWARD_LAUNCHES = 3 * LAYERS, LAYERS
ITERS = 20  # timed launches per kernel

# Flagship logits, kernel path against plain path (bf16 through 8 layers):
# max|d| <= 5e-2 * max|ref| and mean|d| <= 1e-2 * mean|ref|.
LOGITS_MAX_REL, LOGITS_MEAN_REL = 5e-2, 1e-2

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("ok   " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def plain_attention():
    """Route the port's flash block step to its plain version, on the card,
    for a reference run of the same path."""
    from jobset_tpu_torch.ops import flash_block

    real = flash_block.block_attention

    def plain(q, k, v, bias):
        return flash_block.block_attention_reference(q, k, v, bias.float())

    flash_block.block_attention = plain
    try:
        yield
    finally:
        flash_block.block_attention = real


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def flash_case(name, dtype, batch, tq, tk, heads, dim, bias_kind, kv_heads=None, seed=0,
               fused=False):
    """One comparison of the kernel with its plain version. `fused` cuts
    q, k and v as strided views out of one [B, T, (H + 2*H_kv) * D] buffer,
    as the forward's fused QKV GEMM hands them to the kernel."""
    from jobset_tpu_torch.ops import flash_block as fb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv_heads = kv_heads or heads

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if fused:
        qkv = randn(batch, tq, (heads + 2 * kv_heads) * dim)
        q, k_c, v_c = torch.split(qkv, [heads * dim, kv_heads * dim, kv_heads * dim], dim=-1)
        q = q.reshape(batch, tq, heads, dim)
        k_c, v_c = (t.reshape(batch, tk, kv_heads, dim) for t in (k_c, v_c))
    else:
        q = randn(batch, tq, heads, dim)
        k_c, v_c = randn(batch, tk, kv_heads, dim), randn(batch, tk, kv_heads, dim)
    k = fb._repeat_heads(k_c, heads // kv_heads)
    v = fb._repeat_heads(v_c, heads // kv_heads)
    if bias_kind == "triangle":
        rel = torch.arange(tq, device="cuda")[:, None] - torch.arange(tk, device="cuda")[None]
        bias = torch.where(rel >= 0, 0.0, fb.NEG_INF).float()
    elif bias_kind == "zero":
        bias = torch.zeros((tq, tk), device="cuda")
    else:
        bias = torch.full((tq, tk), fb.NEG_INF, device="cuda")

    got = fb.block_attention(q, k, v, bias)
    torch.cuda.synchronize()
    want = fb.block_attention_reference(q, k, v, bias)
    errs = {}
    for label, g, w in zip(("max", "sum", "weighted"), got, want):
        rtol, atol = KERNEL_TOL[dtype][label]
        err = max_abs(g, w)
        errs[label] = err
        limit = atol + rtol * w.abs().max().item()
        check(bool(torch.isfinite(g).all()), f"flash_block {name}: {label} finite")
        check(err <= limit, f"flash_block {name}: {label} max|d|={err:.3e} <= {limit:.3e}")
    if bias_kind == "all_masked":
        check(bool((got[1] == 0).all() and (got[2] == 0).all()
                   and (got[0] <= fb.NEG_INF / 2).all()),
              f"flash_block {name}: fully masked rows give max ~NEG_INF, sum 0, weighted 0")
    return dict(q=q, k=k, v=v, k_c=k_c, v_c=v_c, bias=bias, errs=errs)


def flash_bound_ms(case) -> tuple[float, str]:
    """Least time for one launch: each input read once, each output written
    once, at HBM rate; or the products at the dtype's peak rate."""
    q, k_c, v_c, bias = case["q"], case["k_c"], case["v_c"], case["bias"]
    batch, tq, heads, dim = q.shape
    tk = k_c.shape[1]
    moved = sum(t.numel() * t.element_size() for t in (q, k_c, v_c, bias))
    moved += 4 * (2 * batch * heads * tq + batch * tq * heads * dim)
    flops = 4 * batch * heads * tq * tk * dim
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels():
    from jobset_tpu_torch.ops import flash_block as fb

    bf16, f32 = torch.bfloat16, torch.float32
    flagship = None
    for bias_kind in ("triangle", "zero", "all_masked"):
        case = flash_case(f"flagship bf16 B8 H16 T512 D64 {bias_kind}", bf16,
                          8, 512, 512, 16, 64, bias_kind)
        if bias_kind == "triangle":
            flagship = case
    flash_case("f32 ragged Tq100 Tk77 D32", f32, 2, 100, 77, 4, 32, "triangle", seed=1)
    flash_case("bf16 GQA expand view H16/Hkv4 T512 D64", bf16, 8, 512, 512, 16, 64,
               "triangle", kv_heads=4, seed=2)
    flash_case("f32 D8 ragged Tq33 Tk65", f32, 1, 33, 65, 2, 8, "zero", seed=3)
    flash_case("bf16 D128 Tq130 Tk200", bf16, 2, 130, 200, 4, 128, "triangle", seed=4)
    forward = flash_case("forward shape bf16 B8 H16 T1024 D64, fused-QKV views", bf16,
                         8, 1024, 1024, 16, 64, "triangle", seed=5, fused=True)

    q, k, v, bias = (flagship[n] for n in ("q", "k", "v", "bias"))
    kernel_ms = cuda_ms(lambda: fb.block_attention(q, k, v, bias), ITERS)
    plain_ms = cuda_ms(lambda: fb.block_attention_reference(q, k, v, bias), ITERS // 4)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = bias.to(q.dtype)
    library_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
        ITERS,
    )
    bound_ms, bound_by = flash_bound_ms(flagship)
    fq, fk, fv, fbias = (forward[n] for n in ("q", "k", "v", "bias"))
    forward_ms = cuda_ms(lambda: fb.block_attention(fq, fk, fv, fbias), ITERS)
    forward_bound_ms, _ = flash_bound_ms(forward)
    print(f"flash_block forward shape bf16 [8,1024,16,64] triangle: kernel {forward_ms:.4f} ms, "
          f"bound {forward_bound_ms:.4f} ms", flush=True)
    print(
        f"flash_block flagship bf16 [8,512,16,64] triangle: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library_ms (nearest: normalized output, no stats) "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True,
    )
    return {
        "name": "flash_block",
        "route": "cuda",
        "source": "jobset_tpu_torch/ops/csrc/flash_block.cu",
        "replaces": "jobset_tpu/ops/flash_block.py:194",
        "max_abs_err": flagship["errs"]["weighted"],
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "library_call": "scaled_dot_product_attention (nearest: normalized output, no stats)",
        "shape": "bf16 B=8 H=16 Tq=Tk=512 D=64, triangle bias",
        "forward_shape_ms": forward_ms,
        "forward_shape_bound_ms": forward_bound_ms,
    }


# ---------------------------------------------------------------------------
# Phases 4 and 5: the port's entry points
# ---------------------------------------------------------------------------


def compare_logits(name, got, want):
    d = (got.float() - want.float()).abs()
    ref = want.float().abs()
    max_d, mean_d = d.max().item(), d.mean().item()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: finite")
    check(max_d <= LOGITS_MAX_REL * ref.max().item() and mean_d <= LOGITS_MEAN_REL * ref.mean().item(),
          f"{name}: kernel vs plain max|d|={max_d:.4g} mean|d|={mean_d:.4g} "
          f"(ref max {ref.max().item():.4g}, mean {ref.mean().item():.4g})")
    return max_d


def flagship_config():
    from jobset_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab_size=32000, d_model=1024, n_heads=16, d_ff=4096, n_layers=LAYERS,
        dtype=torch.bfloat16,
    )


def phase_forward(params, results):
    from jobset_tpu_torch.entry import entry
    from jobset_tpu_torch.models import build_forward
    from jobset_tpu_torch.ops import flash_block as fb

    cfg = flagship_config()
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    forward = build_forward(cfg)  # default device: the card
    forward(params, tokens[:, :64])  # warm-up: cuBLAS handles, kernel library
    torch.cuda.synchronize()

    fb.KERNEL_LAUNCHES = 0
    logits, secs = wall_s(lambda: forward(params, tokens))
    launches = fb.KERNEL_LAUNCHES
    results["forward_launches"] = launches
    check(launches == FORWARD_LAUNCHES,
          f"forward: {launches} kernel launches (expected {FORWARD_LAUNCHES})")
    check(tuple(logits.shape) == (BATCH, PROMPT, cfg.vocab_size),
          f"forward: logits shape {tuple(logits.shape)}")
    with plain_attention():
        plain = forward(params, tokens)
    results["forward_max_abs_diff"] = compare_logits("forward flagship", logits, plain)
    print(f"forward flagship B={BATCH} T={PROMPT}: {secs:.4f} s wall", flush=True)
    del logits, plain

    # Small config: kernel path on the card against the plain path on the CPU.
    fn, (small_params, small_tokens) = entry()
    got = fn(small_params, small_tokens)
    cpu_fn, _ = entry(device="cpu")
    want = cpu_fn(to_device(small_params, "cpu"), small_tokens.cpu())
    compare_logits("entry() config, card vs CPU plain path", got.cpu(), want)


def phase_generate(params, results):
    from jobset_tpu_torch.models import TransformerConfig, build_generate, decode, init_params
    from jobset_tpu_torch.ops import flash_block as fb

    cfg = flagship_config()
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    generate = build_generate(cfg, NEW_TOKENS)  # default device: the card
    first_token = build_generate(cfg, 1)
    first_token(params, prompt)  # warm-up
    torch.cuda.synchronize()

    fb.KERNEL_LAUNCHES = 0
    tokens, secs = wall_s(lambda: generate(params, prompt))
    launches = fb.KERNEL_LAUNCHES
    results["launches"] = launches
    check(launches == GENERATE_LAUNCHES,
          f"generate: {launches} kernel launches (expected {GENERATE_LAUNCHES})")
    check(tuple(tokens.shape) == (BATCH, PROMPT + NEW_TOKENS)
          and bool((tokens[:, :PROMPT] == prompt).all())
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"generate: tokens shape {tuple(tokens.shape)}, prompt kept, ids in vocab")
    _, ttft = wall_s(lambda: first_token(params, prompt))
    tok_per_s = BATCH * NEW_TOKENS / secs
    results.update(generate_s=secs, ttft_s=ttft, tokens_per_s=tok_per_s)
    print(f"generate flagship B={BATCH} prompt={PROMPT} new={NEW_TOKENS}: "
          f"{secs:.4f} s, {tok_per_s:.1f} new tokens/s, TTFT {ttft:.4f} s "
          f"(information; {results['card']})", flush=True)

    cast = decode.cast_params(params, cfg.dtype)
    cache = decode.init_kv_cache(cfg, BATCH, PROMPT + 1, "cuda")
    got = decode._prefill_logits(cast, prompt, cache, cfg)
    with plain_attention():
        want = decode._prefill_logits(cast, prompt, cache, cfg)
    results["prefill_max_abs_diff"] = compare_logits("generate prefill last-position logits",
                                                     got, want)

    # Small GQA config at f32: greedy tokens on the card (kernel path) are
    # the CPU plain path's, token for token.
    small = TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                               n_layers=2, dtype=torch.float32)
    small_params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    small_prompt = torch.randint(0, 128, (2, 40), generator=torch.Generator().manual_seed(1))
    want_tokens = build_generate(small, 6, "cpu")(small_params, small_prompt)
    got_tokens = build_generate(small, 6)(to_device(small_params, "cuda"), small_prompt)
    check(torch.equal(got_tokens.cpu(), want_tokens),
          "generate small f32 GQA config: card tokens equal the CPU plain path's")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the results as JSON to this file")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from jobset_tpu_torch.models import init_params
    from jobset_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {"card": card}

    t0 = time.perf_counter()
    cuda_build.build_all(["flash_block"])
    results["build_s"] = time.perf_counter() - t0
    print(f"build: {results['build_s']:.2f} s", flush=True)
    for name, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    kernel = phase_kernels()

    cfg = flagship_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for d in (params, params["layers"]) for t in d.values()
                   if torch.is_tensor(t))
    print(f"flagship params: {n_params / 1e6:.1f} M", flush=True)
    phase_forward(params, results)
    phase_generate(params, results)

    kernel["launches"] = results["launches"]
    kernel["forward_launches"] = results["forward_launches"]
    results["kernels"] = [kernel]
    results["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for what in FAILURES:
            print(f"  {what}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": results["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
