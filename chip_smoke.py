#!/usr/bin/env python3
"""Smoke run of the PyTorch port (jobset_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--out RESULTS.json]

Phases, in order; any failure exits non-zero before the result line:
  1. the card's name and power limit (nvidia-smi); TF32 off;
  2. build every CUDA kernel from this checkout (one nvcc per source, all
     started together) and print the build seconds, the ptxas report and
     the tensor-core instructions in each kernel's SASS (the bf16 block
     kernel must have HGMMA, i.e. wgmma);
  3. hold each kernel (the flash block step in both dtype variants, and
     the tile-class pre-pass) against its plain PyTorch version on the
     card, at the flagship prefill shape with six bias kinds and at edge
     shapes, and time the kernel, the plain version and the nearest
     PyTorch library call at the flagship and forward shapes, rotating
     input sets larger than the 50 MB L2 (L2-cold), and the host time of
     one `generate`'s 24 block calls under no_grad, through the wrapper,
     through the autograd.Function and straight to the launch;
  4. the flagship forward (`build_forward`) at B=8, T=1024: finite logits
     that match the plain path on the card, and a small config that
     matches the plain path on the CPU;
  5. the flagship greedy `build_generate` at B=8, prompt 1024, 32 new
     tokens: kernel launches counted per variant across one run (all on
     the tensor-core variant), prefill logits against the plain path,
     tokens/s and time to first token (medians of a few more calls);
  6. a torch.profiler trace of one warm first-token call: the top 10
     device ops by device time and the card's idle share;
  7. training at the flagship width and depth: `run_model_bench` (B=8,
     T=1024, remat off, adam 1e-3; 8 block launches a step, all on the
     tensor-core variant), one train step through the kernel against the
     same step through the plain version (loss and every gradient leaf),
     remat "full" (16 launches a step) and "dots" (8), the eval step
     (8), the block backward's device time at the training shape and
     the two ways to run its products, a torch.profiler trace of one
     warm train step, and a small f32 config's step on the card against
     the CPU;
  8. the worker (`python -m jobset_tpu_torch.runtime.worker`) in a
     subprocess on a small f32 LM workload with checkpoints: an
     uninterrupted run, a run that fails at a step, and its restart,
     which resumes from the checkpoint and ends at the uninterrupted
     run's loss; the FMA variant's counter moves;
  9. one `kernels` JSON line, then the result line
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
GEN_REPEATS, TTFT_REPEATS = 3, 7  # wall-clock calls behind each median
ITERS = 20  # timed launches per kernel
SPIN_CYCLES = 10_000_000  # about 5 ms of the card's clock before a timed run

# Flagship logits, kernel path against plain path (bf16 through 8 layers):
# max|d| <= 5e-2 * max|ref| and mean|d| <= 1e-2 * mean|ref|.
LOGITS_MAX_REL, LOGITS_MEAN_REL = 5e-2, 1e-2
# Flagship train step, kernel path against plain path, and remat against
# none (bf16 through 8 layers): loss within 1e-2 relative; each gradient
# leaf within 5e-2 of the reference in relative norm. The kernel rounds p
# to bf16 against its running max, the plain version against the block
# max, and the plain backward differentiates through the max (the kernel
# path's drops it: the gauge); both are bf16-level differences.
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-2, 5e-2
# A small f32 config, the card's kernel path against the CPU's plain path:
# loss rtol 1e-4, gradient leaves 1e-3 in relative norm (f32 in another
# summation order, through 2 layers).
F32_LOSS_REL, F32_GRAD_REL = 1e-4, 1e-3
TRAIN_WARMUP, TRAIN_STEPS = 3, 20  # run_model_bench's untimed and timed steps

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
    """Mean device time of fn over `iters` back-to-back calls (CUDA events).
    The card first spins for a few ms, so the host has queued the timed
    calls before the first one starts and the Python wrapper's host time
    does not leave the card idle between them."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
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


LAUNCH_COUNTERS = ("KERNEL_LAUNCHES", "TENSOR_CORE_LAUNCHES", "FMA_LAUNCHES",
                   "TILE_CLASS_LAUNCHES")


def reset_launches():
    from jobset_tpu_torch.ops import flash_block as fb

    for name in LAUNCH_COUNTERS:
        setattr(fb, name, 0)


def check_launches(path, expected):
    """Read the counters after a bf16 run of `path`: every block launch went
    through the tensor-core variant, each after its tile-class pre-pass."""
    from jobset_tpu_torch.ops import flash_block as fb

    counts = {name: getattr(fb, name) for name in LAUNCH_COUNTERS}
    check(counts == {"KERNEL_LAUNCHES": expected, "TENSOR_CORE_LAUNCHES": expected,
                     "FMA_LAUNCHES": 0, "TILE_CLASS_LAUNCHES": expected},
          f"{path}: launches {counts} (expected {expected} block launches, all on the "
          f"tensor-core variant, and {expected} pre-pass launches)")
    return counts


def tensor_core_sass(library) -> dict:
    """Count the tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync) in
    each kernel of a built library's SASS; the bf16 block kernel must have
    HGMMA."""
    from jobset_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                counts[name][op] += f" {op}." in line
    for name, c in counts.items():
        print(f"  sass {name}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}", flush=True)
    tc = {n: c for n, c in counts.items() if "flash_block_tc_kernel" in n}
    check(bool(tc) and all(c["HGMMA"] > 0 for c in tc.values()),
          f"sass: every bf16 tensor-core kernel instantiation has HGMMA ({len(tc)} found)")
    return counts


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_bias(kind, tq, tk, device="cuda"):
    """[Tq, Tk] f32 additive bias of one kind (NEG_INF masks)."""
    from jobset_tpu_torch.ops import flash_block as fb

    rel = (torch.arange(tq, device=device)[:, None]
           - torch.arange(tk, device=device)[None]).float()
    cols = torch.arange(tk, device=device)[None].expand(tq, tk)
    masked = {
        "triangle": rel < 0,                                   # causal
        "reverse_triangle": rel > 0,                           # first kv tiles masked
        "band": (cols >= tk // 3) & (cols < 2 * tk // 3),      # masked middle of each row
        "zero": torch.zeros_like(rel, dtype=torch.bool),
        "all_masked": torch.ones_like(rel, dtype=torch.bool),
        "alibi": torch.zeros_like(rel, dtype=torch.bool),      # non-zero, unmasked
    }[kind]
    bias = -0.05 * rel.abs() if kind == "alibi" else torch.zeros_like(rel)
    return torch.where(masked, fb.NEG_INF, bias)


def make_qkv(dtype, batch, tq, tk, heads, dim, kv_heads, gen, fused=False):
    """q [B,Tq,H,D] and compact k, v [B,Tk,H_kv,D] on the card. `fused`
    cuts them as strided views out of one [B, T, (H + 2*H_kv) * D] buffer,
    as the forward's fused QKV GEMM hands them to the kernel."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if fused:
        qkv = randn(batch, tq, (heads + 2 * kv_heads) * dim)
        q, k_c, v_c = torch.split(qkv, [heads * dim, kv_heads * dim, kv_heads * dim], dim=-1)
        return (q.reshape(batch, tq, heads, dim),
                *(t.reshape(batch, tk, kv_heads, dim) for t in (k_c, v_c)))
    return (randn(batch, tq, heads, dim), randn(batch, tk, kv_heads, dim),
            randn(batch, tk, kv_heads, dim))


def flash_case(name, dtype, batch, tq, tk, heads, dim, bias_kind, kv_heads=None, seed=0,
               fused=False):
    """One comparison of the block kernel, and of the tile-class pre-pass,
    with their plain versions; the variant counter for the dtype must move."""
    from jobset_tpu_torch.ops import flash_block as fb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv_heads = kv_heads or heads
    q, k_c, v_c = make_qkv(dtype, batch, tq, tk, heads, dim, kv_heads, gen, fused)
    k = fb._repeat_heads(k_c, heads // kv_heads)
    v = fb._repeat_heads(v_c, heads // kv_heads)
    bias = make_bias(bias_kind, tq, tk)

    classes = fb.tile_classes(bias)
    want_classes = fb.tile_classes_reference(bias)
    classes_err = (classes.int() - want_classes.int()).abs().max().item()
    check(torch.equal(classes, want_classes),
          f"tile_classes {name}: pre-pass equals the plain version "
          f"({[int((want_classes == c).sum()) for c in range(3)]} tiles of class 0/1/2)")
    counter = "TENSOR_CORE_LAUNCHES" if dtype == torch.bfloat16 else "FMA_LAUNCHES"
    before = getattr(fb, counter)
    got = fb.block_attention(q, k, v, bias)
    torch.cuda.synchronize()
    check(getattr(fb, counter) == before + 1, f"flash_block {name}: ran the {counter} variant")
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
    return dict(q=q, k=k, v=v, k_c=k_c, v_c=v_c, bias=bias, bias_kind=bias_kind,
                classes=classes, errs=errs, classes_err=classes_err,
                shape=(dtype, batch, tq, tk, heads, dim, kv_heads, fused))


def flash_bound_ms(case) -> tuple[float, str]:
    """Least time for one launch: each input read once and each output
    written once at HBM rate, or the products these inputs need (the
    unmasked logits only) at the dtype's peak rate; the larger."""
    q, k_c, v_c, bias = case["q"], case["k_c"], case["v_c"], case["bias"]
    batch, tq, heads, dim = q.shape
    moved = sum(t.numel() * t.element_size() for t in (q, k_c, v_c, bias))
    moved += 4 * (2 * batch * heads * tq + batch * tq * heads * dim)
    unmasked = int((bias > -5e29).sum())
    flops = 4 * batch * heads * dim * unmasked
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rotating_ms(fn, n_sets: int, iters: int) -> float:
    """cuda_ms of fn(i) with i cycling over n_sets input sets, so that
    (with enough sets) every call reads its inputs from HBM, not L2."""
    count = [0]

    def call():
        fn(count[0] % n_sets)
        count[0] += 1

    return cuda_ms(call, iters, warmup=n_sets)


def time_block(case, n_sets, other_bias_kinds=()):
    """L2-cold times at one case's shape: the block kernel alone (classes
    computed beforehand), the plain version, scaled_dot_product_attention
    with the same additive mask, and the whole wrapper call; and the kernel
    alone under each of `other_bias_kinds` (`ms_by_bias`)."""
    from jobset_tpu_torch.ops import flash_block as fb

    dtype, batch, tq, tk, heads, dim, kv_heads, fused = case["shape"]
    gen = torch.Generator(device="cuda").manual_seed(100)
    group = heads // kv_heads
    sets = []
    for _ in range(n_sets):
        q, k_c, v_c = make_qkv(dtype, batch, tq, tk, heads, dim, kv_heads, gen, fused)
        sets.append((q, fb._repeat_heads(k_c, group), fb._repeat_heads(v_c, group)))
    bias, classes = case["bias"], case["classes"]
    out = {
        "ms": rotating_ms(lambda i: fb._block_attention_cuda(*sets[i], bias, classes),
                          n_sets, ITERS),
        "call_ms": rotating_ms(lambda i: fb.block_attention(*sets[i], bias), n_sets, ITERS),
        "plain_ms": rotating_ms(lambda i: fb.block_attention_reference(*sets[i], bias),
                                n_sets, ITERS // 4),
    }
    out["ms_by_bias"] = {case["bias_kind"]: out["ms"]}
    for kind in other_bias_kinds:
        other = make_bias(kind, tq, tk)
        other_classes = fb.tile_classes(other)
        out["ms_by_bias"][kind] = rotating_ms(
            lambda i: fb._block_attention_cuda(*sets[i], other, other_classes), n_sets, ITERS)
    mask = bias.to(dtype)
    sdpa_sets = [tuple(fb._flat_heads(t).transpose(1, 2) for t in s) for s in sets]
    out["library_ms"] = rotating_ms(
        lambda i: torch.nn.functional.scaled_dot_product_attention(*sdpa_sets[i],
                                                                   attn_mask=mask),
        n_sets, ITERS)
    out["bound_ms"], out["bound_by"] = flash_bound_ms(case)
    return out


def host_call_ms(case, calls=GENERATE_LAUNCHES, repeats=TTFT_REPEATS):
    """Host time to issue `calls` block calls (one `generate`'s prefill
    worth) on one case's inputs: the wrapper under no_grad, as serving
    calls it; the autograd.Function under no_grad; and the kernel's launch
    function alone. Median over `repeats`, the three interleaved."""
    from jobset_tpu_torch.ops import flash_block as fb

    args = (case["q"], case["k"], case["v"], case["bias"])
    ways = {
        "block_attention": lambda: fb.block_attention(*args),
        "autograd_function": lambda: fb._BlockAttention.apply(*args),
        "kernel_launch": lambda: fb._block_attention_cuda(*args),
    }
    runs = {name: [] for name in ways}
    with torch.no_grad():
        for fn in ways.values():
            fn()
        for _ in range(repeats):
            for name, fn in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                runs[name].append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return {name: sorted(r)[len(r) // 2] for name, r in runs.items()}


def phase_kernels():
    from jobset_tpu_torch.ops import flash_block as fb

    bf16, f32 = torch.bfloat16, torch.float32
    flagship = None
    for bias_kind in ("triangle", "zero", "all_masked", "band", "reverse_triangle", "alibi"):
        case = flash_case(f"flagship bf16 B8 H16 T512 D64 {bias_kind}", bf16,
                          8, 512, 512, 16, 64, bias_kind)
        if bias_kind == "triangle":
            flagship = case
    flash_case("f32 ragged Tq100 Tk77 D32", f32, 2, 100, 77, 4, 32, "triangle", seed=1)
    flash_case("bf16 GQA expand view H16/Hkv4 T512 D64", bf16, 8, 512, 512, 16, 64,
               "triangle", kv_heads=4, seed=2)
    flash_case("f32 D8 ragged Tq33 Tk65", f32, 1, 33, 65, 2, 8, "zero", seed=3)
    flash_case("bf16 D8 ragged Tq33 Tk65", bf16, 1, 33, 65, 2, 8, "zero", seed=3)
    flash_case("bf16 D128 Tq130 Tk200", bf16, 2, 130, 200, 4, 128, "triangle", seed=4)
    flash_case("bf16 D128 B8 H8 T512", bf16, 8, 512, 512, 8, 128, "triangle", seed=6)
    forward = flash_case("forward shape bf16 B8 H16 T1024 D64, fused-QKV views", bf16,
                         8, 1024, 1024, 16, 64, "triangle", seed=5, fused=True)

    # L2-cold: 4 sets of q/k/v at the flagship shape (100 MB) and 2 fused
    # QKV buffers at the forward shape (100 MB) against the 50 MB L2.
    flag_t = time_block(flagship, 4, ("zero", "alibi"))
    fwd_t = time_block(forward, 2)
    for label, t in (("flagship bf16 [8,512,16,64]", flag_t),
                     ("forward shape bf16 [8,1024,16,64]", fwd_t)):
        print(f"flash_block {label} triangle, L2-cold: kernel {t['ms']:.4f} ms "
              f"(call with pre-pass {t['call_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
              f"library_ms (scaled_dot_product_attention, same mask; normalized output, "
              f"no stats) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of bound", flush=True)
    print("flash_block flagship bf16 [8,512,16,64], kernel alone by bias kind, L2-cold: "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in flag_t["ms_by_bias"].items()), flush=True)
    host = host_call_ms(flagship)
    print(f"flash_block flagship bf16 [8,512,16,64], host time of {GENERATE_LAUNCHES} calls "
          f"under no_grad, median of {TTFT_REPEATS}: "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in host.items()), flush=True)

    # The pre-pass over 64 distinct 1 MB triangle biases (64 MB > L2).
    biases = [flagship["bias"].clone() for _ in range(64)]
    classes_ms = rotating_ms(lambda i: fb._tile_classes_cuda(biases[i]), 64, 64)
    classes_plain_ms = rotating_ms(lambda i: fb.tile_classes_reference(biases[i]), 64, 16)
    bias = flagship["bias"]
    classes_bound_ms = 1e3 * (bias.numel() * 4 + flagship["classes"].numel()) / HBM_BYTES_PER_S
    print(f"tile_classes [512,512] triangle, L2-cold: kernel {classes_ms:.4f} ms, plain "
          f"{classes_plain_ms:.4f} ms, bound {classes_bound_ms:.4f} ms (bytes)", flush=True)

    return [
        {
            "name": "flash_block",
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/flash_block.cu",
            "replaces": "jobset_tpu/ops/flash_block.py:194",
            "variant": "bf16 tensor cores (flash_block_tc_kernel) on the flagship paths; "
                       "f32 FMA variant (flash_block_kernel) on the LM workload's default "
                       "f32 path, which the worker phase drives",
            "max_abs_err": flagship["errs"]["weighted"],
            "ms": flag_t["ms"],
            "plain_ms": flag_t["plain_ms"],
            "bound_ms": flag_t["bound_ms"],
            "bound_by": flag_t["bound_by"],
            "library_ms": flag_t["library_ms"],
            "library_call": "scaled_dot_product_attention with the same additive mask "
                            "(nearest: normalized output, no stats)",
            "shape": "bf16 B=8 H=16 Tq=Tk=512 D=64, triangle bias; L2-cold",
            "call_ms": flag_t["call_ms"],
            "ms_by_bias": flag_t["ms_by_bias"],
            "host_ms_per_generate_calls": host,
            "forward_shape": {k: fwd_t[k] for k in
                              ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by")},
        },
        {
            "name": "flash_block_tile_classes",
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/flash_block.cu",
            "replaces": "jobset_tpu/ops/flash_block.py:194",
            "max_abs_err": flagship["classes_err"],
            "ms": classes_ms,
            "plain_ms": classes_plain_ms,
            "bound_ms": classes_bound_ms,
            "bound_by": "bytes",
            "library_ms": None,
            "shape": "f32 bias [512, 512], triangle; L2-cold",
        },
    ]


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
    """The bench's flagship config (remat off)."""
    from jobset_tpu_torch.runtime.model_bench import flagship_config as bench_config

    return bench_config(n_layers=LAYERS)


def phase_forward(params, results):
    from jobset_tpu_torch.entry import entry
    from jobset_tpu_torch.models import build_forward

    cfg = flagship_config()
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda")
    forward = build_forward(cfg)  # default device: the card
    forward(params, tokens[:, :64])  # warm-up: cuBLAS handles, kernel library
    torch.cuda.synchronize()

    reset_launches()
    logits, secs = wall_s(lambda: forward(params, tokens))
    results["forward_launches"] = check_launches("forward", FORWARD_LAUNCHES)
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

    cfg = flagship_config()
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    generate = build_generate(cfg, NEW_TOKENS)  # default device: the card
    first_token = build_generate(cfg, 1)
    first_token(params, prompt)  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    tokens, secs = wall_s(lambda: generate(params, prompt))
    results["launches"] = check_launches("generate", GENERATE_LAUNCHES)
    check(tuple(tokens.shape) == (BATCH, PROMPT + NEW_TOKENS)
          and bool((tokens[:, :PROMPT] == prompt).all())
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"generate: tokens shape {tuple(tokens.shape)}, prompt kept, ids in vocab")
    # Host-bound and noisy (the host's cores are shared): medians of a few
    # more calls, with the spread.
    gen_runs = sorted([secs] + [wall_s(lambda: generate(params, prompt))[1]
                                for _ in range(GEN_REPEATS - 1)])
    ttft_runs = sorted(wall_s(lambda: first_token(params, prompt))[1]
                       for _ in range(TTFT_REPEATS))
    secs, ttft = gen_runs[len(gen_runs) // 2], ttft_runs[len(ttft_runs) // 2]
    tok_per_s = BATCH * NEW_TOKENS / secs
    results.update(generate_s=secs, ttft_s=ttft, tokens_per_s=tok_per_s,
                   generate_s_runs=gen_runs, ttft_s_runs=ttft_runs)
    print(f"generate flagship B={BATCH} prompt={PROMPT} new={NEW_TOKENS}: median of "
          f"{GEN_REPEATS} {secs:.4f} s ({gen_runs[0]:.4f}-{gen_runs[-1]:.4f}), "
          f"{tok_per_s:.1f} new tokens/s; TTFT median of {TTFT_REPEATS} {ttft:.4f} s "
          f"({ttft_runs[0]:.4f}-{ttft_runs[-1]:.4f}) (information; {results['card']})",
          flush=True)

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


def merged_span_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return total + (cur_end - cur_start if cur_end is not None else 0.0)


def traced(fn, label):
    """torch.profiler over one call of fn: the top 10 device ops by device
    time and the card's idle share of the traced window (first to last
    event, host or device). None when the profiler saw no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        print(f"trace {label}: the profiler recorded no device events; device time "
              "and idle share not measured", flush=True)
        return None
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    busy = merged_span_us((e.time_range.start, e.time_range.end) for e in device)
    by_name: dict = {}
    for e in device:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.end - e.time_range.start, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print(f"trace {label}: window {window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
          f"idle share {1.0 - busy / window:.1%}; top 10 device ops:", flush=True)
    for n, (t, c) in top:
        print(f"  {t / 1e3:9.3f} ms  {c:5d}x  {n[:100]}", flush=True)
    return {
        "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window,
        "device_ms_total": sum(t for t, _ in by_name.values()) / 1e3,
        "top10": [{"name": n[:120], "ms": t / 1e3, "count": c} for n, (t, c) in top],
    }


def phase_trace(params, results):
    """The trace of one warm `first_token` call (the TTFT path)."""
    from jobset_tpu_torch.models import build_generate

    cfg = flagship_config()
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    first_token = build_generate(cfg, 1)
    first_token(params, prompt)  # warm-up
    results["trace"] = traced(lambda: first_token(params, prompt),
                              f"first_token (B={BATCH}, prompt {PROMPT})")


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------


def token_batch(vocab, batch, seq, seed, device="cuda"):
    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(0, vocab, (batch, seq + 1), generator=gen, device=device)
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


def sgd_step(cfg, params, batch, device=None):
    """One train step at SGD lr 1.0 through `build_train_step`, so that
    p - p' is the gradient: (loss, gradient leaves in tree order)."""
    from jobset_tpu_torch import tree
    from jobset_tpu_torch.models import build_train_step
    from jobset_tpu_torch.runtime import optim

    opt = optim.sgd(1.0)
    new, _, loss = build_train_step(cfg, opt, device=device)(params, opt.init(params), batch)
    grads = [p - q for p, q in zip(tree.leaves(params), tree.leaves(new))]
    return float(loss), grads


def compare_step(name, got, want, loss_rel, grad_rel):
    """(loss, grads) of one step against a reference step's."""
    (loss, grads), (ref_loss, ref_grads) = got, want
    check(abs(loss - ref_loss) <= loss_rel * abs(ref_loss) and loss == loss,
          f"{name}: loss {loss:.6f} vs {ref_loss:.6f} (rel {loss_rel})")
    rels = [((g.float().cpu() - w.float().cpu()).norm() / w.float().cpu().norm()).item()
            for g, w in zip(grads, ref_grads)]
    check(all(r <= grad_rel for r in rels) and all(bool(torch.isfinite(g).all()) for g in grads),
          f"{name}: every gradient leaf within {grad_rel} in relative norm "
          f"(worst {max(rels):.3e} over {len(rels)} leaves)")
    return max(rels)


def launches_now():
    from jobset_tpu_torch.ops import flash_block as fb

    return {name: getattr(fb, name) for name in LAUNCH_COUNTERS}


def phase_train(results):
    from dataclasses import replace

    from jobset_tpu_torch.models import TransformerConfig, init_params
    from jobset_tpu_torch.ops import flash_block as fb
    from jobset_tpu_torch.runtime import model_bench

    card = results["card"]
    reset_launches()
    bench = model_bench.run_model_bench(steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, batch=BATCH,
                                        seq_len=PROMPT)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    counts = check_launches(f"run_model_bench ({steps} steps)", LAYERS * steps)
    results["train_step_launches"] = {k: v // steps for k, v in counts.items()}
    losses = bench.pop("losses")
    check(all(l == l and abs(l) < float("inf") for l in losses) and losses[-1] < losses[0],
          f"run_model_bench: every loss finite, last {losses[-1]:.4f} < first {losses[0]:.4f}")
    results["model_bench"] = bench
    results["model_bench_losses"] = losses
    lo, hi = bench["step_time_ms_range"]
    print(f"train step flagship B={BATCH} T={PROMPT} (remat off, adam): median of "
          f"{TRAIN_STEPS} {bench['step_time_ms_median']:.3f} ms ({lo:.3f}-{hi:.3f}), "
          f"{bench['tokens_per_sec']:.1f} tokens/s, {bench['achieved_tflops']:.2f} TFLOP/s, "
          f"MFU {bench['mfu_pct']}% of {bench['peak_tflops']} TFLOP/s, peak memory "
          f"{bench['peak_memory_gb']:.2f} GB (information; {card})", flush=True)

    # One step through the kernel against the same step through the plain
    # version, from the same params and batch; then remat "full" and "dots".
    cfg = flagship_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = token_batch(cfg.vocab_size, BATCH, PROMPT, seed=3)
    reset_launches()
    kernel = sgd_step(cfg, params, batch)
    results["train_launches_remat_off"] = check_launches("train step, remat off", LAYERS)
    with plain_attention():
        plain = sgd_step(cfg, params, batch)
    results["train_grad_rel_vs_plain"] = compare_step(
        "train step flagship, kernel vs plain", kernel, plain, TRAIN_LOSS_REL, TRAIN_GRAD_REL)
    del plain
    for policy, want in (("full", 2 * LAYERS), ("dots", LAYERS)):
        reset_launches()
        # "full" re-runs each layer's forward, kernel included, in the
        # backward; "dots" keeps the attention output and re-runs no kernel.
        remat = sgd_step(replace(cfg, remat=True, remat_policy=policy), params, batch)
        results[f"train_launches_remat_{policy}"] = check_launches(
            f"train step, remat {policy!r}", want)
        compare_step(f"train step flagship, remat {policy!r} vs off", remat, kernel,
                     TRAIN_LOSS_REL, TRAIN_GRAD_REL)
        del remat
    from jobset_tpu_torch.models import build_eval_step

    reset_launches()
    eval_loss = float(build_eval_step(cfg)(params, batch))
    results["eval_launches"] = check_launches("eval step", LAYERS)
    check(abs(eval_loss - kernel[0]) <= TRAIN_LOSS_REL * abs(kernel[0]),
          f"eval step flagship: loss {eval_loss:.6f} vs the train step's {kernel[0]:.6f}")
    del kernel
    torch.cuda.empty_cache()

    # The block backward at the training shape: device time of one call
    # (recompute, dW.V^T, dlogits, dq, dk, dv; each [B,H,T,T] f32 tensor
    # is 512 MB, far past L2), against the forward kernel at that shape.
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = make_qkv(torch.bfloat16, BATCH, PROMPT, PROMPT, 16, 64, 16, gen, fused=True)
    bias = make_bias("triangle", PROMPT, PROMPT)
    dsum = torch.randn((BATCH, 16, PROMPT), generator=gen, device="cuda")
    dw = torch.randn((BATCH, PROMPT, 16, 64), generator=gen, device="cuda")
    needs = (True, True, True, False)
    bwd_ms = cuda_ms(lambda: fb._block_attention_bwd(q, k, v, bias, dsum, dw, needs), 5)
    results["block_backward_ms"] = bwd_ms
    print(f"block backward bf16 [8,1024,16,64] triangle: {bwd_ms:.3f} ms a call, "
          f"{LAYERS * bwd_ms:.3f} ms a step ({LAYERS} layers; {card})", flush=True)
    # Its products: bf16 operands with an f32 result (the path taken)
    # against the same product on operands upcast to f32 (TF32 off).
    a, b = fb._heads_first(dw.to(torch.bfloat16)), fb._heads_first(v).transpose(1, 2)
    results["backward_product_ms"] = {
        "bf16_out_f32": cuda_ms(lambda: fb._bmm_f32(a, b), ITERS),
        "f32_upcast": cuda_ms(lambda: torch.bmm(a.float(), b.float()), ITERS),
    }
    print(f"backward product dW.V^T [128,1024,64]x[128,64,1024]: bf16 with f32 result "
          f"{results['backward_product_ms']['bf16_out_f32']:.4f} ms, f32 upcast "
          f"{results['backward_product_ms']['f32_upcast']:.4f} ms ({card})", flush=True)
    del a, b
    del q, k, v, dsum, dw

    # The trace of one warm flagship train step (remat off, adam).
    from jobset_tpu_torch.models import build_train_step
    from jobset_tpu_torch.runtime import optim

    opt = optim.adam(1e-3)
    state = opt.init(params)
    step = build_train_step(cfg, opt)
    params, state, _ = step(params, state, batch)  # warm-up
    holder = {}

    def one_step():
        holder["out"] = step(params, state, batch)

    trace = traced(one_step, f"train step (B={BATCH}, T={PROMPT}, remat off, adam)")
    if trace is not None:
        trace["block_backward_share"] = LAYERS * bwd_ms / trace["device_busy_ms"]
        print(f"block backward share of the step's device busy time: "
              f"{trace['block_backward_share']:.1%} ({LAYERS} x {bwd_ms:.3f} ms)", flush=True)
    results["train_trace"] = trace
    del params, state, holder, step
    torch.cuda.empty_cache()

    # A small f32 GQA config: the card's kernel path against the CPU's.
    small = TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                              n_layers=2, dtype=torch.float32, remat=False)
    small_params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    small_batch = token_batch(128, 4, 64, seed=5, device="cpu")
    before = launches_now()["FMA_LAUNCHES"]
    card_step = sgd_step(small, to_device(small_params, "cuda"),
                         {k: t.cuda() for k, t in small_batch.items()})
    check(launches_now()["FMA_LAUNCHES"] - before == small.n_layers,
          "small f32 train step: one FMA-variant launch per layer")
    compare_step("small f32 train step, card vs CPU plain path", card_step,
                 sgd_step(small, small_params, small_batch, device="cpu"),
                 F32_LOSS_REL, F32_GRAD_REL)


# ---------------------------------------------------------------------------
# Phase 8: the worker
# ---------------------------------------------------------------------------


def run_worker(workload_file, restart_attempt):
    env = dict(os.environ, JOBSET_RESTART_ATTEMPT=str(restart_attempt))
    env.pop("JOBSET_WORKLOAD", None)
    run = subprocess.run(
        [sys.executable, "-m", "jobset_tpu_torch.runtime.worker", "--workload-file",
         workload_file], capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    lines = run.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines else None
    if run.returncode not in (0, 1):
        print(run.stderr[-2000:], file=sys.stderr)
    return run.returncode, result


def phase_worker(results):
    import tempfile

    small = {"vocab_size": 256, "d_model": 128, "n_heads": 4, "d_ff": 256, "n_layers": 2}
    with tempfile.TemporaryDirectory() as tmp:
        def workload(name, **kw):
            path = os.path.join(tmp, f"{name}.json")
            with open(path, "w") as f:
                json.dump({"kind": "lm", "steps": 6, "config": small, **kw}, f)
            return path

        rc, straight = run_worker(workload("straight"), 0)
        check(rc == 0 and straight is not None and straight["steps"] == 6,
              f"worker: uninterrupted run exits {rc} with its result line")
        launches = (straight or {}).get("kernel_launches", {})
        check(launches.get("FMA_LAUNCHES", 0) >= 6 * small["n_layers"]
              and launches.get("TENSOR_CORE_LAUNCHES") == 0,
              f"worker: the f32 run launched the FMA variant ({launches})")
        crashing = workload("crashing", checkpoint_every=2,
                            checkpoint_dir=os.path.join(tmp, "ckpt"), fail_at_step=3)
        rc_fail, failed = run_worker(crashing, 0)
        check(rc_fail == 1 and failed is not None and "step 3" in failed.get("failed", ""),
              f"worker: the run with fail_at_step=3 exits {rc_fail} and says where it failed")
        rc_resume, resumed = run_worker(crashing, 1)
        ok = rc_resume == 0 and resumed is not None and straight is not None
        check(ok and resumed["steps"] == 4
              and abs(resumed["final_loss"] - straight["final_loss"])
              <= 1e-5 * abs(straight["final_loss"]),
              f"worker: restart attempt 1 resumes at step 2 and ends at the uninterrupted "
              f"loss ({(resumed or {}).get('final_loss')} vs {(straight or {}).get('final_loss')})")
    results["worker"] = {"straight": straight, "failed": failed, "resumed": resumed}


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
    libraries = cuda_build.build_all(["flash_block"])
    results["build_s"] = time.perf_counter() - t0
    print(f"build: {results['build_s']:.2f} s", flush=True)
    for name, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "error")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    results["sass"] = tensor_core_sass(libraries["flash_block"])

    kernels = phase_kernels()

    cfg = flagship_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for d in (params, params["layers"]) for t in d.values()
                   if torch.is_tensor(t))
    print(f"flagship params: {n_params / 1e6:.1f} M", flush=True)
    phase_forward(params, results)
    phase_generate(params, results)
    phase_trace(params, results)
    del params
    torch.cuda.empty_cache()
    phase_train(results)
    phase_worker(results)

    counters = {"flash_block": "TENSOR_CORE_LAUNCHES",
                "flash_block_tile_classes": "TILE_CLASS_LAUNCHES"}
    for kernel in kernels:
        counter = counters[kernel["name"]]
        kernel["launches"] = results["launches"][counter]
        kernel["forward_launches"] = results["forward_launches"][counter]
        kernel["train_step_launches"] = results["train_step_launches"][counter]
        kernel["train_step_launches_by_remat"] = {
            policy: results[f"train_launches_remat_{policy}"][counter]
            for policy in ("off", "full", "dots")}
        kernel["eval_step_launches"] = results["eval_launches"][counter]
    results["kernels"] = kernels
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
