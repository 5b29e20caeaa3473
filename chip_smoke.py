#!/usr/bin/env python3
"""Smoke run of the PyTorch port (jobset_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py [--out RESULTS.json] [--solver-only | --flash-only |
                                                 --control-only | --serving-only |
                                                 --moe-only | --moe-train-only |
                                                 --workloads-only | --gang-only |
                                                 --sp-only | --pp-only | --ep-only |
                                                 --mesh-serving-only]

(`--solver-only` builds the auction kernel and runs phase 9 alone,
`--flash-only` builds the flash block kernels and runs phases 2-3 alone,
`--control-only` runs phase 10 alone and builds nothing, `--serving-only`
builds the flash block and int8 kernels and runs phase 11 alone,
`--moe-only` builds the flash block, int8 and grouped kernels and runs
phase 12 alone, `--moe-train-only` builds the flash block and grouped
kernels and runs phase 13 alone, `--workloads-only` builds the flash block
kernels and runs phase 14 alone, `--gang-only` builds the flash block and
grouped kernels and runs phase 15 alone, `--sp-only` builds the flash
block kernels and runs phase 16 alone, `--pp-only` builds the flash block
and grouped kernels and runs phase 17 alone, `--ep-only` builds the same
and runs phase 18 alone, `--mesh-serving-only` builds the flash block,
int8 and grouped kernels and runs phase 19 alone; none of them prints the
result line.) Phases, in order; any failure exits
non-zero before the result line:
  1. the card's name and power limit (nvidia-smi); TF32 off;
  2. build every CUDA kernel from this checkout (one nvcc per source, all
     started together) and print the build seconds, the ptxas report (the
     f32 block kernel's registers and spills on a line of their own) and
     the tensor-core instructions in each kernel's SASS (the bf16 block
     kernel must have HGMMA, i.e. wgmma; the f32 one HMMA, i.e. mma.sync;
     both bf16 backward passes HGMMA and UTMALDG, TMA loads, the f32 ones
     HMMA), with each backward pass's ptxas registers and spills;
  3. hold each kernel (the flash block step in both dtype variants, and
     the tile-class pass) against its plain PyTorch version on the
     card, at the flagship prefill shape with six bias kinds and at edge
     shapes; every block case runs both host paths, the one call that
     launches the pass and the block kernel under programmatic dependent
     launch (PDL) and the call given the classes, which must agree bit for
     bit; the pass at [512,512] and [1024,1024] under every bias kind. Time
     the kernel (given classes), the PDL call, the plain version and the
     nearest PyTorch library call at the flagship and forward shapes, in
     bf16 and in f32 (the f32 variant beside two bounds: its own 3xTF32
     arithmetic and true f32 on the FMA pipes), rotating
     input sets larger than the 50 MB L2 (L2-cold); the pass alone at both
     shapes; and the host time of one `generate`'s 24 block calls under
     no_grad, through the wrapper, through the autograd.Function, straight
     to the launch, and as the main path makes them (masks and classes
     from `constant_mask`);
  4. the flagship forward (`build_forward`) at B=8, T=1024 (the mask
     cache emptied first, so its one mask is built and classified): finite
     logits
     that match the plain path on the card, and a small config that
     matches the plain path on the CPU;
  5. the flagship greedy `build_generate` at B=8, prompt 1024, 32 new
     tokens: kernel launches counted per variant across the first run
     after the mask cache is emptied (all on the tensor-core variant; one
     tile-class pass per mask) and across a second run (no pass), prefill
     logits against the plain path,
     tokens/s and time to first token (medians of a few more calls);
  6. a torch.profiler trace of one warm first-token call: the top 10
     device ops by device time, the number of device ops and the card's
     idle share;
  7. training at the flagship width and depth: `run_model_bench` (B=8,
     T=1024, remat off, adam 1e-3; 8 block launches a step, all on the
     tensor-core variant), one train step through the kernel against the
     same step through the plain version (loss and every gradient leaf),
     remat "full" (16 launches a step) and "dots" (8), the eval step
     (8), tile-class passes only on the first step at a shape, the block
     backward's device time at the training shape (each pass alone, the
     plain version and SDPA's backward, all L2-cold; with
     `--flash-bwd-baseline DIR`, that checkout's backward kernel on the
     same inputs, held to this one's and timed in turns), a
     torch.profiler trace of one warm train step, and a small f32
     config's step on the card against the CPU;
  8. the worker (`python -m jobset_tpu_torch.runtime.worker`) in a
     subprocess on a small f32 LM workload with checkpoints: an
     uninterrupted run, a run that fails at a step, and its restart,
     which resumes from the checkpoint and ends at the uninterrupted
     run's loss; the f32 variant's counter moves;
  9. the placement solver plane at the 15k-node shape (512 jobs x 960
     domains) and a 100k-node one (512 x 6250): the auction kernel against
     its plain version on the card (assignments, iterations and prices
     identical) on the structured production surface, the heterogeneous
     dense surface (also exactly optimal against scipy), an 8-problem
     structured storm, a dense batch, the 100k shape and edge cases; the
     kernel's device time, iterations and bound, the plain version's time
     and scipy's on the host; the SM clock under load (nvidia-smi), which
     turns the kernel's own cycle counts into µs a round split into the
     bidder list, the bids and the resolution, with warp 0's latency per
     full scan and per cached bid, the share of bids the candidate lists
     answered and the bytes the kernel read against the bound's;
     solve wall p50/p99 through `AssignmentSolver`;
     `solve_async` shown not to block; the sidecar's handlers on packed
     frames against direct solves; launch counts per path. The obs hooks,
     the tracer's duration log and the solve-time histogram's raw samples
     on from an empty registry: each path's trace holds the reference's
     spans and parent links, the histogram counts every solve made, each
     distinct compile key misses once (`jobset_jit_compiles_total` per
     kernel equal), the h2d bytes per kernel equal the copies' nbytes;
     p50/p99 of the phase spans (host_transfer, dispatch, solve_loop,
     readback) per path, `jobset_jit_compile_seconds` per kernel, and one
     span's cost (10,000 empty `span()` blocks, 10,000 `record_span`
     calls) beside the solves' wall p50; the hooks' host cost in place:
     structured and dense solves in turns with the hooks live (the
     duration log and raw samples on, then off) and with every hook a
     no-op, wall p50 of each, and each hook's part alone
     (`jit_shape_call`'s signature, the gauge sets, `Histogram.observe`,
     an `activate=True` span, `record_span`, `note_transfer`);
 10. the control plane's device programs, torch code with no hand kernel,
     each held on the card to the port's CPU path and plain versions: the
     admission scorer (queue/scorer.py) at the queue bench's shape (64
     queues, 1 resource, 8 cohorts, 512 candidates; bench values and
     quotas in steps of 0.1) and at 1024 queues x 8 resources x 64
     cohorts x 16384 candidates (steps of 0.1), feasibility and both share
     vectors bit for bit against the greedy numpy path; the gang-readiness
     aggregate (core/columnar.py) at 16384 pods x 1024 jobs and 2^20 x
     2^16 (10% dead rows, all four phases), equal to numpy bincount; the
     policy MLP (policy/model.py) at 960 and 6250 candidate domains, also
     with TF32 matmuls allowed in the process; the trainer
     (policy/train.py) on a seeded corpus of 16384 examples, 200 epochs,
     twice on the card (byte-identical checkpoints) and once on the CPU.
     For each: wall p50/p99 (host clock to the result on the host), the
     device program's time by CUDA events, the CUDA kernels a call
     launches and their device busy time (torch.profiler), the plain
     path's time and a bound at 3.35 TB/s. First, from an empty registry
     and empty factory caches, a known call sequence through each program
     (a bucket shape repeated): compiles, cache hits and misses equal what
     it implies, transfer bytes equal the copies' nbytes; at the end, one
     miss per bucket shape over the whole phase, and `render_prometheus()`
     of the eight families. The phase runs in a process of its own
     (`--control-only`), where the profiler has not traced before;
 11. the serving path with int8 weights, the int8 KV cache and sampling,
     in a process of its own (`--serving-only`): the int8 decode kernel
     (`ops/csrc/int8_matmul.cu`) against its plain version at the flagship
     decode step's launches (x [8, K] against the grouped Q/K/V [1024,
     3 x 1024], [1024, 1024], [1024, 4096], [4096, 1024], [1024, 32000]),
     grouped launches (MHA and GQA widths, 1, 8 and 16 rows) equal to their
     members' separate launches bit for bit, and edge shapes (N not a
     multiple of 16, K not a multiple of the stage), in bf16 and f32, two
     launches equal bit for bit, the built kernel's layout tables equal to
     the wrapper's, ptxas registers and spills; L2-cold times (bf16 and
     f32) beside the bound, the plain version and torch.matmul on the
     dequantized weight, back to back and after an elementwise kernel (the
     path's pattern), and a decode step's launches summed against the bf16
     path's 49 products (`--int8-baseline DIR` also times another
     checkout's kernel on the same inputs); host time a call; the flagship
     tree quantized on the card equal to the CPU's bit for bit; `generate`
     (prompt 1024, 32 new) and a TTFT call for `decode`, `decode_int8` and
     `decode_int8_kv`, counts set to 0 just before each: int8 launches 1024
     and 1 on the int8 paths, 0 on bf16, flash launches 24 everywhere; a
     sampled int8 generate (temperature 0.9, top_k 4); a torch.profiler
     trace of one warm decode step per variant (the int8 kernel's device
     time in it); `run_decode_bench` for the three points at prompt 32 /
     96 new and 1024 / 32 (tokens/s, TTFT; medians of 3 rounds, the points
     in turns);
     and on a small f32 GQA config, card tokens equal to the CPU's with
     int8 weights, the int8 cache and both, top_k=1 equal to greedy, and
     all-tied logits with top_k 2 drawing only tokens 0 and 1;
 12. mixture-of-experts serving and forward, in a process of its own
     (`--moe-only`), on the MoE flagship (the flagship with 8 experts of
     d_ff_expert 4096, token-choice top 2, dropless): the grouped expert
     kernels (`ops/csrc/grouped_matmul.cu`) against their plain version at
     the prefill's two products ([16384, 1024] x [8, 1024, 4096] and
     [16384, 4096] x [8, 4096, 1024]) with balanced, skewed, empty-group
     and mid-tile boundary routings, bf16 (the TMA/wgmma kernel) and f32
     (3xTF32), each launch counted on its variant, two launches equal bit
     for bit; the grouped library's ptxas registers and spills and its
     SASS (HGMMA and UTMALDG in the TMA kernel, HMMA in the others); their
     L2-cold times beside the bound, the plain version, a torch.matmul a
     group and torch._grouped_mm (`library_ms`, where it runs)
     (`--grouped-baseline DIR` also times that checkout's grouped kernel
     on the same inputs); the int8
     kernel's expert axis at the decode step's two stacks against each
     expert's 2-D launch bit for bit, and its times; the dropless forward
     at B=8, T=1024 (16 grouped launches, two runs the same bits) and the
     generate prefill, each layer against the plain grouped products on
     the same input; `generate` (prompt 1024, 32 new) and a TTFT call for
     `decode`, `decode_int8` and `decode_int8_kv`, counts set to 0 just
     before each: 16 grouped launches each, all on the TMA/wgmma kernel,
     int8 1024 and 1, flash 24; a
     prefill and a decode layer under `set_sync_debug_mode("error")`,
     bf16 and int8; a torch.profiler trace of a TTFT call and a decode
     step, bf16 and int8; `run_decode_bench` for the three points (two
     runs each); a small f32 MoE config's tokens on the card equal to the
     CPU's, plain and with int8 weights, cache and both (its f32 generate
     counts the f32 grouped kernel's launches, its `kernels` entry);
     the dropless forward's 16 launches also all on the TMA kernel;
 13. mixture-of-experts training, in a process of its own
     (`--moe-train-only`), on the MoE flagship: the grouped product's
     backward kernels against their plain versions at the two products
     with the four routings of phase 12, bf16 and f32 (dgrad: the
     forward's TMA kernel reading w K-major in bf16, w copied to [E, N, K]
     for the forward's f32 kernel; wgrad: `grouped_wgrad_*_kernel`,
     ragged on the contraction, f32 on `grouped_wgrad_f32_tma_kernel`),
     one launch counted on the dtype's variant, two launches equal bit for
     bit, empty experts' weight gradients exactly 0; their L2-cold times,
     balanced and skewed (dgrad with and without its copy), beside the
     bound, the plain version and torch._grouped_mm (`library_ms`, its
     ragged-K form for wgrad, where it runs), and the bf16 wgrad kernel's
     cost a tile change (balanced against skewed time over the busiest
     block's extra tiles); `--grouped-baseline DIR` also holds each output
     to that checkout's kernels bit for bit (f32 wgrad, which adds in
     another order: both within the tolerance of the plain version) and
     times them on the same inputs, in turns; the grouped library's SASS
     (the bf16 wgrad TMA kernel's TMA stores, UTMASTG; HGMMA and UTMALDG
     in the f32 one) and `cuobjdump -res-usage` (both wgrad TMA kernels:
     168 registers, no local memory); the main
     path, `run_model_bench` (B=8, T=1024, remat off, adam, median of 20
     steps; tokens/s, MFU at activated FLOPs, peak memory) with 16
     forward, 16 dgrad and 16 wgrad grouped launches a step, all bf16;
     the step in f32 at full width and depth through the kernels against
     the same step on the plain grouped products (its 16 wgrad launches
     all on the f32 TMA kernel), and remat "full" and "dots" (32 forward
     launches a step: the reference recomputes its ragged products under
     both) against none; a torch.profiler trace of one warm f32 step with
     its grouped kernels' device time; each bf16 layer's forward
     and backward against its plain grouped products on the same input;
     a layer's forward and backward under `set_sync_debug_mode("error")`;
     a torch.profiler trace of one warm bf16 step with the forward's,
     dgrad's and wgrad's grouped device time; and a small f32 MoE config's
     step on the card against the CPU's (its launches count the f32
     backward kernels' entries);
 14. the remaining workload kinds, in a process of its own
     (`--workloads-only`), each on the card against the port's CPU path:
     `train_workload` of kind mlp (mlp-checkpoint.yaml's widths), and a
     payload with no kind (the reference's default, mlp); mlp-checkpoint.yaml's
     payload through the port's `WorkloadRunner` over a stand-in cluster
     (`StandInCluster`: a failed child job restarts the gang while
     maxRestarts allows): it fails at step 5, the gang restarts, the rerun
     resumes from step 4's checkpoint and completes, and its final-loss
     annotation equals the CPU's; `train_workload` of kind cnn at the
     runner's default payload (B=8, 32x32, bf16) and a small f32 CNN's
     step (loss and every gradient leaf, cuDNN's TF32 off); the default
     CNNConfig on CIFAR-10's shape at B=128 (He et al. 2016, sec. 4.2):
     median step of 20 after 3, images/s, FLOPs a step from the conv
     shapes, MFU against 989 TFLOP/s, peak memory and a torch.profiler
     trace of one warm step; the dense flagship's train step (B=8,
     T=1024, remat off, phase 7's inputs) under adafactor beside adam:
     median step, peak memory, the optimizer state's bytes, the update's
     own device time in a trace, 8 flash launches a step; and a small f32
     LM's two adafactor steps (factored and unfactored leaves). No flash
     launch on the mlp and cnn paths;
 15. the gang, in a process of its own (`--gang-only`; the kernels built
     in the parent before any rank starts, and the grouped forward, dgrad
     and wgrad kernels held there against their plain versions at a
     rank's products in (c), bf16 and f32): gangs of processes on
     `torch.distributed` (`runtime.gang.spawn`), each rank a process on the
     one card, held against a single-process run on the card with the same
     parameters and batches (`gang_reference`): (a) NCCL at world 1, the
     dense flagship's gradient step and 3 adam steps (phase 7's inputs, 2
     of its 8 layers) bit for bit; (b) the dense flagship (2 layers) at
     tp = 2 (8 heads of 64 a rank)
     and a small f32 config at tp = 2, two ranks on gloo with CUDA tensors
     (NCCL refuses two ranks on one device); (c) the MoE flagship at dp =
     2 x tp = 2 at 1 of its 8 layers, four ranks (we1 [8, 1024, 2048] a
     rank), held on its
     losses in bf16 (bf16 routes apart end to end; every bf16 wgrad launch
     on the TMA kernel) and on its gradients and first adam step by the
     same gang in f32, where it prints which tokens took other experts
     and where the moves stray (`--gang-f32-moe-batch B` runs that gang
     alone at batch B); (d)
     examples/training/lm-moe-dropless.yaml through `WorkloadRunner` as 4
     worker processes, to Completed, its final loss against the CPU
     gang's. Each rank prints its flash and grouped launches of one step,
     its step time, peak memory, and from a torch.profiler trace of one
     step the share of the step inside collective ops and the card's busy
     share (ranks sharing one card: no scaling figure). (b), (c) and its
     f32 run are one gang of four (tp 2 on ranks 0 and 1), (a) runs in
     the process that takes the single-process references, and in phases
     15-18 the untimed gangs run beside the timed ones, so that the whole
     run fits its limit on a slow host: their step times are information;
 16. sequence parallelism and ZeRO-1, in a process of its own
     (`--sp-only`): (a) the flash block kernel at the ring's blocks of
     the flagship at sp = 2, [8, 512, 16, 64], bf16 and f32, under the
     causal, zero and fully masked constant masks (classes given, as the
     ring gives them), against the plain version, each merged into a
     real accumulator and differentiated (the masked block must leave
     the accumulator as it was, bit for bit); (b) the dense flagship at
     sp = 2 at 2 of its 8 layers, ring and Ulysses, two ranks on gloo
     (B=8, T=1024, remat
     off): a gradient step and 3 adam steps against one process at
     phase 15 (b)'s bounds, 8 (ring) and 12 (Ulysses) flash launches
     and 2 tile-class passes on a rank's first step, the median step,
     peak memory, the bytes saved for the backward, and the collective
     share from a traced step; a small f32 config at sp = 2 against the
     port's CPU gang (1e-5); (c) ZeRO-1 at dp = 2: adam's parameters
     after 3 steps equal the run without it bit for bit, adafactor's
     within 1e-6, the state's bytes and peak memory a rank; (d) the
     dense flagship at one 8192-token sequence in one process and as a
     ring at sp = 2 (losses and gradients at (b)'s bounds, peak memory);
     (e) lm-adafactor.yaml (2 processes) and lm-long-context.yaml (4)
     through `WorkloadRunner` on the card, to Completed, final losses
     within 1e-4 of the CPU gangs'; (f) the port's gather, rotate and
     all_to_all of CUDA tensors on gloo, f32 and bf16, bit for bit, and
     gloo's send/recv of them (information: the port does not use it);
 17. pipeline parallelism, in a process of its own (`--pp-only`): (a) the
     dense flagship at 4 of its 8 layers at pp = 2 (2 layers a rank),
     B=8, T=1024, 4 microbatches, remat off, two ranks on gloo, under
     gpipe, the interleave (pipeline_virtual 2, on the
     permuted tree) and 1f1b: a gradient step and 3 adam steps against
     one process at phase 15 (b)'s bounds, 8 bf16 flash launches a rank's
     step, the median step,
     peak memory, and from a traced step the shares in the shifts
     (all-to-all) and the all-reduces; (b) at 8 microbatches of one row,
     each rank's peak over what it held before its step under gpipe and
     under 1f1b; (c) the small f32 configs at 4 layers, dense under each
     schedule and MoE dropless top-2 under gpipe and the interleave,
     against the port's CPU gang (1e-5), with the grouped launches a
     rank's step; (d) lm-pp-interleaved.yaml through `WorkloadRunner` as 4
     processes on the card, to Completed, its final loss within 1e-4 of
     the CPU gang's;
 18. expert parallelism, in a process of its own (`--ep-only`): (a) the
     grouped forward, dgrad and wgrad kernels, bf16 (TMA) and f32, at an
     ep = 2 rank's products of the MoE flagship (xs [16384, 1024] and
     [16384, 4096] against 4 experts' we1 and we2), rank 0's group sizes
     from a router's top-2 picks (about half the rows in the foreign
     tail) and with every row foreign: against their plain versions, the
     tail's rows of forward and dgrad exactly 0, and another fill of the
     tail moving no covered output and no bit of dw; each timed beside
     the same call at ep = 1; (b) the MoE flagship at ep = 2 (4 of 8
     experts a rank, dropless top-2, 4 of its 8 layers), B=8, T=1024,
     remat off,
     two ranks on gloo: a gradient step and 3 adam steps against one
     process (held on its losses, as 15 (c)), a rank's flash and grouped
     launches of one step, the median step, peak memory, and from a traced
     step the share in the all-reduces and the card's busy share; (c) a
     small f32 MoE config under every router at ep = 2 and dropless at
     (pp 2, ep 2) under gpipe, against the port's CPU gang (1e-5), with
     the grouped launches a rank's step; (d) lm-moe-dropless.yaml's
     payload at mesh {ep: 2} through `WorkloadRunner` as 2 worker
     processes on the card, to Completed, its final loss within 1e-4 of
     the CPU gang's;
 19. serving and the forward over a mesh, in a process of its own
     (`--mesh-serving-only`): (a) the int8 kernel at a tp = 2 rank's
     decode products of the dense and MoE flagships, bf16 (Q/K/V a group
     of [1024, 3 x 512], wo [512, 1024], w1 [1024, 2048], w2 [2048, 1024],
     the unembedding [1024, 16000], the expert stacks [8, 1024, 2048] and
     [8, 2048, 1024]; each the rank's shard of a weight quantized whole)
     against its plain version, the two ranks' row-parallel products
     summed against the whole weight's, and each timed L2-cold beside
     the same call at tp = 1, with its bound; (b) the dense flagship at tp
     = 2, 8 layers, B=8, prompt 1024, 32 new, greedy in bf16 and with int8
     weights and the int8 cache, two ranks on gloo, against one process:
     the prefill's last-position logits gathered over tp within phase 4's
     bounds, the tokens equal up to each row's first position whose top-2
     margin is under that bound, a sampled run (temperature 0.9, top_k 4)
     alike on both ranks and top_k 1 equal to greedy; (c) the MoE
     flagship at dp 2 x tp 2, 2 of its 8 layers, int8 weights, four ranks,
     held as (b); (d) `build_forward` of the dense flagship at pp = 2, 4
     of its layers, 4 microbatches, against one process's logits, and a
     small f32 config's at sp = 2 (ring) and its MoE at ep = 2 (dropless);
     (e) a small f32 config's tokens at tp 2 and dp 2 x tp 2 (f32, and
     int8 weights with the int8 cache) equal to the port's CPU gang's.
     Each rank prints its flash, tile-class, int8 and grouped launches of
     one `generate` call, its TTFT and new tokens/s (ranks sharing one
     card: no scaling figure), and from a trace of one call the share in
     collective ops and the card's busy share;
 20. one `kernels` JSON line (with each kernel's launches on the gang's,
     the sp, the pp, the ep and the mesh-serving paths, the grouped
     kernels' times at an ep rank's products and the int8 kernel's at a
     tp rank's), then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The flagship is the repo's training/decode bench config: vocab 32000,
d_model 1024, 16 heads (head_dim 64), d_ff 4096, 8 layers, bf16 compute,
f32 params, weights random from a seed; the MoE flagship replaces each
layer's MLP by 8 experts. The placement problems are made
with numpy from seeds. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace as NS

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and
# FLOP/s of bf16 and TF32 on the tensor cores and of f32 on the FMA pipes.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS, TF32_FLOPS, F32_FMA_FLOPS = 989e12, 495e12, 67e12
# The arithmetic each block-kernel variant performs for one product of the
# function: (peak FLOP/s, passes). The f32 variant is 3xTF32: three TF32
# products for each f32 one.
PRODUCT_RATE = {torch.bfloat16: (BF16_FLOPS, 1), torch.float32: (TF32_FLOPS, 3)}

# Stated tolerances (rtol, atol), kernel against plain version on the same
# inputs; each bound is max|got - want| <= atol + rtol * max|want| over the
# tensor. f32: 3xTF32 in the kernel (errors near 2^-22 of each product,
# about f32's own rounding) against true f32 in another order; the plain
# version runs with TF32 off (`plain_is_f32`). bf16: operands are exact
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

    def plain(q, k, v, bias, classes=None):
        return flash_block.block_attention_reference(q, k, v, bias.float())

    flash_block.block_attention = plain
    try:
        yield
    finally:
        flash_block.block_attention = real


LAUNCH_COUNTERS = ("KERNEL_LAUNCHES", "TENSOR_CORE_LAUNCHES", "F32_LAUNCHES",
                   "TILE_CLASS_LAUNCHES", "BACKWARD_LAUNCHES", "BACKWARD_F32_LAUNCHES",
                   "BACKWARD_F32_MMA_LAUNCHES")


def f32_backward_by_variant(counts) -> dict:
    """A run's f32 backward launches by variant: tf32 wgmma fed by TMA, and
    the mma.sync kernels (views TMA cannot take, other D)."""
    if not counts or counts.get("BACKWARD_F32_LAUNCHES") is None:
        return None
    mma = counts.get("BACKWARD_F32_MMA_LAUNCHES", 0)
    return {"tma": counts["BACKWARD_F32_LAUNCHES"] - mma, "mma_sync": mma}


def reset_launches():
    from jobset_tpu_torch.ops import flash_block as fb

    for name in LAUNCH_COUNTERS:
        setattr(fb, name, 0)


def empty_mask_cache():
    """Empty the port's constant-mask cache, so the next run at a shape
    builds and classifies its masks again."""
    from jobset_tpu_torch.ops import flash_block as fb

    fb.constant_mask.cache_clear()


def check_launches(path, expected, passes, backward=0):
    """Read the counters after a bf16 run of `path`: every block launch went
    through the tensor-core variant, the tile-class pass ran `passes` times
    (once for each constant mask the run built), and the backward kernel
    `backward` times, all in bf16."""
    counts = launches_now()
    check(counts == {"KERNEL_LAUNCHES": expected, "TENSOR_CORE_LAUNCHES": expected,
                     "F32_LAUNCHES": 0, "TILE_CLASS_LAUNCHES": passes,
                     "BACKWARD_LAUNCHES": backward, "BACKWARD_F32_LAUNCHES": 0,
                     "BACKWARD_F32_MMA_LAUNCHES": 0},
          f"{path}: launches {counts} (expected {expected} block launches, all on the "
          f"tensor-core variant, {passes} tile-class passes and {backward} bf16 backward "
          "launches)")
    return counts


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UTMASTG")


def sass_counts(library) -> dict:
    """Count the tensor-core instructions (HGMMA: wgmma, HMMA: mma.sync)
    and the TMA loads and stores (UTMALDG, UTMASTG) in each kernel of a
    built library's SASS."""
    from jobset_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                counts[name][op] += f" {op}." in line or f" {op} " in line
    for name, c in counts.items():
        print(f"  sass {name}: " + ", ".join(f"{op} {c[op]}" for op in SASS_OPS), flush=True)
    return counts


def tensor_core_sass(library) -> dict:
    """The flash block library's SASS: the bf16 block kernel must have
    HGMMA, the f32 one HMMA."""
    counts = sass_counts(library)
    tc = {n: c for n, c in counts.items() if "flash_block_tc_kernel" in n}
    check(bool(tc) and all(c["HGMMA"] > 0 for c in tc.values()),
          f"sass: every bf16 tensor-core kernel instantiation has HGMMA ({len(tc)} found)")
    f32 = {n: c for n, c in counts.items() if "flash_block_f32_kernel" in n}
    check(bool(f32) and all(c["HMMA"] > 0 for c in f32.values()),
          f"sass: every f32 block kernel instantiation has HMMA ({len(f32)} found)")
    return counts


# Registers a thread of a TMA kernel starts with (65536 / 384 threads,
# rounded down to 8): setmaxnreg then moves them to 40 / 232.
WGRAD_TMA_REGS = 168


def resource_usage(library) -> dict:
    """`cuobjdump -res-usage` of a built library: each kernel's registers,
    stack, shared and local bytes ({"REG": 168, "STACK": 0, ...})."""
    import re

    from jobset_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-res-usage", str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    usage, name = {}, None
    for line in text.splitlines():
        if m := re.search(r"Function (\S+):", line):
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            name = None
    return usage


def grouped_sass(library) -> dict:
    """The grouped library's SASS: the TMA kernel (both instantiations)
    and the wgrad TMA kernels (bf16 and f32) load by TMA (UTMALDG) into
    wgmma (HGMMA), with no local memory and the setmaxnreg hand-over's
    registers at entry; the forward's f32 and other bf16 kernels, and the
    wgrad fallbacks, run mma.sync (HMMA)."""
    counts = sass_counts(library)
    tma = {n: c for n, c in counts.items() if "grouped_mm_tma_kernel" in n}
    check(len(tma) == 2 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in tma.values()),
          f"sass: both instantiations of the grouped TMA kernel (w N-major for the forward, "
          f"K-major for dgrad) have HGMMA and UTMALDG ({tma})")
    mma = {n: c for n, c in counts.items()
           if "grouped_mm_f32_kernel" in n or "grouped_mm_bf16_kernel" in n}
    check(len(mma) == 3 and all(c["HMMA"] > 0 for c in mma.values()),
          f"sass: the grouped f32 and mma.sync kernels have HMMA ({len(mma)} found)")
    wgrad = {n: c for n, c in counts.items() if "grouped_wgrad_tma_kernel" in n}
    check(len(wgrad) == 1 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["UTMASTG"] > 0
                                  for c in wgrad.values()),
          f"sass: the bf16 wgrad TMA kernel has HGMMA, UTMALDG and its tiles' TMA stores "
          f"(UTMASTG) ({wgrad})")
    wgrad = {n: c for n, c in counts.items() if "grouped_wgrad_f32_tma_kernel" in n}
    check(len(wgrad) == 1 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in wgrad.values()),
          f"sass: the f32 wgrad TMA kernel has HGMMA (tf32 wgmma) and UTMALDG ({wgrad})")
    usage = resource_usage(library)
    for kernel, what in (("grouped_wgrad_tma_kernel", "bf16"), ("grouped_wgrad_f32_tma_kernel", "f32")):
        wgrad_usage = {n: u for n, u in usage.items() if kernel in n}
        check(len(wgrad_usage) == 1 and all(u.get("REG") == WGRAD_TMA_REGS and u.get("LOCAL") == 0
                                            and u.get("STACK") == 0 for u in wgrad_usage.values()),
              f"cuobjdump: the {what} wgrad TMA kernel has {WGRAD_TMA_REGS} registers at entry "
              f"(the setmaxnreg hand-over's), no local memory and no stack, so no spills "
              f"({wgrad_usage})")
    for n, u in usage.items():
        print(f"  res-usage {n}: " + ", ".join(f"{k} {v}" for k, v in u.items()), flush=True)
    wgrad = {n: c for n, c in counts.items()
             if "grouped_wgrad_bf16_kernel" in n or "grouped_wgrad_f32_kernel" in n}
    check(len(wgrad) == 2 and all(c["HMMA"] > 0 for c in wgrad.values()),
          f"sass: the mma.sync wgrad kernels (bf16 and f32 where TMA cannot take the operands) "
          f"have HMMA ({len(wgrad)} found)")
    return counts


def plain_is_f32(what: str) -> None:
    """The plain yardstick's f32 products must be true f32 (no TF32)."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          f"{what}: the plain version's f32 matmuls run in true f32 (TF32 off)")


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
               fused=False, q_scale=1.0, d_stride=1):
    """One comparison of the block kernel, and of the tile-class pre-pass,
    with their plain versions; the variant counter for the dtype must move.
    `q_scale` scales q (large logits); `d_stride` > 1 hands the kernel q, k
    and v as views with that stride on D."""
    from jobset_tpu_torch.ops import flash_block as fb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv_heads = kv_heads or heads
    q, k_c, v_c = make_qkv(dtype, batch, tq, tk, heads, dim * d_stride, kv_heads, gen, fused)
    if q_scale != 1.0:
        q = q * q_scale
    if d_stride > 1:
        q, k_c, v_c = (t[..., ::d_stride] for t in (q, k_c, v_c))
    k = fb._repeat_heads(k_c, heads // kv_heads)
    v = fb._repeat_heads(v_c, heads // kv_heads)
    bias = make_bias(bias_kind, tq, tk)

    classes = fb.tile_classes(bias)
    want_classes = fb.tile_classes_reference(bias)
    classes_err = (classes.int() - want_classes.int()).abs().max().item()
    check(torch.equal(classes, want_classes),
          f"tile_classes {name}: the pass equals the plain version "
          f"({[int((want_classes == c).sum()) for c in range(3)]} tiles of class 0/1/2)")
    counter = "TENSOR_CORE_LAUNCHES" if dtype == torch.bfloat16 else "F32_LAUNCHES"
    before = launches_now()
    got = fb.block_attention(q, k, v, bias)  # one call: the pass, then the kernel under PDL
    given = fb.block_attention(q, k, v, bias, classes=classes)  # the kernel alone
    torch.cuda.synchronize()
    after = launches_now()
    check(after[counter] == before[counter] + 2
          and after["TILE_CLASS_LAUNCHES"] == before["TILE_CLASS_LAUNCHES"] + 1,
          f"flash_block {name}: both calls ran the {counter} variant, the pass ran once")
    check(all(torch.equal(a, b) for a, b in zip(got, given)),
          f"flash_block {name}: the PDL call equals the given-classes call bit for bit")
    if dtype == torch.float32:
        plain_is_f32(f"flash_block {name}")
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
    print(f"flash_block {name}: max|d| max {errs['max']:.3e}, sum {errs['sum']:.3e}, "
          f"weighted {errs['weighted']:.3e}", flush=True)
    return dict(q=q, k=k, v=v, k_c=k_c, v_c=v_c, bias=bias, bias_kind=bias_kind,
                classes=classes, errs=errs, classes_err=classes_err,
                shape=(dtype, batch, tq, tk, heads, dim, kv_heads, fused))


def flash_bound_ms(case, rate=None) -> tuple[float, str]:
    """Least time for one launch: each input read once and each output
    written once at HBM rate, or the products these inputs need (the
    unmasked logits only) in the arithmetic the dtype's variant performs
    (`PRODUCT_RATE`; `rate` = (FLOP/s, passes) overrides it); the larger."""
    q, k_c, v_c, bias = case["q"], case["k_c"], case["v_c"], case["bias"]
    batch, tq, heads, dim = q.shape
    moved = sum(t.numel() * t.element_size() for t in (q, k_c, v_c, bias))
    moved += 4 * (2 * batch * heads * tq + batch * tq * heads * dim)
    unmasked = int((bias > -5e29).sum())
    flops = 4 * batch * heads * dim * unmasked
    peak, passes = rate or PRODUCT_RATE[q.dtype]
    t_bytes = moved / HBM_BYTES_PER_S
    t_ops = passes * flops / peak
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
    given, as the main path gives them), the plain version,
    scaled_dot_product_attention with the same additive mask, and the call
    without classes (one host call: the pass, then the kernel under PDL),
    whose excess over the kernel is the pass's cost on the path
    (`path_ms`); and the kernel alone under each of `other_bias_kinds`
    (`ms_by_bias`)."""
    from jobset_tpu_torch.ops import flash_block as fb

    dtype, batch, tq, tk, heads, dim, kv_heads, fused = case["shape"]
    gen = torch.Generator(device="cuda").manual_seed(100)
    group = heads // kv_heads
    sets = []
    for _ in range(n_sets):
        q, k_c, v_c = make_qkv(dtype, batch, tq, tk, heads, dim, kv_heads, gen, fused)
        sets.append((q, fb._repeat_heads(k_c, group), fb._repeat_heads(v_c, group)))
    bias, classes = case["bias"], case["classes"]
    if dtype == torch.float32:
        plain_is_f32("flash_block timing")
    out = {
        "ms": rotating_ms(lambda i: fb._block_attention_cuda(*sets[i], bias, classes),
                          n_sets, ITERS),
        "call_ms": rotating_ms(lambda i: fb.block_attention(*sets[i], bias), n_sets, ITERS),
        "plain_ms": rotating_ms(lambda i: fb.block_attention_reference(*sets[i], bias),
                                n_sets, ITERS // 4),
    }
    out["path_ms"] = out["call_ms"] - out["ms"]
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
    if dtype == torch.float32:
        out["fma_bound_ms"], out["fma_bound_by"] = flash_bound_ms(case, (F32_FMA_FLOPS, 1))
    return out


def host_call_ms(case, calls=GENERATE_LAUNCHES, repeats=TTFT_REPEATS):
    """Host time to issue `calls` block calls (one `generate`'s prefill
    worth) on one case's inputs: the wrapper under no_grad without classes
    (one host call for the pass and the kernel); the autograd.Function
    under no_grad; the kernel's launch function alone; and the main path's
    way, the mask and its classes from `constant_mask`, then the wrapper
    given them. Median over `repeats`, the four interleaved."""
    from jobset_tpu_torch.ops import flash_block as fb

    args = (case["q"], case["k"], case["v"], case["bias"])
    tq, tk = case["bias"].shape

    def cached_mask():
        bias, classes = fb.constant_mask("causal", tq, tk, case["q"].device)
        return fb.block_attention(*args[:3], bias, classes=classes)

    ways = {
        "block_attention": lambda: fb.block_attention(*args),
        "autograd_function": lambda: fb._BlockAttention.apply(*args, None),
        "kernel_launch": lambda: fb._block_attention_cuda(*args),
        "cached_mask": cached_mask,
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


BIAS_KINDS = ("triangle", "zero", "all_masked", "band", "reverse_triangle", "alibi")


def time_classes(n) -> dict:
    """The pass alone over distinct [n, n] triangle biases, 64 MB of them
    (past the 50 MB L2), against its plain version and its bound."""
    from jobset_tpu_torch.ops import flash_block as fb

    bias = make_bias("triangle", n, n)
    count = max(2, (64 << 20) // (4 * n * n))
    biases = [bias.clone() for _ in range(count)]
    n_classes = fb.tile_classes_reference(bias).numel()
    return {
        "ms": rotating_ms(lambda i: fb._tile_classes_cuda(biases[i]), count, 64),
        "plain_ms": rotating_ms(lambda i: fb.tile_classes_reference(biases[i]), count, 16),
        "bound_ms": 1e3 * (bias.numel() * 4 + n_classes) / HBM_BYTES_PER_S,
    }


# The backward kernel against its plain version, per output: bf16
# max|got - want| <= 2e-2 max|want| + 1e-5 (P and dS are rounded to bf16 as
# operands on both sides, from exponentials that differ in the last bits:
# ex2.approx against the max the forward kept, torch.exp in the plain
# version, so a value on a rounding boundary may fall one bf16 ulp apart);
# f32 1e-4 max|want| + 1e-5 (3xTF32 products, errors near 2^-22 of each,
# against true f32 in another order; TF32 off for the plain version). The
# forward's tolerances, for the same reasons. At the flagship block: the
# relative norm of each output's difference, bf16 1e-2, f32 1e-4.
BACKWARD_TOL = {torch.bfloat16: (2e-2, 1e-5), torch.float32: (1e-4, 1e-5)}
BACKWARD_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
BACKWARD_NEEDS = {"all": (True, True, True, True), "qkv": (True, True, True, False),
                  "q": (True, False, False, False), "kv": (False, True, True, False),
                  "bias": (False, False, False, True)}
MASKED_ROW = 3  # the "band_row" bias: the band, and row 3 masked whole


def flash_backward_case(name, dtype, batch, tq, tk, heads, dim, bias_kind, kv_heads=None,
                        seed=0, fused=False, needs="qkv", d_stride=1):
    """The backward kernel against its plain version on the same inputs (the
    forward kernel's block max, random cotangents), given the outputs
    `needs` names, on the variant the wrapper picks (f32: tf32 wgmma fed by
    TMA where TMA takes the views and D is a multiple of 4 up to 64, else
    mma.sync); two calls
    equal bit for bit (dbias, summed by atomics, within the tolerance); a
    fully masked row's dq and dbias, and every gradient of an all-masked
    block, exactly 0. `d_stride` > 1 hands q, k and v as views with that
    stride on D (f32 only: the mma.sync variant). Returns max|d| by output."""
    from jobset_tpu_torch.ops import flash_block as fb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv_heads = kv_heads or heads
    q, k_c, v_c = make_qkv(dtype, batch, tq, tk, heads, dim * d_stride, kv_heads, gen, fused)
    if d_stride > 1:
        q, k_c, v_c = (t[..., ::d_stride] for t in (q, k_c, v_c))
    k, v = (fb._repeat_heads(t, heads // kv_heads) for t in (k_c, v_c))
    bias = make_bias("band" if bias_kind == "band_row" else bias_kind, tq, tk)
    if bias_kind == "band_row":
        bias[MASKED_ROW] = fb.NEG_INF
    classes = fb.tile_classes(bias)
    block_max = fb._block_attention_cuda(q, k, v, bias, classes)[0]
    dsum = torch.randn((batch, heads, tq), generator=gen, device="cuda")
    dw = torch.randn((batch, tq, heads, dim), generator=gen, device="cuda")
    want_needs = BACKWARD_NEEDS[needs]
    f32 = dtype == torch.float32
    if f32:
        _, _, k5, v5, dims, _ = fb._kernel_args(q, k, v, bias)
        tma = fb._f32_tma_args(q, k5, v5, dims, bias) is not None
    before = launches_now()
    got = fb._block_attention_bwd_cuda(q, k, v, bias, block_max, classes, dsum, dw, want_needs)
    again = fb._block_attention_bwd_cuda(q, k, v, bias, block_max, classes, dsum, dw, want_needs)
    torch.cuda.synchronize()
    after = launches_now()
    variant = "bf16" if not f32 else "f32 tf32 wgmma/TMA" if tma else "f32 mma.sync"
    mma = after["BACKWARD_F32_MMA_LAUNCHES"] - before["BACKWARD_F32_MMA_LAUNCHES"]
    check(after["BACKWARD_LAUNCHES"] - before["BACKWARD_LAUNCHES"] == 2
          and after["BACKWARD_F32_LAUNCHES"] - before["BACKWARD_F32_LAUNCHES"] == 2 * f32
          and mma == (0 if not f32 or tma else 2),
          f"flash_block backward {name}: two launches, on the {variant} variant")
    check(all((g is None) == (not n) for g, n in zip(got, want_needs))
          and all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]) if a is not None),
          f"flash_block backward {name}: the outputs asked for ({needs}), two calls equal "
          "bit for bit")
    if f32:
        plain_is_f32(f"flash_block backward {name}")
    want = fb.block_attention_bwd_reference(q, k, v, bias, block_max, dsum, dw, want_needs)
    rtol, atol = BACKWARD_TOL[dtype]
    errs = {}
    for label, g, w, g2 in zip(("dq", "dk", "dv", "dbias"), got, want, again):
        if g is None:
            continue
        check(g.dtype == w.dtype and g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"flash_block backward {name}: {label} finite, {tuple(w.shape)} {w.dtype}")
        err = errs[label] = max_abs(g, w)
        limit = atol + rtol * w.float().abs().max().item()
        check(err <= limit and max_abs(g2, w) <= limit,
              f"flash_block backward {name}: {label} max|d|={err:.3e} <= {limit:.3e}")
    if bias_kind == "band_row":
        check((got[0] is None or bool((got[0][:, MASKED_ROW] == 0).all()))
              and (got[3] is None or bool((got[3][MASKED_ROW] == 0).all())),
              f"flash_block backward {name}: the fully masked row's dq and dbias are 0")
    if bias_kind == "all_masked":
        check(all(bool((g == 0).all()) for g in got if g is not None),
              f"flash_block backward {name}: every gradient of an all-masked block is 0")
    print(f"flash_block backward {name} ({variant}): max|d| "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()), flush=True)
    return errs


def backward_kernel_checks() -> dict:
    """Phase 3's backward cases: both dtypes; MHA, GQA expand views and
    fused-QKV views; the triangle, zero, all-masked, alibi and band biases
    (the band with a fully masked row); ragged Tq and Tk; D of 32, 64 and
    128; every subset of outputs the passes split on, dbias included. f32
    runs on tf32 wgmma fed by TMA at D <= 64 and on mma.sync at D = 128;
    f32 alone adds D of 16 and 8 (the example yamls' heads), views with
    stride 2 on D (mma.sync) and the sequence-parallel ring's block, Tq = Tk
    = 4096 (the longest walk of either pass)."""
    bf16, f32 = torch.bfloat16, torch.float32
    f32_only = [
        ("f32 D16 GQA expand view H8/Hkv2 T256 triangle", 2, 256, 256, 8, 16, "triangle", 2,
         False, "all", 1),
        ("f32 D8 fused-QKV views T130 band", 2, 130, 130, 8, 8, "band", None, True, "qkv", 1),
        ("f32 D64 views with stride 2 on D T192 triangle (mma.sync)", 2, 192, 192, 4, 64,
         "triangle", None, False, "all", 2),
        ("f32 B1 H16 T4096 D64 triangle (the sp ring's block)", 1, 4096, 4096, 16, 64,
         "triangle", None, False, "qkv", 1),
    ]
    errs = {}
    for dtype, tag in ((bf16, "bf16"), (f32, "f32")):
        cases = [
            (f"{tag} MHA B2 H4 T256 D64 triangle", 2, 256, 256, 4, 64, "triangle", None, False,
             "qkv"),
            (f"{tag} GQA expand view H8/Hkv2 T256 D64 zero", 2, 256, 256, 8, 64, "zero", 2,
             False, "qkv"),
            (f"{tag} fused-QKV views GQA H8/Hkv2 T192 D64 triangle", 2, 192, 192, 8, 64,
             "triangle", 2, True, "all"),
            (f"{tag} ragged Tq100 Tk77 D32 band with a masked row", 2, 100, 77, 4, 32,
             "band_row", 2, False, "all"),
            (f"{tag} ragged Tq100 Tk77 D32 alibi, dbias alone", 2, 100, 77, 4, 32, "alibi",
             None, False, "bias"),
            (f"{tag} D128 Tq130 Tk200 triangle, dq alone", 2, 130, 200, 4, 128, "triangle",
             None, False, "q"),
            (f"{tag} D128 Tq130 Tk200 reverse triangle, dk and dv alone", 2, 130, 200, 4, 128,
             "reverse_triangle", None, False, "kv"),
            (f"{tag} D128 GQA expand view H8/Hkv2 Tq130 Tk200 band", 2, 130, 200, 8, 128, "band",
             2, False, "all"),
            (f"{tag} all masked T200 D64", 2, 200, 200, 4, 64, "all_masked", None, False, "all"),
        ]
        for i, (name, *shape, bias_kind, kv, fused, needs) in enumerate(cases):
            errs[name] = flash_backward_case(name, dtype, *shape, bias_kind, kv_heads=kv,
                                             seed=20 + i, fused=fused, needs=needs)
    for i, (name, *shape, bias_kind, kv, fused, needs, d_stride) in enumerate(f32_only):
        errs[name] = flash_backward_case(name, f32, *shape, bias_kind, kv_heads=kv, seed=40 + i,
                                         fused=fused, needs=needs, d_stride=d_stride)
    return errs


def backward_bound_ms(q, bias, dtype) -> tuple[float, str]:
    """Least time for one backward call at q's shape (MHA): each input read
    once (q, k, v, bias, dweighted f32, block max and dsum) and each output
    written once (dq, dk, dv), or the five products over the unmasked
    logits (S, dW.V^T, dV, dK, dQ) in the arithmetic of the dtype's variant;
    the larger."""
    batch, tq, heads, dim = q.shape
    tk = bias.shape[1]
    elem = q.element_size()
    moved = (2 * elem * batch * heads * dim * (tq + 2 * tk)  # q, k, v in; dq, dk, dv out
             + 4 * bias.numel() + 4 * batch * tq * heads * dim + 2 * 4 * batch * heads * tq)
    unmasked = int((bias > -5e29).sum())
    flops = 5 * 2 * batch * heads * dim * unmasked
    peak, passes = PRODUCT_RATE[dtype]
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, passes * flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_backward_block(dtype, card, baseline=None) -> dict:
    """The backward at the training shape, [8, 1024, 16, 64] with the
    causal triangle (the flagship step's 8 calls): the kernel against the
    plain version in relative norm, two calls bit for bit; L2-cold times (two
    input sets of fused QKV views and cotangents, 85 MB each in bf16, in
    turns) of the kernel (the wrapper's call, bf16's rounding of dweighted
    included), each pass alone and the plain version; the bound; and, as a
    yardstick of like work (not the same function: it normalizes), the
    backward of scaled_dot_product_attention(is_causal=True) at
    [8, 16, 1024, 64], L2-cold over two input sets as the kernel is timed.
    With a baseline wrapper (another checkout's `ops/flash_block.py`), its
    backward kernel on the same inputs: its dq, dk and dv held to this
    one's at BACKWARD_REL, and timed in turns, parent, kernel, kernel,
    parent (`parent_ms`, the faster of each kept), each pass too."""
    from jobset_tpu_torch.ops import flash_block as fb

    heads, dim = 16, 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    bias, classes = fb.constant_mask("causal", PROMPT, PROMPT, torch.device("cuda"))
    needs = BACKWARD_NEEDS["qkv"]
    sets = []
    for _ in range(2):
        q, k, v = make_qkv(dtype, BATCH, PROMPT, PROMPT, heads, dim, heads, gen, fused=True)
        block_max = fb._block_attention_cuda(q, k, v, bias, classes)[0]
        dsum = torch.randn((BATCH, heads, PROMPT), generator=gen, device="cuda")
        dw = torch.randn((BATCH, PROMPT, heads, dim), generator=gen, device="cuda")
        sets.append((q, k, v, bias, block_max, dsum, dw))

    def kernel(i):
        q, k, v, bias_, m, dsum, dw = sets[i]
        return fb._block_attention_bwd_cuda(q, k, v, bias_, m, classes, dsum, dw, needs)

    def plain(i):
        q, k, v, bias_, m, dsum, dw = sets[i]
        return fb.block_attention_bwd_reference(q, k, v, bias_, m, dsum, dw, needs)

    def parent(i):
        q, k, v, bias_, m, dsum, dw = sets[i]
        return baseline._block_attention_bwd_cuda(q, k, v, bias_, m, classes, dsum, dw, needs)

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    if dtype == torch.float32:
        plain_is_f32(f"flash_block backward flagship {tag}")
    got, again, want = kernel(0), kernel(0), plain(0)
    rels = {label: ((g.float() - w.float()).norm() / w.float().norm()).item()
            for label, g, w in zip(("dq", "dk", "dv"), got, want)}
    check(all(r <= BACKWARD_REL[dtype] for r in rels.values())
          and all(bool(torch.isfinite(g).all()) for g in got[:3]),
          f"flash_block backward flagship {tag} [8,1024,16,64] triangle: kernel vs plain, "
          f"relative norm {', '.join(f'{k} {r:.2e}' for k, r in rels.items())} <= "
          f"{BACKWARD_REL[dtype]}")
    check(all(torch.equal(a, b) for a, b in zip(got[:3], again[:3])),
          f"flash_block backward flagship {tag}: two calls equal bit for bit")
    max_err = max(max_abs(g, w) for g, w in zip(got[:3], want[:3]))
    out = {"rel_norm": rels, "max_abs_err": max_err}
    if baseline is not None:
        theirs = parent(0)
        out["parent_rel_norm"] = {
            label: ((g.float() - w.float()).norm() / w.float().norm()).item()
            for label, g, w in zip(("dq", "dk", "dv"), got, theirs)}
        check(all(r <= BACKWARD_REL[dtype] for r in out["parent_rel_norm"].values()),
              f"flash_block backward flagship {tag}: against the parent's kernel, relative "
              f"norm {', '.join(f'{k} {r:.2e}' for k, r in out['parent_rel_norm'].items())}"
              f" <= {BACKWARD_REL[dtype]}")
        del theirs
    del got, again, want
    if baseline is not None:
        mine, parents = [], []
        for runs, fn in ((parents, parent), (mine, kernel), (mine, kernel), (parents, parent)):
            runs.append(rotating_ms(fn, 2, ITERS))
        out.update(ms=min(mine), ms_runs=mine, parent_ms=min(parents), parent_ms_runs=parents)
    else:
        out["ms"] = rotating_ms(kernel, 2, ITERS)
    out["plain_ms"] = rotating_ms(plain, 2, 4)
    # Each pass alone: dq alone runs the dQ pass, dk and dv the dK/dV pass
    # (the parent's in turns with this one's, where it is given).
    for part, part_needs in (("dq_pass_ms", BACKWARD_NEEDS["q"]),
                             ("dkdv_pass_ms", BACKWARD_NEEDS["kv"])):
        def one_pass(i, wrapper=fb):
            return wrapper._block_attention_bwd_cuda(*sets[i][:5], classes, *sets[i][5:],
                                                     part_needs)

        if baseline is not None:
            mine, parents = [], []
            for runs, who in ((parents, baseline), (mine, fb), (mine, fb), (parents, baseline)):
                runs.append(rotating_ms(lambda i: one_pass(i, who), 2, ITERS))
            out[part], out["parent_" + part] = min(mine), min(parents)
        else:
            out[part] = rotating_ms(one_pass, 2, ITERS)
    out["bound_ms"], out["bound_by"] = backward_bound_ms(sets[0][0], bias, dtype)
    n_live = int((classes != fb.MASKED).sum())
    out["tile_bound_ms"] = 1e3 * PRODUCT_RATE[dtype][1] * n_live * BATCH * heads * 5 * 2 \
        * fb.TILE * fb.TILE * dim / PRODUCT_RATE[dtype][0]
    del sets
    torch.cuda.empty_cache()
    # The yardstick: SDPA's backward alone (its forward's graph kept), over
    # two input sets in turns (84 MB each in bf16), as the kernel is timed.
    sdpa = []
    for _ in range(2):
        qs, ks, vs = (torch.randn((BATCH, heads, PROMPT, dim), generator=gen, device="cuda")
                      .to(dtype).requires_grad_() for _ in range(3))
        o = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        sdpa.append((o, (qs, ks, vs), torch.randn_like(o)))
    out["library_ms"] = rotating_ms(lambda i: torch.autograd.grad(
        sdpa[i][0], sdpa[i][1], sdpa[i][2], retain_graph=True), 2, ITERS)
    del sdpa, qs, ks, vs, o
    torch.cuda.empty_cache()
    print(f"flash_block backward flagship {tag} [8,1024,16,64] triangle, L2-cold: kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}; {out['tile_bound_ms']:.4f} ms over the live 64x64 tiles), "
          f"{out['bound_ms'] / out['ms']:.1%} of bound (the dK/dV pass alone "
          f"{out['dkdv_pass_ms']:.4f} ms, the dQ pass alone {out['dq_pass_ms']:.4f} ms); "
          f"library_ms (backward of "
          f"scaled_dot_product_attention is_causal at [8,16,1024,64], L2-cold; normalized "
          f"attention, not the same function) {out['library_ms']:.4f} ms"
          + (f"; the parent's kernel {out['parent_ms']:.4f} ms (runs "
             f"{', '.join(f'{x:.4f}' for x in out['parent_ms_runs'])}; kernel "
             f"{', '.join(f'{x:.4f}' for x in out['ms_runs'])}; its dK/dV pass "
             f"{out['parent_dkdv_pass_ms']:.4f} ms, its dQ pass {out['parent_dq_pass_ms']:.4f} ms)"
             if baseline is not None else "")
          + f" ({card})", flush=True)
    return out


def backward_blocks(card, baseline=None) -> dict:
    """time_backward_block in bf16 and f32; `baseline`: another checkout
    whose backward kernel runs beside this one's."""
    parent = load_baseline(baseline, "flash_block") if baseline else None
    return {tag: time_backward_block(dtype, card, parent) for tag, dtype in (
        ("bf16", torch.bfloat16), ("f32", torch.float32))}


def backward_ptxas(log: str) -> dict:
    """kernel_ptxas over the backward library: each pass's instantiation by
    variant (tc: bf16 on wgmma, tf32: f32 on tf32 wgmma, f32: f32 on
    mma.sync) and padded head dim (spills are printed, not failed)."""
    return kernel_ptxas(log, r"flash_bwd_(?:dkdv|dq)_(?:tc|tf32|f32)_kernel")


def backward_sass(library) -> dict:
    """The backward library's SASS: both bf16 passes (every padded head
    dim) and both f32 passes on tf32 wgmma (D 32 and 64) run wgmma (HGMMA)
    on tiles that TMA loads (UTMALDG); the kept f32 mma.sync passes run
    HMMA and no HGMMA. Returns the counts by kernel."""
    counts = sass_counts(library)
    tc = {n: c for n, c in counts.items() if "_tc_kernel" in n}
    check(len(tc) == 6 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in tc.values()),
          f"sass: both bf16 backward passes (D 64 and 128; the dQ pass with and without "
          f"dbias) have HGMMA and UTMALDG ({tc})")
    tf32 = {n: c for n, c in counts.items() if "_tf32_kernel" in n}
    check(len(tf32) == 6 and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in tf32.values()),
          f"sass: both f32 backward passes on tf32 wgmma (D 32 and 64; the dQ pass with and "
          f"without dbias) have HGMMA and UTMALDG ({tf32})")
    f32 = {n: c for n, c in counts.items() if "_f32_kernel" in n}
    check(len(f32) == 6 and all(c["HMMA"] > 0 and c["HGMMA"] == 0 for c in f32.values()),
          f"sass: the kept f32 mma.sync backward passes have HMMA and no HGMMA "
          f"({len(f32)} found)")
    return counts


def backward_entries(results) -> list:
    """The `kernels` line's entries of the backward kernel, bf16 and f32,
    from phase 7's flagship-block measurements."""
    out = []
    for tag, variant in (("bf16", "bf16 (wgmma fed by TMA through an mbarrier ring, the dQ "
                                  "pass under PDL behind the dK/dV pass; dweighted rounded to "
                                  "bf16 by the wrapper, in the time), the flagship paths'"),
                         ("f32", "f32 (3xTF32 on tf32 wgmma m64nNk8 fed by TMA through an "
                                 "mbarrier ring, transposed split copies of the walked tile, the "
                                 "dQ pass under PDL behind the dK/dV pass; the mma.sync kernels "
                                 "kept for views TMA cannot take and D > 64), the LM workload's "
                                 "default f32 path; launches (tf32 wgmma variant) counted on the "
                                 "worker's uninterrupted run")):
        t = results["block_backward"][tag]
        out.append({
            "name": "flash_block_backward" + ("" if tag == "bf16" else "_f32"),
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/flash_block_bwd.cu",
            "replaces": "jobset_tpu/ops/flash_block.py:483",
            "variant": variant,
            "max_abs_err": t["max_abs_err"],
            "rel_norm_err": t["rel_norm"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "tile_bound_ms": t["tile_bound_ms"],
            "pass_ms": {"dkdv": t["dkdv_pass_ms"], "dq": t["dq_pass_ms"]},
            "library_ms": t["library_ms"],
            "library_call": "backward of scaled_dot_product_attention(is_causal=True) at "
                            "[8,16,1024,64] (a yardstick: normalized attention, not the same "
                            "function)",
            "shape": f"{tag} B=8 H=16 Tq=Tk=1024 D=64, causal triangle; dq, dk, dv; L2-cold",
            "ptxas": {k: v for k, v in (results.get("backward_ptxas") or {}).items()
                      if f"_{'tc' if tag == 'bf16' else 'tf32'}_kernel" in k},
            "sass": {k: v for k, v in (results.get("backward_sass") or {}).items()
                     if f"_{'tc' if tag == 'bf16' else 'tf32'}_kernel" in k},
            **({"parent_ms": t["parent_ms"], "parent_ms_runs": t["parent_ms_runs"],
                "ms_runs": t["ms_runs"], "parent_rel_norm": t["parent_rel_norm"],
                "parent_pass_ms": {"dkdv": t["parent_dkdv_pass_ms"],
                                   "dq": t["parent_dq_pass_ms"]}}
               if "parent_ms" in t else {}),
        })
    return out


def phase_kernels(results):
    from jobset_tpu_torch.ops import flash_block as fb

    bf16, f32 = torch.bfloat16, torch.float32
    flagship = None
    for bias_kind in BIAS_KINDS:
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
    # The f32 variant: the kernel the LM workload's default f32 path runs
    # (the worker phase counts its launches). Every bias kind at the
    # flagship block; both loaders (16-byte copies for aligned views, 4-byte
    # ones for D=5 rows and D-strided views); GQA; large logits, where
    # single-pass TF32 would miss the tolerance; the forward shape's fused
    # QKV views.
    flagship_f32 = None
    for bias_kind in BIAS_KINDS:
        case = flash_case(f"flagship f32 B8 H16 T512 D64 {bias_kind}", f32,
                          8, 512, 512, 16, 64, bias_kind, seed=7)
        if bias_kind == "triangle":
            flagship_f32 = case
    flash_case("f32 D5 ragged Tq70 Tk90 (4-byte copies)", f32, 2, 70, 90, 4, 5, "alibi", seed=8)
    flash_case("f32 D-stride-2 views, GQA H8/Hkv2 T200 D64 (4-byte copies)", f32,
               2, 200, 200, 8, 64, "band", kv_heads=2, seed=9, d_stride=2)
    flash_case("f32 GQA expand view H16/Hkv4 T512 D64", f32, 4, 512, 512, 16, 64,
               "triangle", kv_heads=4, seed=10)
    flash_case("f32 D128 Tq130 Tk200", f32, 2, 130, 200, 4, 128, "triangle", seed=11)
    large = flash_case("f32 large logits |q.k| ~1e3 B2 H4 T256 D64", f32, 2, 256, 256, 4, 64,
                       "triangle", seed=12, q_scale=125.0)
    forward_f32 = flash_case("forward shape f32 B8 H16 T1024 D64, fused-QKV views", f32,
                             8, 1024, 1024, 16, 64, "triangle", seed=13, fused=True)

    # L2-cold: 4 sets of q/k/v at the flagship shape (100 MB in bf16, 200 MB
    # in f32) and 2 fused QKV buffers at the forward shape (100 MB in bf16,
    # 200 MB in f32) against the 50 MB L2.
    flag_t = time_block(flagship, 4, ("zero", "alibi"))
    fwd_t = time_block(forward, 2)
    f32_t = time_block(flagship_f32, 4, ("zero", "alibi"))
    fwd_f32_t = time_block(forward_f32, 2)
    for label, t in (("flagship bf16 [8,512,16,64]", flag_t),
                     ("forward shape bf16 [8,1024,16,64]", fwd_t),
                     ("flagship f32 [8,512,16,64]", f32_t),
                     ("forward shape f32 [8,1024,16,64]", fwd_f32_t)):
        fma = (f"; true-f32 FMA bound {t['fma_bound_ms']:.4f} ms ({t['fma_bound_by']})"
               if "fma_bound_ms" in t else "")
        print(f"flash_block {label} triangle, L2-cold: kernel {t['ms']:.4f} ms "
              f"(PDL call with the pass {t['call_ms']:.4f} ms, the pass's cost on the path "
              f"{1e3 * t['path_ms']:.2f} us), plain {t['plain_ms']:.4f} ms, "
              f"library_ms (scaled_dot_product_attention, same mask; normalized output, "
              f"no stats) {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of bound{fma}", flush=True)
    for label, t in (("bf16", flag_t), ("f32", f32_t)):
        print(f"flash_block flagship {label} [8,512,16,64], kernel alone by bias kind, "
              "L2-cold: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in t["ms_by_bias"].items()),
              flush=True)
    host = host_call_ms(flagship)
    print(f"flash_block flagship bf16 [8,512,16,64], host time of {GENERATE_LAUNCHES} calls "
          f"under no_grad, median of {TTFT_REPEATS}: "
          + ", ".join(f"{k} {ms:.4f} ms" for k, ms in host.items()), flush=True)

    # The pass against its plain version at [1024, 1024] under every bias
    # kind ([512, 512] is the flagship cases' above), then alone, L2-cold.
    for kind in BIAS_KINDS:
        bias = make_bias(kind, 1024, 1024)
        check(torch.equal(fb.tile_classes(bias), fb.tile_classes_reference(bias)),
              f"tile_classes [1024,1024] {kind}: the pass equals the plain version")
    classes_t = {n: time_classes(n) for n in (512, 1024)}
    for n, t in classes_t.items():
        print(f"tile_classes [{n},{n}] triangle, L2-cold: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes)", flush=True)
    path_ms = {label: t["path_ms"] for label, t in (
        ("flagship bf16", flag_t), ("forward shape bf16", fwd_t), ("flagship f32", f32_t),
        ("forward shape f32", fwd_f32_t))}
    results["backward_checks"] = backward_kernel_checks()

    return [
        {
            "name": "flash_block",
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/flash_block.cu",
            "replaces": "jobset_tpu/ops/flash_block.py:194",
            "variant": "bf16 tensor cores (flash_block_tc_kernel) on the flagship paths; "
                       "the f32 variant (flash_block_f32_kernel) is its own entry",
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
            "path_ms": flag_t["path_ms"],
            "ms_by_bias": flag_t["ms_by_bias"],
            "host_ms_per_generate_calls": host,
            "forward_shape": {k: fwd_t[k] for k in
                              ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "path_ms")},
        },
        {
            "name": "flash_block_f32",
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/flash_block.cu",
            "replaces": "jobset_tpu/ops/flash_block.py:194",
            "variant": "f32 variant (flash_block_f32_kernel, 3xTF32 on mma.sync), the LM "
                       "workload's default f32 path; launches counted on the worker's "
                       "uninterrupted run",
            "max_abs_err": flagship_f32["errs"]["weighted"],
            "max_abs_err_by_output": flagship_f32["errs"],
            "large_logits_max_abs_err": large["errs"],
            "ms": f32_t["ms"],
            "plain_ms": f32_t["plain_ms"],
            "bound_ms": f32_t["bound_ms"],
            "bound_by": f32_t["bound_by"],
            "bound_arithmetic": "3xTF32: three TF32 products at 495 TFLOP/s",
            "fma_bound_ms": f32_t["fma_bound_ms"],
            "library_ms": f32_t["library_ms"],
            "library_call": "scaled_dot_product_attention in f32 with the same additive mask "
                            "(nearest: normalized output, no stats)",
            "shape": "f32 B=8 H=16 Tq=Tk=512 D=64, triangle bias; L2-cold",
            "call_ms": f32_t["call_ms"],
            "path_ms": f32_t["path_ms"],
            "ms_by_bias": f32_t["ms_by_bias"],
            "forward_shape": {k: fwd_f32_t[k] for k in
                              ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "fma_bound_ms", "path_ms")},
            "ptxas": results.get("f32_ptxas"),
        },
        {
            "name": "flash_block_tile_classes",
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/flash_block.cu",
            "replaces": "jobset_tpu/ops/flash_block.py:194",
            "max_abs_err": flagship["classes_err"],
            "ms": classes_t[512]["ms"],
            "plain_ms": classes_t[512]["plain_ms"],
            "bound_ms": classes_t[512]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "shape": "f32 bias [512, 512], triangle; L2-cold",
            "at_1024": classes_t[1024],
            "path_ms": flag_t["path_ms"],
            "path_ms_by_shape": path_ms,
            "path_ms_is": "call_ms - ms: the PDL call's excess over the kernel given classes",
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

    empty_mask_cache()
    reset_launches()
    logits, secs = wall_s(lambda: forward(params, tokens))
    results["forward_launches"] = check_launches("forward", FORWARD_LAUNCHES, 1)
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

    # The first run builds the two masks of its chunk shape (the triangle
    # and the zero bias) and classifies each once; the second builds none.
    empty_mask_cache()
    reset_launches()
    tokens, secs = wall_s(lambda: generate(params, prompt))
    results["launches"] = check_launches("generate", GENERATE_LAUNCHES, 2)
    reset_launches()
    _, secs_second = wall_s(lambda: generate(params, prompt))
    results["second_generate_launches"] = check_launches("second generate", GENERATE_LAUNCHES, 0)
    check(tuple(tokens.shape) == (BATCH, PROMPT + NEW_TOKENS)
          and bool((tokens[:, :PROMPT] == prompt).all())
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"generate: tokens shape {tuple(tokens.shape)}, prompt kept, ids in vocab")
    # Host-bound and noisy (the host's cores are shared): medians of a few
    # more calls, with the spread.
    gen_runs = sorted([secs, secs_second] + [wall_s(lambda: generate(params, prompt))[1]
                                             for _ in range(GEN_REPEATS - 2)])
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


def traced(fn, label, kernel=None, keep_events=False):
    """torch.profiler over one call of fn: the top 10 device ops by device
    time and the card's idle share of the traced window (first to last
    event, host or device); with `kernel`, the device time and count of the
    ops whose name holds it; with keep_events, every device op as (name,
    start µs, end µs) under "events". None when the profiler saw no device
    events."""
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
          f"idle share {1.0 - busy / window:.1%}, {len(device)} device ops; top 10:", flush=True)
    for n, (t, c) in top:
        print(f"  {t / 1e3:9.3f} ms  {c:5d}x  {n[:100]}", flush=True)
    out = {
        "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window,
        "device_ops": len(device),
        "device_ms_total": sum(t for t, _ in by_name.values()) / 1e3,
        "top10": [{"name": n[:120], "ms": t / 1e3, "count": c} for n, (t, c) in top],
    }
    if kernel is not None:
        mine = [(t, c) for n, (t, c) in by_name.items() if kernel in n]
        out["kernel_ms"] = sum(t for t, _ in mine) / 1e3
        out["kernel_ops"] = sum(c for _, c in mine)
        print(f"  {kernel}: {out['kernel_ms']:.3f} ms in {out['kernel_ops']} launches", flush=True)
    if keep_events:
        out["events"] = [(e.name, e.time_range.start, e.time_range.end) for e in device]
    return out


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


def phase_train(results, baseline=None):
    from dataclasses import replace

    from jobset_tpu_torch.models import TransformerConfig, init_params
    from jobset_tpu_torch.ops import flash_block as fb
    from jobset_tpu_torch.runtime import model_bench

    card = results["card"]
    # The first step builds and classifies the triangle; no later one does.
    empty_mask_cache()
    reset_launches()
    bench = model_bench.run_model_bench(steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, batch=BATCH,
                                        seq_len=PROMPT)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    counts = check_launches(f"run_model_bench ({steps} steps)", LAYERS * steps, 1,
                            backward=LAYERS * steps)
    results["train_bench_launches"] = counts
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
    results["train_launches_remat_off"] = check_launches("train step, remat off", LAYERS, 0,
                                                         backward=LAYERS)
    with plain_attention():
        plain = sgd_step(cfg, params, batch)
    results["train_grad_rel_vs_plain"] = compare_step(
        "train step flagship, kernel vs plain", kernel, plain, TRAIN_LOSS_REL, TRAIN_GRAD_REL)
    del plain
    for policy, want in (("full", 2 * LAYERS), ("dots", LAYERS)):
        reset_launches()
        # "full" re-runs each layer's forward, kernel included, in the
        # backward; "dots" keeps the attention output and re-runs no kernel.
        # Either way each layer's block step is differentiated once.
        remat = sgd_step(replace(cfg, remat=True, remat_policy=policy), params, batch)
        results[f"train_launches_remat_{policy}"] = check_launches(
            f"train step, remat {policy!r}", want, 0, backward=LAYERS)
        compare_step(f"train step flagship, remat {policy!r} vs off", remat, kernel,
                     TRAIN_LOSS_REL, TRAIN_GRAD_REL)
        del remat
    from jobset_tpu_torch.models import build_eval_step

    reset_launches()
    eval_loss = float(build_eval_step(cfg)(params, batch))
    results["eval_launches"] = check_launches("eval step", LAYERS, 0)
    check(abs(eval_loss - kernel[0]) <= TRAIN_LOSS_REL * abs(kernel[0]),
          f"eval step flagship: loss {eval_loss:.6f} vs the train step's {kernel[0]:.6f}")
    del kernel
    torch.cuda.empty_cache()

    # The backward kernel at the training shape, bf16 and f32: against its
    # plain version (and the parent's kernel, given a baseline), L2-cold
    # times, the bound, SDPA's backward beside it.
    results["block_backward"] = backward_blocks(card, baseline)

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

    trace = traced(one_step, f"train step (B={BATCH}, T={PROMPT}, remat off, adam)",
                   kernel="flash_bwd")
    if trace is not None:
        trace["block_backward_share"] = trace["kernel_ms"] / trace["device_busy_ms"]
        print(f"train step flagship: median {bench['step_time_ms_median']:.3f} ms, MFU "
              f"{bench['mfu_pct']}%, peak memory {bench['peak_memory_gb']:.2f} GB; the backward "
              f"kernel's share of the traced step's device busy "
              f"{trace['block_backward_share']:.1%} ({trace['kernel_ms']:.3f} of "
              f"{trace['device_busy_ms']:.3f} ms, {trace['kernel_ops']} launches of its two "
              f"passes; {card})", flush=True)
    results["train_trace"] = trace
    del params, state, holder, step
    torch.cuda.empty_cache()

    # A small f32 GQA config: the card's kernel path against the CPU's.
    small = TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                              n_layers=2, dtype=torch.float32, remat=False)
    small_params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    small_batch = token_batch(128, 4, 64, seed=5, device="cpu")
    before = launches_now()
    card_step = sgd_step(small, to_device(small_params, "cuda"),
                         {k: t.cuda() for k, t in small_batch.items()})
    after = launches_now()
    check(after["F32_LAUNCHES"] - before["F32_LAUNCHES"] == small.n_layers
          and after["BACKWARD_F32_LAUNCHES"] - before["BACKWARD_F32_LAUNCHES"] == small.n_layers
          and after["BACKWARD_F32_MMA_LAUNCHES"] == before["BACKWARD_F32_MMA_LAUNCHES"],
          "small f32 train step: one f32-variant launch per layer, forward and backward (the "
          "backward on tf32 wgmma fed by TMA)")
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
    from concurrent.futures import ThreadPoolExecutor

    small = {"vocab_size": 256, "d_model": 128, "n_heads": 4, "d_ff": 256, "n_layers": 2}
    with tempfile.TemporaryDirectory() as tmp:
        def workload(name, **kw):
            path = os.path.join(tmp, f"{name}.json")
            with open(path, "w") as f:
                json.dump({"kind": "lm", "steps": 6, "config": small, **kw}, f)
            return path

        crashing = workload("crashing", checkpoint_every=2,
                            checkpoint_dir=os.path.join(tmp, "ckpt"), fail_at_step=3)
        # The uninterrupted run and the crashing one at once (each its own
        # process; the resume waits for the crash).
        with ThreadPoolExecutor(1) as pool:
            pending = pool.submit(run_worker, workload("straight"), 0)
            rc_fail, failed = run_worker(crashing, 0)
            rc, straight = pending.result()
        check(rc == 0 and straight is not None and straight["steps"] == 6,
              f"worker: uninterrupted run exits {rc} with its result line")
        launches = (straight or {}).get("kernel_launches", {})
        check(launches.get("F32_LAUNCHES", 0) >= 6 * small["n_layers"]
              and launches.get("TENSOR_CORE_LAUNCHES") == 0
              and launches.get("BACKWARD_F32_LAUNCHES", 0) >= 6 * small["n_layers"]
              and launches.get("BACKWARD_F32_MMA_LAUNCHES") == 0,
              f"worker: the f32 run launched the f32 variants, the backward on tf32 wgmma fed "
              f"by TMA ({launches})")
        # One mask (the [16, 16] triangle) classified once per process.
        check(launches.get("TILE_CLASS_LAUNCHES") == 1,
              f"worker: the uninterrupted run ran the tile-class pass once ({launches})")
        check(rc_fail == 1 and failed is not None and "step 3" in failed.get("failed", ""),
              f"worker: the run with fail_at_step=3 exits {rc_fail} and says where it failed")
        rc_resume, resumed = run_worker(crashing, 1)
        ok = rc_resume == 0 and resumed is not None and straight is not None
        check(ok and resumed["steps"] == 4
              and abs(resumed["final_loss"] - straight["final_loss"])
              <= 1e-5 * abs(straight["final_loss"]),
              f"worker: restart attempt 1 resumes at step 2 and ends at the uninterrupted "
              f"loss ({(resumed or {}).get('final_loss')} vs {(straight or {}).get('final_loss')})")
        resumed_launches = (resumed or {}).get("kernel_launches", {})
        check(resumed_launches.get("TILE_CLASS_LAUNCHES") == 1,
              f"worker: the resumed run ran the tile-class pass once ({resumed_launches})")
    results["worker"] = {"straight": straight, "failed": failed, "resumed": resumed}


# ---------------------------------------------------------------------------
# Phase 9: the placement solver plane
# ---------------------------------------------------------------------------

# The 15k-node shape: bench.py's 960 domains of 16 nodes with 16 pod slots
# each, under a gang of 512 jobs of 4 pods; storms of 8 JobSets; the
# 100k-node shape has 6250 such domains.
SOLVER_JOBS, SOLVER_DOMAINS, STORM_PROBLEMS, BIG_DOMAINS = 512, 960, 8, 6250
NODES_PER_DOMAIN, NODE_SLOTS, PODS_PER_JOB = 16, 16, 4
SOLVE_REPEATS = 30  # wall-clock solves behind each p50/p99
AUCTION_COUNTERS = ("AUCTION_LAUNCHES", "DENSE_LAUNCHES", "STRUCTURED_LAUNCHES",
                    "DENSE_BATCH_LAUNCHES", "STRUCTURED_BATCH_LAUNCHES")
# Each solver path and the variant counter its one launch must move.
PATH_COUNTERS = {"structured": "STRUCTURED_LAUNCHES", "dense": "DENSE_LAUNCHES",
                 "structured_batch": "STRUCTURED_BATCH_LAUNCHES",
                 "dense_batch": "DENSE_BATCH_LAUNCHES", "structured_100k": "STRUCTURED_LAUNCHES"}


def gradient_problem(domains, seed, jobs=SOLVER_JOBS):
    """The structured surface of a gang arriving on a load-skewed cluster
    (bench.py `preload_domain_gradient`: domain i has round(16 * 0.9 * i /
    (D - 1)) of each node's 16 slots taken), 4 pods a job: every job ranks
    the domains alike. 64 jobs are sticky (recovering to their previous
    domain), 16 of them own their domain exclusively, and 32 other domains
    are owned by other JobSets."""
    rng = np.random.default_rng(seed)
    taken = np.round(NODE_SLOTS * 0.9 * np.arange(domains) / max(domains - 1, 1))
    free = (NODES_PER_DOMAIN * (NODE_SLOTS - taken)).astype(np.float32)
    load = (1.0 - free / (NODES_PER_DOMAIN * NODE_SLOTS)).astype(np.float32)
    picks = rng.choice(domains, size=96, replace=False).astype(np.int32)
    movers = rng.choice(jobs, size=64, replace=False)
    sticky = np.full(jobs, -1, np.int32)
    sticky[movers] = picks[:64]
    own = np.full(jobs, -1, np.int32)
    own[movers[:16]] = picks[:16]
    occupied = np.zeros(domains, bool)
    occupied[picks[:16]] = True
    occupied[picks[64:]] = True
    return dict(load=load, free=free, pods_needed=np.full(jobs, PODS_PER_JOB, np.float32),
                sticky=sticky, occupied=occupied, own_domain=own)


def hetero_costs(seed):
    """bench.py's heterogeneous surface (`run_contended_optimality`): costs
    on the 1/256 grid scaled x256 to the integers 0..255, so the auction's
    result must be exactly optimal. The warm start cannot be its
    equilibrium, so the bidding loop really runs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(SOLVER_JOBS, SOLVER_DOMAINS)).astype(np.float32)


def edge_cases():
    """Small dense problems at the edges: (cost, feasible) by name."""
    rng = np.random.default_rng(5)
    feasible = rng.random((24, 40)) > 0.4
    feasible[[1, 7, 20], :] = False
    sticky = np.ones((12, 32), np.float32)
    sticky[[0, 3, 11], [5, 5, 30]] = 0.0
    contended = np.round((1.0 + np.linspace(0, 0.9, 96)[None, :].repeat(64, 0)) * 64)
    dead = np.ones((64, 96), bool)
    dead[:, 64:] = False
    return {
        "infeasible rows 24x40": (rng.integers(0, 20, size=(24, 40)).astype(np.float32),
                                  feasible),
        "more jobs than domains 20x6": (rng.integers(0, 9, size=(20, 6)).astype(np.float32),
                                        None),
        "stickiness 12x32": (sticky, None),
        "one domain 5x1": (np.zeros((5, 1), np.float32), None),
        "contended, dead columns 64x96": (contended.astype(np.float32), dead),
    }


def reset_auction():
    from jobset_tpu_torch.ops import auction

    for name in AUCTION_COUNTERS:
        setattr(auction, name, 0)


def auction_counts():
    from jobset_tpu_torch.ops import auction

    return {name: getattr(auction, name) for name in AUCTION_COUNTERS}


def dense_benefit(costs, feasibles=None):
    """[B, J, D] costs -> the padded, scaled benefit on the card, as the
    surface builds it."""
    from jobset_tpu_torch.placement import solver as S

    if feasibles is None:
        feasibles = np.ones(costs.shape, bool)
    return S._dense_benefit(costs, feasibles, S._round_up_pow2(costs.shape[1]),
                            S._round_up_pow2(costs.shape[2]), "cuda")


def structured_operands(problems):
    """Structured problems padded and stacked on the card, as the surface
    does it."""
    from jobset_tpu_torch.placement import solver as S

    jobs_p = S._round_up_pow2(max(len(p["pods_needed"]) for p in problems))
    domains_p = S._round_up_pow2(max(len(p["load"]) for p in problems))
    stacked = S._stack_structured(problems, jobs_p, domains_p)
    return [torch.from_numpy(a).cuda() for a in stacked.values()]


def auction_agree(name, got, want):
    """The kernel's (assignment, prices, iterations) against the plain
    version's on the same inputs: identical, prices bit for bit. Returns
    the largest difference, 0.0 when they agree."""
    a, p, it = (t.cpu() for t in got[:3])
    wa, wp, wit = (t.cpu() for t in want[:3])
    same = (torch.equal(a, wa.int()) and torch.equal(it, wit.int())
            and torch.equal(p.view(torch.int32), wp.view(torch.int32)))
    err = max((a - wa.int()).abs().max().item(), (p - wp).abs().max().item(),
              (it - wit.int()).abs().max().item())
    check(same, f"auction {name}: kernel equals the plain version (assignments, prices bit "
                f"for bit, iterations {it.tolist()[:8]}; max |d| {err})")
    return float(err)


def stat_sums(stats) -> dict:
    """The kernel's per-problem counters, summed over the batch, by name."""
    from jobset_tpu_torch.ops.auction import STATS

    return dict(zip(STATS, stats.cpu().long().sum(dim=0).tolist()))


def auction_bound_bytes(stats, jobs_p, domains_p) -> int:
    """The benefit bytes the reference algorithm reads in this run: the
    rows of every round's bidders, plus one full pass per phase."""
    s = stat_sums(stats)
    return (s["bid_rows"] + s["phases"] * jobs_p) * domains_p * 4


def auction_bound_ms(stats, jobs_p, domains_p) -> float:
    """Least time of one launch: auction_bound_bytes at the HBM rate, from
    the kernel's own counts of this run."""
    return 1e3 * auction_bound_bytes(stats, jobs_p, domains_p) / HBM_BYTES_PER_S


def auction_read_bytes(stats, domains_p) -> int:
    """The bytes the kernel itself read for its bids and repairs: full-scan
    and repair rows, plus candidate lists read from global memory."""
    s = stat_sums(stats)
    return (s["full_scan_rows"] + s["repair_rows"]) * domains_p * 4 + s["candidate_bytes"]


def round_split(stats, clock_mhz) -> dict:
    """The slowest problem's bidding round in µs, part by part (thread 0's
    clock64 sums over its timed rounds, one in 16, at the SM clock read
    under load), its repairs in µs, warp 0's latency per full-scan and per
    cached bid, and the batch's share of bids answered by candidate lists."""
    from jobset_tpu_torch.ops.auction import STATS

    s = stats.cpu().long()
    slow = int(s[:, STATS.index("cycles_total")].argmax())
    row = dict(zip(STATS, s[slow].tolist()))
    rounds = max(row["timed_rounds"], 1)
    sums = stat_sums(stats)
    out = {part: row[f"cycles_{part}"] / clock_mhz / rounds
           for part in ("list", "bid", "resolve", "barrier")}
    out["round"] = out["list"] + out["bid"] + out["resolve"]
    out["repair_total"] = row["cycles_repair"] / clock_mhz
    out["kernel_total"] = row["cycles_total"] / clock_mhz
    for kind, count, cycles in (("scan", "warp0_scans", "warp0_scan_cycles"),
                                ("hit", "warp0_hits", "warp0_hit_cycles")):
        out[f"warp0_{kind}_latency"] = (row[cycles] / row[count] / clock_mhz
                                        if row[count] else None)
    out["hit_rate"] = sums["cached_bids"] / max(sums["bid_rows"], 1)
    out["full_scan_rows"], out["cached_bids"] = sums["full_scan_rows"], sums["cached_bids"]
    return out


def sm_clock_mhz(launch, n: int) -> tuple[float, float]:
    """nvidia-smi's SM clock and its maximum, read while n queued launches
    of `launch` keep the card busy."""
    torch.cuda.synchronize()
    for _ in range(n):
        launch()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    now, top = (float(x) for x in out.split(","))
    return now, top


def pct(samples, q):
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


def wall_ms(fn, repeats):
    """Host-clock ms of `repeats` calls (each ends on the host with its
    result): (p50, p99, samples)."""
    samples = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append(1e3 * (time.perf_counter() - t0))
    return pct(samples, 0.5), pct(samples, 0.99), samples


def scipy_ms(cost, feasible=None):
    """scipy's Hungarian on the host (the yardstick: no PyTorch call
    computes a linear assignment), as the portfolio calls it."""
    from jobset_tpu_torch.placement.solver import AssignmentSolver

    if feasible is None:
        feasible = np.ones(cost.shape, bool)
    t0 = time.perf_counter()
    AssignmentSolver._hungarian_solve(cost, feasible, *cost.shape, t0)
    return 1e3 * (time.perf_counter() - t0)


def time_auction(name, launch, plain, jobs_p, domains_p, scipy, clock_mhz):
    """Device ms of the kernel (CUDA events, the benefit L2-resident as a
    solve keeps it) beside the plain version's wall ms on the card (one
    call, from the comparison), the bound and scipy's host ms; the round
    split at `clock_mhz`, the hit rate, and the bytes the kernel read
    against the bound's."""
    from jobset_tpu_torch.ops.auction import STATS

    out = launch()
    torch.cuda.synchronize()
    t = {"ms": cuda_ms(launch, ITERS), "plain_ms": plain,
         "bound_ms": auction_bound_ms(out[3], jobs_p, domains_p), "bound_by": "bytes",
         "bound_bytes": auction_bound_bytes(out[3], jobs_p, domains_p),
         "read_bytes": auction_read_bytes(out[3], domains_p),
         "iterations": out[2].tolist(), "stats": dict(zip(STATS, out[3][0].tolist())),
         "scipy_ms": scipy, "split_us": round_split(out[3], clock_mhz)}
    slowest = max(t["iterations"])
    t["us_per_round"] = 1e3 * t["ms"] / max(slowest, 1)
    sp = t["split_us"]
    latency = ", ".join(f"{k} {sp[f'warp0_{k}_latency']:.3f} µs"
                        for k in ("scan", "hit") if sp[f"warp0_{k}_latency"] is not None)
    print(f"auction {name}: kernel {t['ms']:.4f} ms ({t['iterations'][:8]} iterations; "
          f"{t['us_per_round']:.3f} µs a round of the slowest problem), plain "
          f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms (bytes: "
          f"{t['bound_bytes']:,}; the kernel read {t['read_bytes']:,}), scipy on the host "
          f"{scipy:.3f} ms", flush=True)
    print(f"  round split (µs a timed round at {clock_mhz:.0f} MHz): list {sp['list']:.3f}, bids "
          f"{sp['bid']:.3f}, resolution {sp['resolve']:.3f} (barrier waits inside these "
          f"{sp['barrier']:.3f}); repairs {sp['repair_total']:.1f} µs of "
          f"{sp['kernel_total']:.1f} µs; hit rate {sp['hit_rate']:.4f} ({sp['cached_bids']:,} "
          f"cached bids, {sp['full_scan_rows']:,} full scans); warp 0 latency per bid: "
          f"{latency}", flush=True)
    return t


# The solver's spans as the reference records them, name -> parent's name:
# a dispatch's three, and the two its first result() adds (none for the
# dense batch, which reads back inside its dispatch).
SOLVE_SPANS = {"solver.solve": None, "solver.host_transfer": "solver.solve",
               "solver.dispatch": "solver.solve"}
RESULT_SPANS = {"solver.solve_loop": "solver.solve", "solver.readback": "solver.solve"}
PATH_KINDS = {"structured": "structured", "dense": "dense", "structured_batch": "structured_batch",
              "dense_batch": "dense_batch", "structured_100k": "structured"}
PHASE_SPANS = ("solver.host_transfer", "solver.dispatch", "solver.solve_loop", "solver.readback")
SPAN_COST_N = 10_000  # empty spans, then record_span calls, behind one span's cost


def span_links(record) -> list:
    """(name, parent's name) of each span of a finished trace, sorted."""
    names = {s["span_id"]: s["name"] for s in record["spans"]}
    return sorted((s["name"], names.get(s["parent_span_id"])) for s in record["spans"])


def check_solve_spans(path) -> None:
    """The last finished trace is `path`'s solve: the reference's span set,
    parent links and `kind`."""
    from jobset_tpu_torch.obs import trace as obs_trace

    record = obs_trace.TRACER.finished_traces(limit=1)[0]
    want = dict(SOLVE_SPANS, **({} if path == "dense_batch" else RESULT_SPANS))
    got = span_links(record)
    attrs = {s["name"]: s["attributes"] for s in record["spans"]}
    check(got == sorted(want.items())
          and attrs["solver.solve"].get("kind") == PATH_KINDS[path],
          f"solver path {path}: spans and parents as the reference's ({got}; kind "
          f"{attrs.get('solver.solve', {}).get('kind')})")


def duration_lengths() -> dict:
    from jobset_tpu_torch.obs import trace as obs_trace

    return {k: len(v) for k, v in obs_trace.TRACER.span_durations_s().items()}


def phase_percentiles(since: dict) -> dict:
    """p50 / p99 ms of each solver phase span ended since `since` (the
    duration log's lengths then), with the sample count."""
    from jobset_tpu_torch.obs import trace as obs_trace

    out = {}
    for name, samples in obs_trace.TRACER.span_durations_s().items():
        fresh = [1e3 * x for x in samples[since.get(name, 0):]]
        if name in PHASE_SPANS and fresh:
            out[name] = {"p50_ms": pct(fresh, 0.5), "p99_ms": pct(fresh, 0.99), "n": len(fresh)}
    return out


SOLVER_KERNELS = ("solver_auction", "solver_auction_structured",
                  "solver_auction_structured_batch", "solver_auction_batch")


def compile_keys() -> dict:
    """The signatures each auction kernel has been called at in-process
    (`jit_shape_call`'s record), by kernel."""
    from jobset_tpu_torch.obs import profile

    return {k: set(profile._SEEN_SHAPES.get(k, ())) for k in SOLVER_KERNELS}


def solver_obs_checks(calls, keys_before, grad, big, storm, hetero, hetero8, shapes) -> dict:
    """After the main paths: the histogram counted every solve, each
    signature first met on them missed once and `jobset_jit_compiles_total`
    per kernel equals those signatures, the h2d bytes per kernel equal the
    copies' nbytes; compile seconds per kernel."""
    from jobset_tpu_torch.core import metrics
    from jobset_tpu_torch.obs import trace as obs_trace
    from jobset_tpu_torch.placement import solver as S

    hist = metrics.solver_solve_time_seconds
    solves = sum(calls.values())
    check(hist.n == solves == len(hist.raw),
          f"solver obs: the solve-time histogram counted {hist.n} solves, {len(hist.raw)} raw "
          f"samples; {solves} made ({calls})")
    caches = [s["attributes"]["compile_cache"] for r in obs_trace.TRACER.finished_traces()
              for s in r["spans"] if s["name"] == "solver.dispatch"]
    keys = {k: sorted(map(repr, v - keys_before[k])) for k, v in compile_keys().items()}
    per_kernel = {k: len(v) for k, v in keys.items()}
    compiles = {k: (metrics.jit_compiles_total.value(k), metrics.jit_compile_seconds.count(k))
                for k in per_kernel}
    check(len(caches) == solves and caches.count("miss") == sum(per_kernel.values())
          and all(compiles[k] == (float(n), n) for k, n in per_kernel.items()),
          f"solver obs: compile_cache 'miss' once per new signature ({caches.count('miss')} "
          f"misses in {len(caches)} dispatches, signatures per kernel {per_kernel}); "
          f"jobset_jit_compiles_total and the compile-seconds count per kernel {compiles} "
          f"equal them")
    (jobs_p, domains_p), big_p = shapes

    def structured_bytes(problem, dp):
        stacked = S._stack_structured([problem], jobs_p, dp)
        return sum(stacked[name][0].nbytes for name in S._STRUCTURED)

    want = {"solver_auction_structured": (calls["structured"] * structured_bytes(grad, domains_p)
                                          + calls["structured_100k"] * structured_bytes(big, big_p)),
            "solver_auction": calls["dense"] * (hetero.nbytes + hetero.size),
            "solver_auction_batch": calls["dense_batch"] * (hetero8.nbytes + hetero8.size),
            # The storm's rounds repeat one problem set: its first round
            # copies every operand and the rest find them resident.
            "solver_auction_structured_batch": sum(
                a.nbytes for a in S._stack_structured(storm, jobs_p, domains_p).values())}
    got = {k: metrics.jit_transfer_bytes_total.value(k, "h2d") for k in want}
    check(got == {k: float(v) for k, v in want.items()}
          and metrics.jit_transfer_bytes_total.total() == sum(got.values()),
          f"solver obs: h2d bytes per kernel equal the copies' nbytes ({got})")
    seconds = {labels[0]: {"n": h.n, "mean_s": h.sum / h.n}
               for labels, h in metrics.jit_compile_seconds.children()}
    for kernel, v in seconds.items():
        print(f"jobset_jit_compile_seconds {kernel}: {v['n']} first calls, mean "
              f"{1e3 * v['mean_s']:.3f} ms (the first launch at a shape, to the device's end)",
              flush=True)
    return {"solves": solves, "histogram_count": hist.n,
            "solve_time_exact_ms": {q: 1e3 * hist.exact_percentile(q) for q in (0.5, 0.99)},
            "compile_keys": keys, "compiles": compiles,
            "h2d_bytes": got, "compile_seconds": seconds}


HOOK_AB_ROUNDS = 6  # rounds of the in-place A/B, each variant once a round
HOOK_AB_SOLVES = {"structured": 5, "dense": 40}  # solves of a path a variant a round


class _NoSpan:
    """A span that records nothing: the A/B's stand-in for every hook."""

    context = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attribute(self, key, value):
        return self


class _NoMetric:
    def set(self, *args):
        pass

    def observe(self, *args, **kwargs):
        pass


def hook_cost_ab(paths) -> dict:
    """The hooks' host cost in place: rounds in turn, each running every
    variant on each of `paths` — the hooks live with the tracer's duration
    log and the histogram's raw samples on, live with both off, and every
    hook a no-op (spans, `record_span`, the solver's three metric
    families, `jit_shape_call` straight to its kernel, `note_transfer`).
    The variants' order turns each round. -> {path: {variant: wall p50 ms
    and samples}}."""
    from jobset_tpu_torch.core import metrics
    from jobset_tpu_torch.obs import profile
    from jobset_tpu_torch.obs import trace as obs_trace

    tracer, hist = obs_trace.TRACER, metrics.solver_solve_time_seconds
    live = (obs_trace.span, profile.jit_shape_call, profile.note_transfer,
            metrics.solver_batch_occupancy, metrics.solver_batch_problems, hist)
    log, raw = tracer._duration_log, hist.raw
    nop, nometric = _NoSpan(), _NoMetric()

    def use(variant):
        hooks = variant != "no hooks"
        (obs_trace.span, profile.jit_shape_call, profile.note_transfer,
         metrics.solver_batch_occupancy, metrics.solver_batch_problems,
         metrics.solver_solve_time_seconds) = live if hooks else (
            lambda *a, **k: nop, lambda kernel, fn, *a, **k: (fn(*a, **k), False),
            lambda *a: None, nometric, nometric, nometric)
        if hooks:
            tracer.__dict__.pop("record_span", None)
        else:
            tracer.record_span = lambda *a, **k: None
        tracer._duration_log = log if variant == "hooks, log on" else None
        hist.raw = raw if variant == "hooks, log on" else None

    variants = ["hooks, log on", "hooks, log off", "no hooks"]
    samples = {path: {v: [] for v in variants} for path in paths}
    try:
        for r in range(HOOK_AB_ROUNDS):
            for variant in variants[r % 3:] + variants[:r % 3]:
                use(variant)
                for path, fn in paths.items():
                    samples[path][variant] += wall_ms(fn, HOOK_AB_SOLVES[path])[2]
    finally:
        use("hooks, log on")
    return {path: {v: {"p50_ms": pct(x, 0.5), "samples": x} for v, x in by.items()}
            for path, by in samples.items()}


def hook_part_costs_us(operands, max_iters: int, n: int = SPAN_COST_N) -> dict:
    """Host µs of each hook's part alone, the mean of n in a row, as a
    dense solve makes them (the duration log and raw samples as they
    are): `jit_shape_call`'s signature on the structured solve's seven
    operands (a hit, its kernel a no-op), the two gauge sets,
    `Histogram.observe` (on a histogram of its own), an `activate=True`
    span with the dense `solver.solve` attributes, a `record_span` with the
    `solver.solve_loop` ones, and `note_transfer` of two arrays (on a
    kernel name of its own)."""
    from jobset_tpu_torch.core import metrics
    from jobset_tpu_torch.obs import profile
    from jobset_tpu_torch.obs import trace as obs_trace

    hist = metrics.Histogram("cost_observe_seconds")
    hist.raw = [] if metrics.solver_solve_time_seconds.raw is not None else None
    cost, mask = np.zeros((1, 512, 960), np.float32), np.ones((1, 512, 960), bool)
    attrs = {"algorithm": "auction", "jobs": 512, "domains": 960, "iterations": 28}
    parts = {
        "jit_shape_call signature (hit)": lambda: profile.jit_shape_call(
            "solver_auction_structured", lambda *a, **k: None, *operands,
            max_iters=max_iters, batched=False),
        "two gauge sets": lambda: (metrics.solver_batch_occupancy.set(0.9375),
                                   metrics.solver_batch_problems.set(1)),
        "Histogram.observe": lambda: hist.observe(0.00125),
        "span, activate=True": lambda: obs_trace.span(
            "cost.solve", {"kind": "dense", "jobs": 512, "domains": 960},
            activate=True).__exit__(None, None, None),
        "record_span": lambda: obs_trace.TRACER.record_span("cost.solve_loop", 0.001, attrs),
        "note_transfer": lambda: profile.note_transfer("cost.transfer", "h2d", cost, mask),
    }
    out = {}
    for name, fn in parts.items():
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = 1e6 * (time.perf_counter() - t0) / n
    return out


def span_cost_us(n: int = SPAN_COST_N) -> tuple[float, float]:
    """Host µs of one empty `span()` block and of one `record_span` call, each
    the mean of n in a row (the duration log on, as in the solves)."""
    from jobset_tpu_torch.obs import trace as obs_trace

    t0 = time.perf_counter()
    for _ in range(n):
        with obs_trace.span("cost.empty"):
            pass
    t1 = time.perf_counter()
    for _ in range(n):
        obs_trace.TRACER.record_span("cost.recorded", 0.0)
    t2 = time.perf_counter()
    return 1e6 * (t1 - t0) / n, 1e6 * (t2 - t1) / n


def phase_solver(results):
    """The solver plane: kernel checks, times, the main paths' launches."""
    from scipy.optimize import linear_sum_assignment

    from jobset_tpu_torch.core import metrics
    from jobset_tpu_torch.obs import trace as obs_trace
    from jobset_tpu_torch.ops import auction as ops
    from jobset_tpu_torch.placement import solver as S
    from jobset_tpu_torch.placement.service import (SolverService, pack_problem,
                                                    unpack_assignment)

    card = results["card"]
    grad = gradient_problem(SOLVER_DOMAINS, seed=0)
    storm = [gradient_problem(SOLVER_DOMAINS, seed=1 + i) for i in range(STORM_PROBLEMS)]
    big = gradient_problem(BIG_DOMAINS, seed=9)
    hetero = hetero_costs(17)
    hetero8 = np.stack([hetero_costs(17 + i) for i in range(STORM_PROBLEMS)])
    jobs_p, domains_p, big_p = (S._round_up_pow2(n) for n in
                                (SOLVER_JOBS, SOLVER_DOMAINS, BIG_DOMAINS))

    # -- the kernel against its plain version, on the card; the plain
    #    version's one call there is also its time
    errs, plain = {}, {}

    def compare(label, kernel, reference):
        got = kernel()
        want, secs = wall_s(reference)
        plain[label] = 1e3 * secs
        errs[label] = auction_agree(label, got, want)
        return got

    grad_ops, storm_ops, big_ops = (structured_operands(p) for p in ([grad], storm, [big]))
    for label, ops_ in (("structured 512x960", grad_ops),
                        ("structured storm 8x512x960", storm_ops),
                        ("structured 100k-node 512x6250", big_ops)):
        compare(label, lambda: ops.structured(*ops_, batched=len(ops_[0]) > 1),
                lambda: S._auction_plain(S._structured_benefit(*ops_)))
    singles = [ops.structured(*(t[b:b + 1] for t in storm_ops)) for b in range(STORM_PROBLEMS)]
    storm_got = ops.structured(*storm_ops, batched=True)
    check(all(torch.equal(storm_got[0][b], s[0][0]) and torch.equal(storm_got[2][b], s[2][0])
              for b, s in enumerate(singles)),
          "auction storm: each member's assignment and iterations equal its single solve")
    hetero_b, hetero8_b = dense_benefit(hetero[None]), dense_benefit(hetero8)
    got = compare("dense 512x960", lambda: ops.dense(hetero_b), lambda: S._auction_plain(hetero_b))
    assign = got[0][0, :SOLVER_JOBS].cpu().numpy()
    rows, cols = linear_sum_assignment(hetero)
    ours, best = float(hetero[np.arange(SOLVER_JOBS), assign].sum()), float(hetero[rows, cols].sum())
    check(bool((assign < SOLVER_DOMAINS).all()) and ours == best,
          f"auction heterogeneous dense 512x960: exactly optimal (cost {ours} vs scipy {best})")
    results["hetero_cost"] = {"auction": ours, "scipy": best}
    compare("dense batch 8x512x960", lambda: ops.dense(hetero8_b, batched=True),
            lambda: S._auction_plain(hetero8_b))
    for label, (cost, feasible) in edge_cases().items():
        b = dense_benefit(cost[None], None if feasible is None else feasible[None])
        compare(f"edge {label}", lambda: ops.dense(b), lambda: S._auction_plain(b))
    edge = dict(load=np.zeros(1, np.float32), free=np.full(1, 8.0, np.float32),
                pods_needed=np.full(5, 4.0, np.float32), sticky=np.array([0, -1, -1, 0, -1],
                                                                          np.int32),
                occupied=np.zeros(1, bool), own_domain=np.full(5, -1, np.int32))
    e_ops = structured_operands([edge])
    compare("edge structured 5 jobs x 1 domain", lambda: ops.structured(*e_ops),
            lambda: S._auction_plain(S._structured_benefit(*e_ops)))

    # -- times: kernel, plain version, bound, scipy on the host; the SM
    #    clock that converts the kernel's cycle counts, read while 20
    #    structured solves (over a second of work) keep the card busy
    clock, clock_max = sm_clock_mhz(lambda: ops.structured(*grad_ops), ITERS)
    results["sm_clock_mhz"] = {"under_load": clock, "max": clock_max}
    print(f"SM clock under the structured solve (nvidia-smi): {clock:.0f} MHz "
          f"(max {clock_max:.0f} MHz; {card})", flush=True)
    grad_cost = S._structured_cost_np(*(grad[k] for k in S._STRUCTURED))
    big_cost = S._structured_cost_np(*(big[k] for k in S._STRUCTURED))
    times = {
        "structured": time_auction(
            "structured 512x960", lambda: ops.structured(*grad_ops),
            plain["structured 512x960"], jobs_p, domains_p, scipy_ms(*grad_cost), clock),
        "dense": time_auction(
            "heterogeneous dense 512x960", lambda: ops.dense(hetero_b),
            plain["dense 512x960"], jobs_p, domains_p, scipy_ms(hetero), clock),
        "structured_batch": time_auction(
            "structured storm 8x512x960", lambda: ops.structured(*storm_ops, batched=True),
            plain["structured storm 8x512x960"], jobs_p, domains_p,
            sum(scipy_ms(*S._structured_cost_np(*(p[k] for k in S._STRUCTURED)))
                for p in storm), clock),
        "dense_batch": time_auction(
            "heterogeneous dense batch 8x512x960", lambda: ops.dense(hetero8_b, batched=True),
            plain["dense batch 8x512x960"], jobs_p, domains_p,
            sum(scipy_ms(c) for c in hetero8), clock),
        "structured_100k": time_auction(
            "structured 100k-node 512x6250", lambda: ops.structured(*big_ops),
            plain["structured 100k-node 512x6250"], jobs_p, big_p, scipy_ms(*big_cost), clock),
    }
    del grad_ops, storm_ops, big_ops, hetero_b, hetero8_b

    # -- the main paths, through the surface a user calls (auto routing,
    #    the card); counts reset just before each path and read just after.
    #    The obs hooks from an empty registry: the tracer's duration log
    #    and the histogram's raw samples on before the first solve
    metrics.reset()
    obs_trace.TRACER.reset()
    obs_trace.TRACER.enable_duration_log()
    metrics.solver_solve_time_seconds.enable_raw()
    keys_before = compile_keys()
    solver = S.AssignmentSolver()
    solver.solve_structured_async(**grad).result()  # warm-up: the ping, the allocator
    calls = {"structured": 1}  # solves made through each path
    launches, walls, phases = {}, {}, {}
    paths = {
        "structured": lambda: solver.solve_structured_async(**grad).result(),
        "dense": lambda: solver.solve(hetero),
        "structured_batch": lambda: [p.result()
                                     for p in solver.solve_structured_batch_async(storm)],
        "dense_batch": lambda: solver.solve_batch(hetero8),
        "structured_100k": lambda: solver.solve_structured_async(**big).result(),
    }
    outs = {}
    for path, fn in paths.items():
        routes = dict(solver.routes)
        reset_auction()
        outs[path] = fn()
        counts = auction_counts()
        launches[path] = counts
        want = {name: 0 for name in AUCTION_COUNTERS}
        want.update(AUCTION_LAUNCHES=1, **{PATH_COUNTERS[path]: 1})
        check(counts == want and solver.routes["cuda"] == routes["cuda"] + 1
              and solver.routes["cpu"] == routes["cpu"],
              f"solver path {path}: one launch of its variant, routed to the card ({counts})")
        check_solve_spans(path)
        since = duration_lengths()
        walls[path] = wall_ms(fn, SOLVE_REPEATS if path != "structured_100k" else 5)
        calls[path] = calls.get(path, 0) + 1 + len(walls[path][2])
        phases[path] = phase_percentiles(since)
    obs = solver_obs_checks(calls, keys_before, grad, big, storm, hetero, hetero8,
                            ((jobs_p, domains_p), big_p))
    obs["phases"] = phases
    on_cpu = S.AssignmentSolver(backend="default", device="cpu")
    check(np.array_equal(outs["structured"], on_cpu.solve_structured_async(**grad).result()),
          "structured 512x960: the card's solve equals the plain version's on the CPU")
    check(all(np.array_equal(a, b) for a, b in zip(
        outs["structured_batch"], [solver.solve_structured_async(**p).result() for p in storm])),
        "storm: each member's result equals its single solve through the surface")
    check(np.array_equal(outs["dense"], assign.astype(np.int64)),
          "dense solve through the surface equals the kernel's direct result")
    check(solver.batch_operand_reuses > 0,
          f"storm residency: repeated rounds reuse operands on the card "
          f"({solver.batch_operand_transfers} copies, {solver.batch_operand_reuses} reuses)")
    for path, (p50, p99, _) in walls.items():
        print(f"solve wall {path} (host clock, result on the host; {card}): p50 {p50:.4f} ms, "
              f"p99 {p99:.4f} ms over {len(walls[path][2])} solves", flush=True)
        print("  phase spans: " + ", ".join(
            f"{name.removeprefix('solver.')} p50 {v['p50_ms']:.4f} / p99 {v['p99_ms']:.4f} ms"
            for name, v in phases[path].items()), flush=True)

    # -- solve_async does not block. The heterogeneous problem is polled
    #    right after dispatch; its dispatch carries the 2.5 MB cost copy,
    #    which outlasts its 28-round solve, so dispatch against device time
    #    is shown on the structured problem, whose solve runs far longer.
    def dispatch(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pending = fn()
        dispatch_ms = 1e3 * (time.perf_counter() - t0)
        ready_now = pending.is_ready()
        pending.result()
        return dispatch_ms, ready_now

    async_ = {}
    for key, fn in (("dense", lambda: solver.solve_async(hetero)),
                    ("structured", lambda: solver.solve_structured_async(**grad))):
        dispatch_ms, ready_now = dispatch(fn)
        async_[key] = {"dispatch_ms": dispatch_ms, "ready_right_after": ready_now,
                       "kernel_ms": times[key]["ms"]}
        print(f"solve_async {key}: dispatch {dispatch_ms:.4f} ms (host), is_ready() "
              f"{ready_now} right after, kernel {times[key]['ms']:.4f} ms (device)", flush=True)
    check(not async_["dense"]["ready_right_after"]
          and not async_["structured"]["ready_right_after"]
          and async_["structured"]["dispatch_ms"] < 0.1 * async_["structured"]["kernel_ms"],
          "solve_async returns before the solve ends: is_ready() False right after dispatch "
          "(heterogeneous dense and structured), structured dispatch under a tenth of its "
          "kernel time")
    results["solve_async"] = async_

    # -- the sidecar's handlers in process (the card's machine has no grpc)
    service = SolverService(solver=solver)
    frame2, frame3 = pack_problem(hetero, None), pack_problem(hetero8, None)
    reset_auction()
    got2 = unpack_assignment(service.solve(frame2, None))
    got3 = unpack_assignment(service.solve(frame3, None))
    streamed = [unpack_assignment(r) for r in service.solve_stream(iter([frame2, frame3]), None)]
    launches["sidecar"] = auction_counts()
    check(launches["sidecar"]["DENSE_LAUNCHES"] == 2
          and launches["sidecar"]["DENSE_BATCH_LAUNCHES"] == 2,
          f"sidecar: solve and solve_stream launched the kernel ({launches['sidecar']})")
    check(np.array_equal(got2, outs["dense"]) and np.array_equal(got3, outs["dense_batch"])
          and np.array_equal(streamed[0], outs["dense"])
          and np.array_equal(streamed[1], outs["dense_batch"]),
          "sidecar: packed 512x960 and [8,512,960] frames give the direct solves' assignments")

    # -- one span's cost on this host, beside a solve's wall p50 (a solve
    #    records five spans)
    empty_us, recorded_us = span_cost_us()
    obs["span_cost_us"] = {"span": empty_us, "record_span": recorded_us}
    for path in ("structured", "dense"):
        share = 5 * max(empty_us, recorded_us) / (1e3 * walls[path][0])
        print(f"one span: {empty_us:.3f} µs (empty `span()` block), {recorded_us:.3f} µs "
              f"(`record_span`), means of {SPAN_COST_N}; a {path} solve's five spans "
              f"<= {5 * max(empty_us, recorded_us):.2f} µs beside its wall p50 "
              f"{walls[path][0]:.4f} ms ({100 * share:.3f}%; {card})", flush=True)
    # -- the hooks' host cost in place, and each part alone
    ab = hook_cost_ab({path: paths[path] for path in HOOK_AB_SOLVES})
    obs["hook_ab"] = ab
    for path, by in ab.items():
        none = by["no hooks"]["p50_ms"]
        print(f"hooks in place, {path} ({card}; {HOOK_AB_ROUNDS} rounds in turn): wall p50 "
              + ", ".join(f"{v} {x['p50_ms']:.4f} ms ({1e3 * (x['p50_ms'] - none):+.1f} µs)"
                          for v, x in by.items()) + f" over {len(by['no hooks']['samples'])} "
              "solves each", flush=True)
    struct_ops = [torch.from_numpy(a).cuda() for a in
                  S._stack_structured([grad], jobs_p, domains_p).values()]
    obs["hook_parts_us"] = hook_part_costs_us(struct_ops, solver.max_iters)
    print("hook parts alone (µs, means of " + f"{SPAN_COST_N}; {card}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in obs["hook_parts_us"].items()), flush=True)
    obs_trace.TRACER.reset()

    results["solver"] = {"times": times, "launches": launches, "errs": errs, "obs": obs,
                         "walls": {k: {"p50": v[0], "p99": v[1], "samples": v[2]}
                                   for k, v in walls.items()},
                         "residency": [solver.batch_operand_transfers,
                                       solver.batch_operand_reuses],
                         "routes": solver.routes}
    src = "jobset_tpu_torch/ops/csrc/auction.cu"
    xla = "; an XLA program (lax.while_loop), no Pallas counterpart"
    entries = [
        ("auction_structured", "structured", "jobset_tpu/placement/solver.py:317 "
         "(_auction_structured, around _auction at :77)" + xla, "structured 512x960",
         "structured 512x960 (15k nodes): load gradient, 64 sticky jobs, 16 own domains, "
         "32 domains owned by other JobSets; padded to 512x1024"),
        ("auction_dense", "dense", "jobset_tpu/placement/solver.py:77 (_auction)" + xla,
         "dense 512x960", "heterogeneous dense 512x960 (bench.py seed 17, integer costs "
         "0..255); padded to 512x1024"),
        ("auction_structured_batch", "structured_batch",
         "jobset_tpu/placement/solver.py:370 (_auction_structured_batch)" + xla,
         "structured storm 8x512x960", "8 structured 512x960 problems (seeds 1..8), one launch"),
        ("auction_dense_batch", "dense_batch",
         "jobset_tpu/placement/solver.py:363 (_auction_batch)" + xla,
         "dense batch 8x512x960", "8 heterogeneous dense 512x960 problems (seeds 17..24), "
         "one launch; the sidecar's SolveBatch path"),
    ]
    kernels = []
    for name, key, replaces, err_key, shape in entries:
        t = times[key]
        path = "sidecar" if key == "dense_batch" else key
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[path][PATH_COUNTERS[key]],
            "max_abs_err": errs[err_key],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "library_call": "none: no PyTorch call computes a linear assignment; scipy's "
                            "Hungarian on the host is the yardstick (scipy_host_ms)",
            "scipy_host_ms": t["scipy_ms"], "iterations": t["iterations"],
            "shape": shape,
            "solve_wall_ms": {"p50": walls[key][0], "p99": walls[key][1]},
            "us_per_round": t["us_per_round"], "round_split_us": t["split_us"],
            "bound_bytes": t["bound_bytes"], "read_bytes": t["read_bytes"],
        }
        if key == "structured":
            big_t = times["structured_100k"]
            entry["shape_100k_nodes"] = {
                "shape": "structured 512x6250 padded to 512x8192", "ms": big_t["ms"],
                "plain_ms": big_t["plain_ms"], "bound_ms": big_t["bound_ms"],
                "bound_bytes": big_t["bound_bytes"], "read_bytes": big_t["read_bytes"],
                "round_split_us": big_t["split_us"],
                "scipy_host_ms": big_t["scipy_ms"], "iterations": big_t["iterations"],
                "solve_wall_ms": {"p50": walls["structured_100k"][0],
                                  "p99": walls["structured_100k"][1]},
                "max_abs_err": errs["structured 100k-node 512x6250"]}
        kernels.append(entry)
    return kernels


# ---------------------------------------------------------------------------
# Phase 10: the control plane's device programs
# ---------------------------------------------------------------------------

# Each program's card path is held to the port's CPU path (or its plain
# numpy version) on the same inputs, made with numpy from seeds. Scorer:
# feasibility and both share vectors bit for bit against the greedy numpy
# path. Aggregate: the three counts exactly against numpy bincount. MLP:
# max|got - want| <= 1e-6 * max(max|want|, 1) against forward_np and the
# port's CPU path (f32 products in another order; three layers). Trainer:
# two card runs give byte-identical checkpoints; against the CPU path,
# losses within 1e-5 relative and every parameter within 1e-4 of the
# largest magnitude of its tensor (200 full-batch steps compound
# differences in the order of the gradient's sums).
CONTROL_REPEATS = 30  # wall-clock calls behind each p50/p99
MLP_TOL, TRAIN_LOSS_TOL, TRAIN_PARAM_TOL = 1e-6, 1e-5, 1e-4
# The queue bench's shape (bench.py's run_queue_bench: 64 queues of 16
# pods in 8 cohorts, 512 workloads of 1/2/4/8 pods) and a large one.
SCORER_SHAPES = {"bench 64q x 1r x 8c, 512 candidates": (64, 1, 8, 512),
                 "large 1024q x 8r x 64c, 16384 candidates": (1024, 8, 64, 16384)}
# The aggregate at the reference's jit threshold (_JAX_MIN_ROWS pods, 1024
# job rows) and at 100k-node scale (2^20 pod rows, 2^16 job rows).
AGG_SHAPES = {"16384 pods x 1024 jobs": (16384, 1024), "2^20 pods x 2^16 jobs": (1 << 20, 1 << 16)}
# Candidate domains a placement scores: the 15k- and 100k-node shapes.
MLP_ROWS = (960, 6250)
TRAIN_EXAMPLES, TRAIN_EPOCHS, TRAIN_LR = 16384, 200, 0.05


def kernels_per_call(fn, tries: int = 3):
    """(CUDA kernels, copies and sets, device busy ms) of one call of fn,
    by torch.profiler (busy: the union of its device events' spans). Now
    and then a trace holds no device event at all; the call is then
    traced again, up to `tries` times, and (None, None, None) means that
    no trace saw one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if device:
            copies = sum(1 for e in device if e.name.startswith(("Memcpy", "Memset")))
            busy = merged_span_us((e.time_range.start, e.time_range.end) for e in device)
            return len(device) - copies, copies, busy / 1e3
    return None, None, None


def control_row(label, call, device_call, plain_call, nbytes, flops=0.0, iters=20):
    """Times of one program at one shape: wall p50/p99 of `call` (host clock
    to the result on the host), ms of `device_call` (inputs already on the
    card) by CUDA events over back-to-back calls (a program of many small
    launches is held there by the host's launch rate), CUDA kernels a
    `call` launches and their device busy time, the plain path's wall
    time, and the bound for `nbytes` at 3.35 TB/s (or its f32 operations
    at 67 TFLOP/s, whichever is larger)."""
    p50, p99, _ = wall_ms(call, CONTROL_REPEATS)
    dev = cuda_ms(device_call, iters)
    kernels, copies, busy = kernels_per_call(call)
    plain_p50, _, _ = wall_ms(plain_call, max(3, CONTROL_REPEATS // 3))
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FMA_FLOPS
    row = {"wall_p50_ms": p50, "wall_p99_ms": p99, "device_ms": dev,
           "kernels_per_call": kernels, "copies_per_call": copies, "device_busy_ms": busy,
           "plain_ms": plain_p50,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes}
    print(f"  {label}: wall p50 {p50:.4f} / p99 {p99:.4f} ms, events {dev:.4f} ms, "
          f"{kernels} kernels + {copies} copies a call, device busy {busy} ms, "
          f"plain {plain_p50:.4f} ms, "
          f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}, {nbytes} B)", flush=True)
    return row


def scorer_snapshot(S, queues, resources, cohorts, candidates, seed, tenths):
    """A snapshot at one shape: the bench's (quota 16 pods a queue, weight
    1 + i % 3, cohort i % 8, requests of 1/2/4/8 pods) or, with `tenths`,
    quotas, usage and requests in steps of 0.1 at random."""
    rng = np.random.default_rng(seed)
    Q, R, C, P = queues, resources, cohorts, candidates
    if tenths:
        declared = rng.random((Q, R)) > 0.1
        nominal = (rng.integers(0, 640, (Q, R)) * 0.1 * declared).astype(np.float32)
        usage = (rng.integers(0, 320, (Q, R)) * 0.1).astype(np.float32)
        request = (rng.integers(0, 160, (P, R)) * 0.1).astype(np.float32)
        cohort = rng.integers(-1, C, Q).astype(np.int32)
        weight = rng.integers(1, 5, Q).astype(np.float32)
        qi = rng.integers(0, Q, P).astype(np.int32)
    else:
        nominal = np.full((Q, R), 16.0, np.float32)
        declared = np.ones((Q, R), bool)
        usage = rng.integers(0, 17, (Q, R)).astype(np.float32)
        request = np.array([(1, 2, 4, 8)[i % 4] for i in range(P)], np.float32)[:, None]
        request = np.repeat(request, R, axis=1)
        cohort = (np.arange(Q) % C).astype(np.int32)
        weight = (1.0 + np.arange(Q) % 3).astype(np.float32)
        qi = (np.arange(P) % Q).astype(np.int32)
    return S.Snapshot([f"r{i}" for i in range(R)], [f"q{i:04d}" for i in range(Q)], nominal,
                      declared, usage * declared, weight, cohort, C, request, qi)


def same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


# Phase 10's obs sequence: the calls each program makes, one bucket shape
# twice (or with other values), so its factory misses once per shape.
OBS_SCORER_CALLS = (("bench 64q x 1r x 8c, 512 candidates", 0, False),
                    ("bench 64q x 1r x 8c, 512 candidates", 0, True),
                    ("large 1024q x 8r x 64c, 16384 candidates", 1, True),
                    ("bench 64q x 1r x 8c, 512 candidates", 0, False))
OBS_AGG_CALLS = ("16384 pods x 1024 jobs", "16384 pods x 1024 jobs", "2^20 pods x 2^16 jobs")
OBS_MLP_ROWS = (960, 1000, 6250)  # buckets 1024, 1024, 8192


def control_obs_sequence(model) -> dict:
    """From an empty registry and empty factory caches, a known call
    sequence through each program on the card: compiles, cache hits and
    misses per program equal what the sequence implies (one miss per
    bucket shape), and the transfer bytes equal the copies' nbytes."""
    from jobset_tpu_torch.core import columnar as CC
    from jobset_tpu_torch.core import metrics
    from jobset_tpu_torch.obs import profile
    from jobset_tpu_torch.policy import features as PF
    from jobset_tpu_torch.policy import model as PM
    from jobset_tpu_torch.queue import scorer as S

    torch.ones(1, device="cuda").cpu()  # the CUDA context, not a program's first call, pays here
    metrics.reset()
    factories = {"queue_scorer": S._kernel, "columnar_agg": CC._agg_kernel,
                 "policy_mlp": PM._kernel}
    for kernel, factory in factories.items():
        factory.cache_clear()
        profile.KERNEL_CACHES.register(kernel, factory)
    want = {k: {"calls": 0, "buckets": set(), "h2d": 0, "d2h": 0} for k in factories}

    def note(kernel, bucket, h2d, d2h):
        w = want[kernel]
        w["calls"] += 1
        w["buckets"].add(bucket)
        w["h2d"] += h2d
        w["d2h"] += d2h

    S._P_HIGH_WATER.clear()
    for label, seed, tenths in OBS_SCORER_CALLS:
        snap = scorer_snapshot(S, *SCORER_SHAPES[label], seed=seed, tenths=tenths)
        arrays = S._pad(snap)  # as score() pads it: the high-water mark is set
        P, R = arrays[6].shape
        Q, C = arrays[0].shape[0], arrays[5].shape[0]
        note("queue_scorer", (P, Q, C, R), sum(a.nbytes for a in arrays), 4 * (2 * P + Q))
        S.score(snap)
    rng = np.random.default_rng(5)
    for label in OBS_AGG_CALLS:
        Pc, Jc = AGG_SHAPES[label]
        cols = (rng.integers(-1, Jc, Pc).astype(np.int32), rng.integers(0, 4, Pc).astype(np.int32),
                (rng.random(Pc) < 0.5).astype(np.int8))
        note("columnar_agg", (Pc, Jc), sum(a.nbytes for a in cols), 3 * 4 * Jc)
        CC.job_counts(*cols, Jc)
    n_params = sum(w.size + b.size for w, b in model.params)
    for rows in OBS_MLP_ROWS:
        rows_p = PM._round_up_pow2(rows)
        note("policy_mlp", (rows_p, model.dims), 4 * (n_params + rows_p * PF.FEATURE_DIM),
             4 * rows_p)
        PM.score(model, (rng.random((rows, PF.FEATURE_DIM)) * 2).astype(np.float32))
    snap = profile.KERNEL_CACHES.snapshot()
    out = {}
    for kernel, w in want.items():
        misses = len(w["buckets"])
        got = {"compiles": metrics.jit_compiles_total.value(kernel),
               "compile_seconds_n": metrics.jit_compile_seconds.count(kernel),
               "hits": snap[kernel]["hits"], "misses": snap[kernel]["misses"],
               "gauges": [metrics.jit_cache_hits.value(kernel),
                          metrics.jit_cache_misses.value(kernel)],
               "h2d": metrics.jit_transfer_bytes_total.value(kernel, "h2d"),
               "d2h": metrics.jit_transfer_bytes_total.value(kernel, "d2h"),
               "compile_s_total": metrics.jit_compile_seconds.total(kernel)}
        check(got["compiles"] == misses and got["compile_seconds_n"] == misses
              and (got["hits"], got["misses"]) == (w["calls"] - misses, misses)
              and got["gauges"] == [float(w["calls"] - misses), float(misses)]
              and (got["h2d"], got["d2h"]) == (float(w["h2d"]), float(w["d2h"])),
              f"control obs {kernel}: {w['calls']} calls over {misses} bucket shapes give "
              f"{got['compiles']:.0f} compiles, {got['hits']} hits, {got['misses']} misses "
              f"(gauges {got['gauges']}); transfers h2d {got['h2d']:.0f} / d2h {got['d2h']:.0f} B "
              f"equal the copies' nbytes ({w['h2d']} / {w['d2h']})")
        print(f"  jobset_jit_compile_seconds {kernel}: {misses} first calls, "
              f"{1e3 * got['compile_s_total']:.3f} ms in all", flush=True)
        out[kernel] = got
    return out


def control_obs_whole_phase() -> dict:
    """At the end of phase 10: each factory missed once per bucket shape it
    met over the whole phase (its cache never evicted), one compile each;
    then the eight families' exposition."""
    from jobset_tpu_torch.core import metrics
    from jobset_tpu_torch.obs import profile

    snap = profile.KERNEL_CACHES.snapshot()
    for kernel, v in snap.items():
        check(v["misses"] == v["currsize"] == metrics.jit_compiles_total.value(kernel),
              f"control obs {kernel}, whole phase: {v['misses']} misses for {v['currsize']} "
              f"bucket shapes, {metrics.jit_compiles_total.value(kernel):.0f} compiles, "
              f"{v['hits']} hits")
    text = metrics.render_prometheus()
    print("render_prometheus() (the eight families):", flush=True)
    for line in text.splitlines():
        print(f"  {line}", flush=True)
    return {"caches": snap, "exposition": text}


def phase_control(results):
    """The scorer, the aggregate, the policy MLP and its trainer on the card."""
    import tempfile

    from jobset_tpu_torch.core import columnar as CC
    from jobset_tpu_torch.device import backend_label
    from jobset_tpu_torch.policy import dataset as PD
    from jobset_tpu_torch.policy import features as PF
    from jobset_tpu_torch.policy import model as PM
    from jobset_tpu_torch.policy import train as PT
    from jobset_tpu_torch.queue import scorer as S

    card, dev = results["card"], torch.device("cuda")
    out: dict = {"card": card, "backend_label": backend_label()}
    check(out["backend_label"] == "cuda", f"control: backend_label() is 'cuda' ({out['backend_label']})")
    mlp_rng = np.random.default_rng(3)  # the model, then the MLP section's rows
    model = PM.PolicyModel(
        params=[(w, (mlp_rng.standard_normal(b.shape) * 0.1).astype(np.float32))
                for w, b in PM.init_params(3)],
        feat_mean=mlp_rng.random(PF.FEATURE_DIM).astype(np.float32),
        feat_std=(0.5 + mlp_rng.random(PF.FEATURE_DIM)).astype(np.float32),
        label_mean=30.0, label_std=12.0)
    print(f"control plane, compile and transfer accounting ({card}):", flush=True)
    out["obs"] = control_obs_sequence(model)

    print(f"control plane, scorer ({card}):", flush=True)
    out["scorer"] = {}
    for (label, shape), seed in zip(SCORER_SHAPES.items(), (0, 1)):
        for tenths in ((False, True) if shape[1] == 1 else (True,)):
            S._P_HIGH_WATER.clear()
            snap = scorer_snapshot(S, *shape, seed=seed, tenths=tenths)
            name = f"{label}, {'tenths' if tenths else 'bench values'}"
            got, want = S.score(snap), S._score_greedy(snap)
            cpu = S.score(snap, device="cpu")
            ok = all(same_bits(getattr(got, f), getattr(want, f)) and
                     same_bits(getattr(cpu, f), getattr(want, f))
                     for f in ("feasible", "queue_share", "candidate_share"))
            check(ok and got.backend == "torch",
                  f"scorer {name}: feasible, queue_share, candidate_share bit for bit "
                  f"against the greedy path (feasible {int(want.feasible.sum())}/{shape[3]})")
            arrays = S._pad(snap)
            tensors = [torch.from_numpy(a).to(dev) for a in arrays]
            P, Q = arrays[6].shape[0], arrays[0].shape[0]
            nbytes = sum(t.nbytes for t in tensors) + P + 4 * (Q + P)
            out["scorer"][name] = control_row(
                name, lambda: S.score(snap),
                lambda: S.score_tensors(*tensors, queues=shape[0], resources=shape[1]),
                lambda: S._score_greedy(snap), nbytes)

    print(f"control plane, gang-readiness aggregate ({card}):", flush=True)
    out["aggregate"] = {}
    rng = np.random.default_rng(2)
    for label, (Pc, Jc) in AGG_SHAPES.items():
        jobs = rng.integers(0, Jc - Jc // 16, Pc).astype(np.int32)
        jobs[rng.random(Pc) < 0.1] = -1
        phase = rng.integers(0, 4, Pc).astype(np.int32)
        ready = (rng.random(Pc) < 0.5).astype(np.int8)
        got = CC.job_counts(jobs, phase, ready, Jc)
        want = CC.job_counts_reference(jobs, phase, ready, Jc)
        check(all(g.dtype == np.int32 and np.array_equal(g, w) for g, w in zip(got, want))
              and len(np.unique(phase)) == 4 and (jobs < 0).any(),
              f"aggregate {label}: active, ready, failed equal numpy bincount exactly "
              f"({int(got[0].sum())} active, {int(got[1].sum())} ready, "
              f"{int(got[2].sum())} failed, {int((jobs < 0).sum())} dead rows)")
        cols = [torch.from_numpy(a).to(dev) for a in (jobs, phase, ready)]
        nbytes = sum(t.nbytes for t in cols) + 3 * 4 * Jc
        out["aggregate"][label] = control_row(
            label, lambda: CC.job_counts(jobs, phase, ready, Jc),
            lambda: CC.count_tensors(*cols, Jc),
            lambda: CC.job_counts_reference(jobs, phase, ready, Jc), nbytes)

    print(f"control plane, policy MLP ({card}):", flush=True)
    out["mlp"] = {}
    rng = mlp_rng
    dims = model.dims
    for rows in MLP_ROWS:
        feats = (rng.random((rows, PF.FEATURE_DIM)) * 2).astype(np.float32)
        got = PM.score(model, feats)
        want = PM.score(model, feats, backend="numpy")
        cpu = PM.score(model, feats, device="cpu")
        scale = max(float(np.abs(want).max()), 1.0)
        err_np = float(np.abs(got - want).max())
        err_cpu = float(np.abs(got - cpu).max())
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32_on = PM.score(model, feats)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        check(got.shape == (rows,) and np.isfinite(got).all()
              and err_np <= MLP_TOL * scale and err_cpu <= MLP_TOL * scale,
              f"policy MLP {rows} rows: max|card - forward_np| {err_np:.3g}, "
              f"max|card - cpu| {err_cpu:.3g} <= {MLP_TOL} * {scale:.4g}")
        check(same_bits(tf32_on, got), f"policy MLP {rows} rows: the same bits with TF32 "
                                       "matmuls allowed in the process")
        rows_p = PM._round_up_pow2(rows)
        mlp = PM.PolicyMLP(model.params)
        x = torch.zeros((rows_p, PF.FEATURE_DIM), device=dev)
        n_params = sum(w.size + b.size for w, b in model.params)
        flops = 2.0 * rows_p * sum(a * b for a, b in zip(dims, dims[1:]))

        def forward():
            with torch.no_grad():
                return mlp(x)

        out["mlp"][f"{rows} rows"] = control_row(
            f"{rows} rows (bucket {rows_p})", lambda: PM.score(model, feats), forward,
            lambda: PM.score(model, feats, backend="numpy"),
            4 * (rows_p * dims[0] + n_params + rows_p), flops)
        out["mlp"][f"{rows} rows"].update(max_abs_err_numpy=err_np, max_abs_err_cpu=err_cpu)

    print(f"control plane, policy trainer ({card}):", flush=True)
    rng = np.random.default_rng(4)
    x = (rng.random((TRAIN_EXAMPLES, PF.FEATURE_DIM)) * 3).astype(np.float32)
    y = ((x[:, 0] * 5 + x[:, 3] ** 2 + rng.random(TRAIN_EXAMPLES)) * 10).astype(np.float32)
    corpus = PD.Dataset(features=x, labels=y, history=PF.DomainHistory(),
                        meta={"synthetic": TRAIN_EXAMPLES})
    runs, walls = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cuda", "cuda", "cpu"):
            t0 = time.perf_counter()
            trained, summary = PT.train(corpus, epochs=TRAIN_EPOCHS, lr=TRAIN_LR, device=device)
            walls.append(1e3 * (time.perf_counter() - t0))
            path = os.path.join(tmp, f"run{len(runs)}.npz")
            PM.save_checkpoint(path, trained)
            with open(path, "rb") as f:
                runs.append((trained, summary, f.read()))
    (card_a, sum_a, bytes_a), (_, _, bytes_b), (cpu_m, sum_cpu, _) = runs
    check(bytes_a == bytes_b, f"trainer: two card runs give byte-identical checkpoints "
                              f"({len(bytes_a)} B)")
    loss_err = max(abs(sum_a[k] - sum_cpu[k]) / max(abs(sum_cpu[k]), 1e-12)
                   for k in ("lossFirst", "lossFinal"))
    param_err = max(float(np.abs(a - c).max() / max(np.abs(c).max(), 1e-30))
                    for (wa, ba), (wc, bc) in zip(card_a.params, cpu_m.params)
                    for a, c in ((wa, wc), (ba, bc)))
    check(loss_err <= TRAIN_LOSS_TOL and param_err <= TRAIN_PARAM_TOL
          and sum_a["lossFinal"] < sum_a["lossFirst"],
          f"trainer: card against the CPU path, losses {sum_a['lossFirst']} -> "
          f"{sum_a['lossFinal']} (cpu {sum_cpu['lossFirst']} -> {sum_cpu['lossFinal']}), "
          f"relative {loss_err:.3g} <= {TRAIN_LOSS_TOL}; parameters {param_err:.3g} of each "
          f"tensor's largest <= {TRAIN_PARAM_TOL}")
    rows_p = PM._round_up_pow2(TRAIN_EXAMPLES)
    flat = [torch.from_numpy(a).to(dev).requires_grad_()
            for wb in PM.init_params(0) for a in wb]
    xd = torch.from_numpy(np.zeros((rows_p, PF.FEATURE_DIM), np.float32)).to(dev)
    yd = torch.zeros(rows_p, device=dev)
    mask = torch.ones(rows_p, device=dev)
    step_ms = cuda_ms(lambda: PT.train_step(flat, xd, yd, mask, TRAIN_LR), 20)
    step_kernels, step_copies, step_busy = kernels_per_call(
        lambda: PT.train_step(flat, xd, yd, mask, TRAIN_LR))
    n_params = sum(t.numel() for t in flat)
    step_bytes = 4 * (rows_p * (PF.FEATURE_DIM + 2) + 2 * n_params + 1)
    step_flops = 6.0 * rows_p * sum(a * b for a, b in zip(card_a.dims, card_a.dims[1:]))
    bound = max(1e3 * step_bytes / HBM_BYTES_PER_S, 1e3 * step_flops / F32_FMA_FLOPS)
    out["trainer"] = {
        "examples": TRAIN_EXAMPLES, "epochs": TRAIN_EPOCHS, "lr": TRAIN_LR,
        "train_wall_ms": walls[:2], "cpu_path_wall_ms": walls[2],
        "step_device_ms": step_ms, "step_device_busy_ms": step_busy,
        "kernels_per_step": step_kernels,
        "copies_per_step": step_copies, "step_bound_ms": bound, "step_bytes": step_bytes,
        "loss_first": sum_a["lossFirst"], "loss_final": sum_a["lossFinal"],
        "cpu_loss_first": sum_cpu["lossFirst"], "cpu_loss_final": sum_cpu["lossFinal"],
        "loss_rel_err": loss_err, "param_rel_err": param_err,
        "checkpoint_bytes": len(bytes_a)}
    print(f"  {TRAIN_EXAMPLES} examples x {TRAIN_EPOCHS} epochs: card {walls[0]:.1f} / "
          f"{walls[1]:.1f} ms, CPU path {walls[2]:.1f} ms; a step {step_ms:.4f} ms on the "
          f"card (busy {step_busy} ms), {step_kernels} kernels + {step_copies} copies, bound "
          f"{bound:.6f} ms", flush=True)
    out["obs"]["whole_phase"] = control_obs_whole_phase()
    results["control"] = out


def phase_control_apart(results):
    """Phase 10 in a process of its own (`--control-only`): in a process
    that has traced before (phases 6-7), torch.profiler dropped device
    events, and the kernel counts read short (2 for the MLP's 11)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "control.json")
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--control-only",
                              "--out", path], capture_output=True, text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 10 in a process of its own exits {run.returncode}")
        if os.path.exists(path):
            with open(path) as f:
                results["control"] = json.load(f).get("control")


# ---------------------------------------------------------------------------
# Phase 11: serving with int8 weights, the int8 KV cache and sampling
# ---------------------------------------------------------------------------

# The int8 kernel against its plain version, per element: bf16
# |got - want| <= 2^-7 |want| + 1e-4 max|want| (the output is rounded once
# to bf16 on both sides, from f32 sums in other orders, which may put the
# two one bf16 ulp apart; an ulp is at most 2^-7 of the value), f32
# 1e-5 max|want| (f32 sums of up to 4096 products in another order).
INT8_REL_BF16, INT8_ABS = 2.0 ** -7, {torch.bfloat16: 1e-4, torch.float32: 1e-5}
# The decode step's int8 launches at the flagship: K, the widths that
# share x, launches a step on the int8 path (4 * LAYERS + 1: a layer's Q, K
# and V are one launch), and products a step on the bf16 path, the
# yardstick's 49 (there Q, K, V and O are four [1024, 1024] products).
INT8_SHAPES = {"wqkv": (1024, (1024, 1024, 1024), LAYERS, 0), "wo": (1024, (1024,), LAYERS, 4 * LAYERS),
               "w1": (1024, (4096,), LAYERS, LAYERS), "w2": (4096, (1024,), LAYERS, LAYERS),
               "unembed": (1024, (32000,), 1, 1)}
INT8_EDGES = [(1, 1024, (1024,)), (16, 1024, (1024,)), (8, 1000, (1000,)), (16, 1030, (4096,)),
              (3, 70, (24,)), (16, 300, (17,))]
# Grouped launches against their members' separate launches: MHA and GQA
# widths (the flagship's heads, and 4 kv heads of 64), 1, 8 and 16 rows,
# and widths that are not multiples of 16.
INT8_GROUPS = ([(rows, 1024, ns) for rows in (1, 8, 16)
                for ns in ((1024, 1024, 1024), (1024, 256, 256))]
               + [(5, 1024, (1024, 17, 64)), (16, 300, (17, 24, 40))])
# The int8 launches of one call: a TTFT call unembeds the prefill's last
# position (8 rows); a generate of n new tokens adds n - 1 steps.
INT8_STEP_LAUNCHES = 4 * LAYERS + 1
INT8_GENERATE_LAUNCHES = 1 + (NEW_TOKENS - 1) * INT8_STEP_LAUNCHES
# run_decode_bench's three serving points (the reference's `decode`,
# `decode_int8`, `decode_int8_kv`), at its shape and at the flagship's.
SERVING_POINTS = {"decode": (False, False), "decode_int8": (True, False),
                  "decode_int8_kv": (True, True)}
SERVING_SHAPES = ((32, 96), (PROMPT, NEW_TOKENS))
BENCH_ROUNDS = 3


@contextlib.contextmanager
def f32_accumulating_plain():
    """The plain version's bf16 matmuls sum in f32 throughout, as on the
    CPU: cuBLAS may otherwise add split-K partial sums in bf16, which put
    the yardstick itself several bf16 ulps off at a skinny N (17). The
    tolerance is unchanged."""
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def int8_operands(dtype, rows, k, ns, gen):
    from jobset_tpu_torch.models import quant

    qts = [quant.quantize_int8(torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5)
           for n in ns]
    return torch.randn((rows, k), generator=gen, device="cuda").to(dtype), qts


def int8_case(name, dtype, rows, k, ns, seed):
    """The kernel against its plain version on one launch of the widths
    `ns` that share x: the stated tolerance, one launch counted, two
    launches equal bit for bit, and a group equal to its members' separate
    launches bit for bit. Returns max|got - want|."""
    from jobset_tpu_torch.ops import int8_matmul as i8

    x, qts = int8_operands(dtype, rows, k, ns, torch.Generator(device="cuda").manual_seed(seed))
    before = i8.INT8_LAUNCHES
    got = i8.int8_matmul_group(x, qts, dtype)
    launched = i8.INT8_LAUNCHES - before
    again = i8.int8_matmul_group(x, qts, dtype)
    apart = [i8.int8_matmul(x, qt, dtype) for qt in qts] if len(qts) > 1 else got
    torch.cuda.synchronize()
    with f32_accumulating_plain():
        wants = i8.int8_matmul_group_plain(x, qts, dtype)
    worst, within = 0.0, True
    for y, want in zip(got, wants):
        err = (y.float() - want.float()).abs()
        limit = INT8_ABS[dtype] * want.float().abs().max().item()
        if dtype == torch.bfloat16:
            limit = INT8_REL_BF16 * want.float().abs() + limit
        within = within and bool((err <= limit).all())
        worst = max(worst, err.max().item())
    check(launched == 1 and all(y.dtype == dtype and tuple(y.shape) == (rows, n)
                                and bool(torch.isfinite(y.float()).all())
                                for y, n in zip(got, ns)),
          f"int8_matmul {name}: one launch, {dtype} [{rows}, {list(ns)}], finite")
    check(within, f"int8_matmul {name}: within tolerance (max|d| {worst:.3e})")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"int8_matmul {name}: two launches equal bit for bit")
    if len(qts) > 1:
        check(all(torch.equal(a, b) for a, b in zip(got, apart)),
              f"int8_matmul {name}: the group equals its members' separate launches bit for bit")
    return worst


def int8_bound_ms(rows, k, n, dtype=torch.bfloat16) -> float:
    """Each input read once and the output written once at HBM rate: the
    int8 weights (n columns in all), their f32 scales, x and y in the
    compute dtype (the operations, 2 * rows * k * n, are far below the
    card's rate for the dtype)."""
    size = torch.tensor([], dtype=dtype).element_size()
    return 1e3 * (k * n + 4 * n + size * rows * (k + n)) / HBM_BYTES_PER_S


def load_baseline(root, module):
    """A wrapper module of another checkout of this repo (its `ops` package
    loaded under another name, its kernel built from its own source), to
    time its kernel beside this one's on the same inputs."""
    import importlib.util
    import types

    ops = os.path.join(os.path.abspath(root), "jobset_tpu_torch", "ops")
    package = sys.modules.get("baseline_ops")
    if package is None:
        package = types.ModuleType("baseline_ops")
        package.__path__ = [ops]
        sys.modules["baseline_ops"] = package
    spec = importlib.util.spec_from_file_location(f"baseline_ops.{module}",
                                                  os.path.join(ops, f"{module}.py"))
    loaded = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = loaded
    spec.loader.exec_module(loaded)
    return loaded


def time_int8(rows, k, ns, dtype, baseline=None) -> dict:
    """L2-cold times of one launch at a decode shape (weight sets of 128 MB
    or more of int8): the kernel; the plain version (dequantize, then
    matmul); the yardstick, torch.matmul against the members' weights
    dequantized to dtype and joined beforehand (the product int8 replaces,
    at 2 or 4 times the weight bytes); and the kernel and the yardstick
    each after a PyTorch elementwise kernel that writes their x, the
    path's pattern (`path_ms`, `library_path_ms`, and that kernel alone,
    `op_ms`). With a baseline wrapper, its kernel on the same inputs, one
    launch a member."""
    from jobset_tpu_torch.models import quant
    from jobset_tpu_torch.ops import int8_matmul as i8

    n_sets = max(2, -(-(128 << 20) // (k * sum(ns))))
    gen = torch.Generator(device="cuda").manual_seed(k + sum(ns))
    sets = [int8_operands(dtype, rows, k, ns, gen)[1] for _ in range(n_sets)]
    dense = [torch.cat([quant.weight_cast(qt, dtype) for qt in qts], dim=1) for qts in sets]
    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    if dtype == torch.float32:
        plain_is_f32("int8_matmul timing")
    one, xp = torch.ones_like(x), torch.empty_like(x)
    out = {
        "ms": rotating_ms(lambda i: i8.int8_matmul_group(x, sets[i], dtype), n_sets, ITERS),
        "plain_ms": rotating_ms(lambda i: i8.int8_matmul_group_plain(x, sets[i], dtype),
                                n_sets, ITERS),
        "library_ms": rotating_ms(lambda i: torch.matmul(x, dense[i]), n_sets, ITERS),
        "path_ms": rotating_ms(lambda i: i8.int8_matmul_group(torch.mul(x, one, out=xp), sets[i],
                                                              dtype), n_sets, ITERS),
        "library_path_ms": rotating_ms(lambda i: torch.matmul(torch.mul(x, one, out=xp), dense[i]),
                                       n_sets, ITERS),
        "op_ms": cuda_ms(lambda: torch.mul(x, one, out=xp), ITERS),
        "bound_ms": int8_bound_ms(rows, k, sum(ns), dtype),
        "bound_by": "bytes",
        "weight_sets": n_sets,
    }
    if baseline is not None:
        out["parent_ms"] = rotating_ms(
            lambda i: [baseline.int8_matmul(x, qt, dtype) for qt in sets[i]], n_sets, ITERS)
    del sets, dense
    torch.cuda.empty_cache()
    return out


def int8_host_us(calls=200, repeats=5) -> dict:
    """Host time to issue one product at a tiny shape (the card keeps up):
    through the wrapper, a group of three through the wrapper, the C
    launch function alone (ctypes, pointers given), and a bf16
    torch.matmul; medians of `repeats` runs of `calls` calls, in µs."""
    from jobset_tpu_torch.models import quant
    from jobset_tpu_torch.ops import int8_matmul as i8

    gen = torch.Generator(device="cuda").manual_seed(3)
    qt = quant.quantize_int8(torch.randn((64, 64), generator=gen, device="cuda"))
    x = torch.randn((BATCH, 64), generator=gen, device="cuda").to(torch.bfloat16)
    dense = quant.weight_cast(qt, torch.bfloat16)
    y = torch.empty((BATCH, 64), dtype=torch.bfloat16, device="cuda")
    lib, stream = i8._library(), torch.cuda.current_stream().cuda_stream
    args = (1, x.data_ptr(), BATCH, 64, 64, *i8._plan(64, (64,), x.device.index), 1,
            qt.q.data_ptr(), qt.scale.data_ptr(), y.data_ptr(), 64, *([None, None, None, 0] * 2),
            1, 0, x.device.index, stream)
    ways = {"int8_matmul": lambda: i8.int8_matmul(x, qt, torch.bfloat16),
            "int8_matmul_group of 3": lambda: i8.int8_matmul_group(x, [qt, qt, qt], torch.bfloat16),
            "launch_alone": lambda: lib.int8_matmul_launch(*args),
            "torch_matmul": lambda: torch.matmul(x, dense)}
    runs = {name: [] for name in ways}
    for _ in range(repeats):
        for name, fn in ways.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs[name].append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return {name: sorted(r)[len(r) // 2] for name, r in runs.items()}


def kernel_ptxas(log: str, kernels: str, no_spills_of: str | None = None) -> dict:
    """Registers and spill bytes of each instantiation of the kernels that
    the regex `kernels` names in an `nvcc -Xptxas -v` log, printed one a
    line with its template arguments (if any). Given `no_spills_of` (what
    the kernels are, for the check's line), a spill fails."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line):
            found = re.search(rf"({kernels})(?:I((?:L[ib]\d+E)+)E|E)", m.group(1))
            if found and found.group(2):
                args = [v if kind == "i" else "true" if v == "1" else "false"
                        for kind, v in re.findall(r"L([ib])(\d+)E", found.group(2))]
                name = f"{found.group(1)}<{', '.join(args)}>"
            elif found:
                name = found.group(1)
            else:
                name = None
            if name:
                out.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    for name, rep in sorted(out.items()):
        print(f"ptxas {name}: {rep.get('registers')} registers, {rep.get('spill_stores')} B spill "
              f"stores, {rep.get('spill_loads')} B spill loads", flush=True)
    if no_spills_of:
        check(bool(out) and all(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0
                                for rep in out.values()),
              f"ptxas: no {no_spills_of} instantiation spills ({len(out)} found)")
    return out


def serving_kernel_checks(results, baseline=None):
    """Phase 11a: the int8 kernel against its plain version at the decode
    shapes, the grouped launches and the edge shapes, bf16 and f32; the
    built kernel's layout tables against the wrapper's; L2-cold times in
    bf16 and f32 (and the baseline's, given one); host time a call."""
    from jobset_tpu_torch.ops import int8_matmul as i8

    check(i8.kernel_layout() == i8.layout(),
          "int8_matmul: the built kernel's constants and layout tables equal the wrapper's")
    smem = {label: i8.dynamic_smem(BATCH, k, ns, dtype)
            for label, (k, ns, _, _) in INT8_SHAPES.items() for dtype in (torch.bfloat16,)}
    print("int8_matmul dynamic shared memory a block, bf16, 8 rows: " + ", ".join(
        f"{label} {b} B" for label, b in smem.items()), flush=True)
    errs = {}
    seed = 20
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, (k, ns, _, _) in INT8_SHAPES.items():
            errs[f"{tag} {label}"] = int8_case(f"{tag} {label} [8,{k}]x[{k},{list(ns)}]", dtype,
                                               BATCH, k, ns, seed)
            seed += 1
        for rows, k, ns in INT8_EDGES + INT8_GROUPS:
            int8_case(f"{tag} [{rows},{k}]x[{k},{list(ns)}]", dtype, rows, k, ns, seed)
            seed += 1
    card = results["card"]
    times, steps = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        times[tag] = {label: time_int8(BATCH, k, ns, dtype, baseline)
                      for label, (k, ns, _, _) in INT8_SHAPES.items()}
        for label, t in times[tag].items():
            k, ns, count, _ = INT8_SHAPES[label]
            parent = f", parent kernel {t['parent_ms']:.4f} ms" if "parent_ms" in t else ""
            print(f"int8_matmul {tag} {label} [8,{k}]x[{k},{list(ns)}] ({count} a step), L2-cold over "
                  f"{t['weight_sets']} weight sets: kernel {t['ms']:.4f} ms{parent}, plain "
                  f"{t['plain_ms']:.4f} ms, library_ms (torch.matmul, {tag} weight) "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes), "
                  f"{t['bound_ms'] / t['ms']:.1%} of bound; after an elementwise kernel: kernel "
                  f"{t['path_ms']:.4f} ms, torch.matmul {t['library_path_ms']:.4f} ms, the "
                  f"elementwise kernel alone {t['op_ms']:.4f} ms ({card})", flush=True)
        step = {key: sum(INT8_SHAPES[label][2] * t[key] for label, t in times[tag].items())
                for key in ("ms", "plain_ms", "bound_ms", "path_ms")
                + (("parent_ms",) if baseline is not None else ())}
        step["library_ms"] = sum(INT8_SHAPES[label][3] * t["library_ms"]
                                 for label, t in times[tag].items())
        step["library_path_ms"] = sum(INT8_SHAPES[label][3] * t["library_path_ms"]
                                      for label, t in times[tag].items())
        steps[tag] = step
        parent = f", parent kernel {step['parent_ms']:.4f} ms" if baseline is not None else ""
        print(f"int8_matmul {tag}, a decode step's {INT8_STEP_LAUNCHES} launches: kernel "
              f"{step['ms']:.4f} ms{parent}, plain {step['plain_ms']:.4f} ms, bound "
              f"{step['bound_ms']:.4f} ms; the bf16 path's "
              f"{sum(v[3] for v in INT8_SHAPES.values())} torch.matmul products on {tag} "
              f"weights {step['library_ms']:.4f} ms; after an elementwise kernel each: kernel "
              f"{step['path_ms']:.4f} ms, torch.matmul {step['library_path_ms']:.4f} ms ({card})",
              flush=True)
    host = int8_host_us()
    print("int8_matmul host time a call, enqueue only (x [8,64], weight [64,64], median of 5 "
          "runs of 200): " + ", ".join(f"{name} {us:.2f} us" for name, us in host.items())
          + f" ({card})", flush=True)
    results["int8_matmul"] = {"max_abs_err": errs, "by_shape": times["bf16"],
                              "f32_by_shape": times["f32"], "decode_step": steps["bf16"],
                              "f32_decode_step": steps["f32"], "host_us": host,
                              "dynamic_smem": smem}


def tree_bits_equal(a, b) -> bool:
    from jobset_tpu_torch import tree

    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.cpu().view(torch.uint8), y.cpu().view(torch.uint8))
        for x, y in zip(la, lb))


def serving_decode_step_trace(cfg, params, label, quantized_kv):
    """torch.profiler over one warm cached decode step (B=8, after a
    1024-token prefill): the step's device busy time, ops and idle share."""
    from jobset_tpu_torch.models import decode

    cast = decode.cast_params(params, cfg.dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    cache = decode.init_kv_cache(cfg, BATCH, PROMPT + 2, "cuda", quantized_kv=quantized_kv)
    with torch.no_grad():
        token = decode._pick_token(decode._prefill_logits(cast, prompt, cache, cfg))
        decode._token_logits(cast, token, cache, PROMPT, cfg)  # warm step
        torch.cuda.synchronize()
        return traced(lambda: decode._pick_token(
            decode._token_logits(cast, token, cache, PROMPT + 1, cfg)), label, "int8_matmul")


def phase_serving(results, baseline=None):
    """Phase 11: the serving path with int8 weights, the int8 KV cache and
    sampling, at the flagship's width and depth. `baseline`: another
    checkout whose int8 kernel is timed beside this one's."""
    from jobset_tpu_torch.models import (TransformerConfig, build_generate, decode,
                                         init_params, quantize_params_for_serving)
    from jobset_tpu_torch.ops import int8_matmul as i8
    from jobset_tpu_torch.runtime.model_bench import run_decode_bench

    serving_kernel_checks(results, load_baseline(baseline, "int8_matmul") if baseline else None)
    card = results["card"]
    cfg = flagship_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    qparams = quantize_params_for_serving(params)
    check(tree_bits_equal(qparams, quantize_params_for_serving(to_device(params, "cpu"))),
          "quantize_params_for_serving: the flagship tree on the card equals the CPU's "
          "bit for bit")
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)

    # The main path: each variant's generate and TTFT call, counts set to 0
    # just before and read just after. Flash launches: the prefill's 24.
    launches = {}
    for point, (quantized, quantized_kv) in SERVING_POINTS.items():
        p = qparams if quantized else params
        flags = dict(quantized=quantized, quantized_kv=quantized_kv)
        generate, first = build_generate(cfg, NEW_TOKENS, **flags), build_generate(cfg, 1, **flags)
        first(p, prompt)  # warm-up (constant masks, cuBLAS)
        torch.cuda.synchronize()
        for call, fn, want_int8 in (("generate", generate, INT8_GENERATE_LAUNCHES),
                                    ("ttft", first, 1)):
            reset_launches()
            i8.INT8_LAUNCHES = 0
            tokens = fn(p, prompt)
            torch.cuda.synchronize()
            counts = {"INT8_LAUNCHES": i8.INT8_LAUNCHES, **launches_now()}
            want = want_int8 if quantized else 0
            launches[f"{point} {call}"] = counts
            check(counts["INT8_LAUNCHES"] == want
                  and counts["TENSOR_CORE_LAUNCHES"] == GENERATE_LAUNCHES
                  and counts["KERNEL_LAUNCHES"] == GENERATE_LAUNCHES,
                  f"{point} {call}: launches {counts} (expected {want} int8, "
                  f"{GENERATE_LAUNCHES} flash on the tensor-core variant)")
            new = NEW_TOKENS if call == "generate" else 1
            check(tuple(tokens.shape) == (BATCH, PROMPT + new)
                  and bool((tokens[:, :PROMPT] == prompt).all())
                  and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                  f"{point} {call}: tokens shape {tuple(tokens.shape)}, prompt kept, ids in vocab")
    results["serving_launches"] = launches

    # Sampling at the flagship (the reference demo's temperature 0.9, top_k
    # 4), int8 weights and cache: tokens in vocab, a seed reproduces them.
    sampler = build_generate(cfg, NEW_TOKENS, temperature=0.9, top_k=4, quantized=True,
                             quantized_kv=True)
    draws = [sampler(qparams, prompt, torch.Generator(device="cuda").manual_seed(s))
             for s in (0, 0, 1)]
    check(torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
          and bool(((draws[0] >= 0) & (draws[0] < cfg.vocab_size)).all()),
          "sampled int8 generate (temperature 0.9, top_k 4): ids in vocab, one seed "
          "reproduces its tokens, another seed differs")

    traces = {}
    for point, (quantized, quantized_kv) in SERVING_POINTS.items():
        traces[point] = serving_decode_step_trace(
            cfg, qparams if quantized else params,
            f"{point} decode step (B={BATCH}, cache {PROMPT + 2})", quantized_kv)
    results["serving_step_traces"] = traces
    del params, qparams
    torch.cuda.empty_cache()

    # Each point's one timed call is host-bound and the host's cores are
    # shared: the three points in turns, BENCH_ROUNDS times, and medians.
    bench = {}
    for prompt_len, new in SERVING_SHAPES:
        runs = {point: [] for point in SERVING_POINTS}
        for _ in range(BENCH_ROUNDS):
            for point, (quantized, quantized_kv) in SERVING_POINTS.items():
                runs[point].append(run_decode_bench(
                    batch=BATCH, prompt_len=prompt_len, max_new_tokens=new,
                    quantized=quantized, quantized_kv=quantized_kv, measure_ttft=True))
        for point, rs in runs.items():
            tps = sorted(r["decode_tokens_per_sec"] for r in rs)
            ttft = sorted(r["ttft_ms"] for r in rs)
            bench[f"{point} prompt {prompt_len} new {new}"] = {
                **rs[0], "decode_tokens_per_sec": tps[len(tps) // 2],
                "ttft_ms": ttft[len(ttft) // 2], "decode_tokens_per_sec_runs": tps,
                "ttft_ms_runs": ttft}
            print(f"run_decode_bench {point} B={BATCH} prompt {prompt_len} new {new}, median "
                  f"of {BENCH_ROUNDS}: {tps[len(tps) // 2]:.1f} new tokens/s ({tps[0]:.1f}-"
                  f"{tps[-1]:.1f}), TTFT {ttft[len(ttft) // 2]:.3f} ms ({ttft[0]:.3f}-"
                  f"{ttft[-1]:.3f}) ({card})", flush=True)
    results["decode_bench"] = bench

    # A small f32 GQA config: the card's tokens equal the CPU path's, with
    # int8 weights, the int8 cache, and both; sampling properties on the card.
    small = TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                              n_layers=2, dtype=torch.float32)
    small_params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    small_q = quantize_params_for_serving(small_params)
    small_prompt = torch.randint(0, 128, (2, 40), generator=torch.Generator().manual_seed(1))
    for label, quantized, quantized_kv in (("int8 weights", True, False),
                                           ("int8 KV cache", False, True),
                                           ("int8 weights and KV cache", True, True)):
        p = small_q if quantized else small_params
        flags = dict(quantized=quantized, quantized_kv=quantized_kv)
        want = build_generate(small, 6, "cpu", **flags)(p, small_prompt)
        got = build_generate(small, 6, **flags)(to_device(p, "cuda"), small_prompt)
        check(torch.equal(got.cpu(), want),
              f"generate small f32 GQA config, {label}: card tokens equal the CPU path's")
    small_card = to_device(small_params, "cuda")
    greedy = build_generate(small, 6)(small_card, small_prompt)
    top1 = build_generate(small, 6, temperature=1.7, top_k=1)(
        small_card, small_prompt, torch.Generator(device="cuda").manual_seed(7))
    check(torch.equal(top1, greedy), "sampling on the card: top_k=1 at temperature 1.7 "
          "equals greedy")
    tied = torch.full((3, 16), 9.0, device="cuda")
    seen = set()
    for seed in range(40):
        seen.update(decode._pick_token(tied, torch.Generator(device="cuda").manual_seed(seed),
                                       1.3, 2).tolist())
    check(seen == {0, 1}, f"sampling on the card: all-tied logits with top_k 2 draw only "
          f"tokens 0 and 1 over 40 seeds (drew {sorted(seen)})")

    t = results["int8_matmul"]
    unembed, f32_unembed = t["by_shape"]["unembed"], t["f32_by_shape"]["unembed"]
    return {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "jobset_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "jobset_tpu/models/quant.py:82",
        "replaces_is": "weight_cast, which XLA fuses into the decode step's dots (no Pallas "
                       "kernel)",
        "launches": launches["decode_int8 generate"]["INT8_LAUNCHES"],
        "launches_by_path": {k: v["INT8_LAUNCHES"] for k, v in launches.items()},
        "max_abs_err": t["max_abs_err"]["bf16 unembed"],
        "max_abs_err_by_shape": t["max_abs_err"],
        "ms": unembed["ms"],
        "plain_ms": unembed["plain_ms"],
        "bound_ms": unembed["bound_ms"],
        "bound_by": "bytes",
        "library_ms": unembed["library_ms"],
        "library_call": "torch.matmul against the weight dequantized to bf16 beforehand",
        "shape": "bf16 x [8, 1024] x int8 [1024, 32000] (the unembedding); L2-cold",
        "by_shape": t["by_shape"],
        "decode_step": t["decode_step"],
        "f32": {"ms": f32_unembed["ms"], "plain_ms": f32_unembed["plain_ms"],
                "bound_ms": f32_unembed["bound_ms"], "bound_by": "bytes",
                "library_ms": f32_unembed["library_ms"],
                "library_call": "torch.matmul against the weight dequantized to f32, TF32 off",
                "by_shape": t["f32_by_shape"], "decode_step": t["f32_decode_step"]},
    }


def phase_serving_apart(results, baseline=None):
    """Phase 11 in a process of its own (`--serving-only`), where the
    profiler has not traced before (see `phase_control_apart`). Returns
    its `kernels` entry."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serving.json")
        extra = ["--int8-baseline", baseline] if baseline else []
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--serving-only",
                              "--out", path, *extra], capture_output=True, text=True,
                             timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 11 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            serving = json.load(f)
    for key in ("int8_matmul", "serving_launches", "serving_step_traces", "decode_bench"):
        results[key] = serving.get(key)
    return serving.get("kernel")


# ---------------------------------------------------------------------------
# Phase 12: mixture-of-experts serving and forward
# ---------------------------------------------------------------------------

# The MoE flagship: the flagship's widths and depth with 8 experts of
# d_ff_expert 4096, token-choice top 2, dropless (Mixtral 8x7B's routing
# shape at this repo's widths).
MOE_EXPERTS, MOE_TOP_K, MOE_D_FF = 8, 2, 4096
MOE_SLOTS = BATCH * PROMPT * MOE_TOP_K  # rows of the prefill's grouped products
# Grouped launches: two products a layer in a prefill (generate and TTFT
# call alike) and in the dropless forward; the decode step runs every
# expert (no grouped launch). int8 launches are the dense model's
# (INT8_GENERATE_LAUNCHES), the two expert stacks in w1's and w2's places.
MOE_GROUPED_LAUNCHES = 2 * LAYERS
# The two products of a prefill layer: (K, N) of xs [slots, K] @ w [E, K, N].
MOE_PRODUCTS = {"we1": (1024, MOE_D_FF), "we2": (MOE_D_FF, 1024)}
MOE_ROUTINGS = ("balanced", "skewed", "empty")
# Checked, not timed: groups ending inside a row tile beside a full group,
# where a store of whole tiles would overwrite the neighbour's rows.
MOE_CHECK_ROUTINGS = MOE_ROUTINGS + ("boundary",)
# The MoE path against its plain path is checked a layer at a time: each
# layer of the kernel path's run again on the same input with the grouped
# products plain (the attention kernel in both, so the router sees the
# same bits and routes alike), within the dense forward's tolerance
# (LOGITS_MAX_REL, LOGITS_MEAN_REL). Through 8 layers end to end the two
# paths route apart: a token whose second and third gates lie within the
# paths' bf16 difference takes another expert in one of them, which moves
# its output wholesale; that divergence is reported, not bounded.


def moe_config(**overrides):
    from dataclasses import replace

    return replace(flagship_config(), **{
        "n_experts": MOE_EXPERTS, "moe_top_k": MOE_TOP_K, "d_ff_expert": MOE_D_FF,
        "moe_dispatch": "dropless", **overrides})


@contextlib.contextmanager
def plain_grouped():
    """Route the MoE path's grouped products to their plain version, on the
    card, for a reference run of the same path. The grouped kernel must not
    launch meanwhile: a caller that reached it by another name would hold
    the kernel against itself."""
    from jobset_tpu_torch.models import transformer
    from jobset_tpu_torch.ops import grouped_matmul as gm

    transformer.grouped_matmul = gm.grouped_matmul_plain
    before = moe_launches_now()
    try:
        yield
    finally:
        transformer.grouped_matmul = gm.grouped_matmul
    moved = {name: moe_launches_now()[name] - before[name] for name in GROUPED_COUNTERS
             if moe_launches_now()[name] != before[name]}
    if moved:
        check(False, f"plain grouped run: the grouped kernels launched {moved} with the plain "
                     "version in their place")


def moe_group_sizes(routing, rows=MOE_SLOTS, experts=MOE_EXPERTS):
    sizes = [0] * experts
    if routing == "balanced":
        sizes = [rows // experts] * experts
    elif routing == "skewed":  # one expert takes every slot
        sizes[3] = rows
    elif routing == "boundary":  # every group but the last ends inside a row tile
        ends = [rows // experts * (e + 1) + (64, 100, 1, 127, 33, 90, 5)[e % 7]
                for e in range(experts - 1)] + [rows]
        sizes = [end - start for start, end in zip([0] + ends, ends)]
    else:  # "empty": three experts take every slot, unevenly, five get none
        sizes[0], sizes[4], sizes[7] = rows // 2, rows // 4, rows - rows // 2 - rows // 4
    return torch.tensor(sizes, dtype=torch.int32, device="cuda")


def grouped_operands(dtype, k, n, gen, rows=MOE_SLOTS):
    xs = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((MOE_EXPERTS, k, n), generator=gen, device="cuda") / k ** 0.5).to(dtype)
    return xs, w


def grouped_bound_ms(rows, k, n, dtype) -> tuple[float, str]:
    """Each input read once and the output written once at HBM rate, or the
    products (2 rows k n, every row routed once) as the kernel does them
    (`PRODUCT_RATE`: bf16 on the tensor cores; f32 as three TF32 products
    on them): the larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    t_bytes = size * (rows * k + MOE_EXPERTS * k * n + rows * n) / HBM_BYTES_PER_S
    peak, passes = PRODUCT_RATE[dtype]
    t_ops = passes * 2 * rows * k * n / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def grouped_fma_bound_ms(rows, k, n) -> float:
    """The f32 products on the FMA pipes instead (true f32, as the plain
    version and torch._grouped_mm do them)."""
    return 1e3 * 2 * rows * k * n / F32_FMA_FLOPS


# The variant each dtype launches at the prefill's products, and the
# counters (all, TMA, f32) one launch of it steps.
GROUPED_VARIANT = {torch.bfloat16: ("tma", (1, 1, 0)), torch.float32: ("f32", (1, 0, 1))}


def grouped_counts() -> tuple:
    from jobset_tpu_torch.ops import grouped_matmul as gm

    return gm.GROUPED_LAUNCHES, gm.GROUPED_TMA_LAUNCHES, gm.GROUPED_F32_LAUNCHES


def grouped_case(name, dtype, k, n, routing, seed, rows=MOE_SLOTS):
    """The kernel against its plain version at one product of a prefill
    layer (or of a gang rank's layer: `rows`, and its tp-local k or n): the
    stated tolerance, one launch counted, two launches equal bit for bit.
    Returns max|got - want|."""
    from jobset_tpu_torch.ops import grouped_matmul as gm

    xs, w = grouped_operands(dtype, k, n, torch.Generator(device="cuda").manual_seed(seed), rows)
    sizes = moe_group_sizes(routing, rows)
    before = grouped_counts()
    got = gm.grouped_matmul(xs, w, sizes)
    launched = tuple(a - b for a, b in zip(grouped_counts(), before))
    again = gm.grouped_matmul(xs, w, sizes)
    torch.cuda.synchronize()
    with f32_accumulating_plain():
        want = gm.grouped_matmul_plain(xs, w, sizes)
    err = (got.float() - want.float()).abs()
    limit = INT8_ABS[dtype] * want.float().abs().max().item()
    if dtype == torch.bfloat16:
        limit = INT8_REL_BF16 * want.float().abs() + limit
    worst = err.max().item()
    kind, step = GROUPED_VARIANT[dtype]
    check(launched == step and got.dtype == dtype and tuple(got.shape) == (rows, n)
          and bool(torch.isfinite(got.float()).all()),
          f"grouped_matmul {name}: one launch, of the {kind} kernel, {dtype} [{rows}, {n}], "
          "finite")
    check(bool((err <= limit).all()), f"grouped_matmul {name}: within tolerance (max|d| {worst:.3e})")
    check(torch.equal(got, again), f"grouped_matmul {name}: two launches equal bit for bit")
    return worst


def grouped_mm_library(xs, w, sizes):
    """torch._grouped_mm on the same inputs, where the card's torch has it
    (its yardstick role only; the port never calls it): a callable, or the
    reason there is none."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch has no _grouped_mm"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    w_cols = w.transpose(-2, -1).contiguous().transpose(-2, -1)  # column-major B
    errors = []
    for b in (w, w_cols):
        try:
            out = fn(xs, b, offs=offs, out_dtype=xs.dtype)
            torch.cuda.synchronize()
            if tuple(out.shape) == (xs.shape[0], w.shape[-1]):
                return (lambda b=b: fn(xs, b, offs=offs, out_dtype=xs.dtype)), None
            errors.append(f"shape {tuple(out.shape)}")
        except Exception as e:  # a yardstick that does not run is reported, not fatal
            errors.append(f"{type(e).__name__}: {str(e)[:160]}")
    return None, "; ".join(errors)


def time_grouped(dtype, k, n, routing="balanced", baseline=None) -> dict:
    """L2-cold times at one product of a prefill layer (two input sets of 96
    MB or more alternate): the kernel; the plain version (which reads the
    sizes on the host); a torch.matmul a group with the sizes known on the
    host beforehand (no read-back timed); torch._grouped_mm where it runs
    (`library_ms`); with a baseline wrapper, its kernel on the same inputs
    (`parent_ms`), kernel and parent in turns."""
    from jobset_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(k + n)
    sets = [grouped_operands(dtype, k, n, gen) for _ in range(2)]
    sizes = moe_group_sizes(routing)
    host_sizes = sizes.tolist()
    if dtype == torch.float32:
        plain_is_f32("grouped_matmul timing")
    out = torch.empty((MOE_SLOTS, n), dtype=dtype, device="cuda")

    def loop(i):
        xs, w = sets[i]
        start = 0
        for e, size in enumerate(host_sizes):
            if size:
                torch.matmul(xs[start:start + size], w[e], out=out[start:start + size])
            start += size

    times = {
        "ms": rotating_ms(lambda i: gm.grouped_matmul(*sets[i], sizes), 2, ITERS),
        "plain_ms": rotating_ms(lambda i: gm.grouped_matmul_plain(*sets[i], sizes), 2, ITERS // 4),
        "loop_ms": rotating_ms(loop, 2, ITERS),
    }
    if baseline is not None:
        parent = [rotating_ms(lambda i: baseline.grouped_matmul(*sets[i], sizes), 2, ITERS)]
        times["ms_runs"] = [times["ms"], rotating_ms(lambda i: gm.grouped_matmul(*sets[i], sizes),
                                                     2, ITERS)]
        parent.append(rotating_ms(lambda i: baseline.grouped_matmul(*sets[i], sizes), 2, ITERS))
        times["parent_ms_runs"] = parent
        times["parent_ms"] = min(parent)
        times["ms"] = min(times["ms_runs"])
    library, why = grouped_mm_library(*sets[0], sizes)
    if library is not None:
        lib_sets = [grouped_mm_library(*s, sizes)[0] for s in sets]
        times["library_ms"] = rotating_ms(lambda i: lib_sets[i](), 2, ITERS)
    else:
        times["library_ms"] = None
        times["library_missing"] = why
    times["bound_ms"], times["bound_by"] = grouped_bound_ms(MOE_SLOTS, k, n, dtype)
    if dtype == torch.float32:
        times["bound_fma_ms"] = grouped_fma_bound_ms(MOE_SLOTS, k, n)
    del sets, out
    torch.cuda.empty_cache()
    return times


def int8_experts_case(name, dtype, k, n, shared, seed) -> float:
    """The int8 kernel's expert launch against each expert's 2-D launch (bit
    for bit) and against its plain version (the int8 tolerance); one launch
    counted. Returns max|got - plain|."""
    from jobset_tpu_torch.models import quant
    from jobset_tpu_torch.ops import int8_matmul as i8

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qt = quant.quantize_int8(torch.randn((MOE_EXPERTS, k, n), generator=gen, device="cuda")
                             / k ** 0.5)
    x = torch.randn((1 if shared else MOE_EXPERTS, BATCH, k), generator=gen,
                    device="cuda").to(dtype)
    before = i8.INT8_LAUNCHES
    got = i8.int8_matmul_experts(x, qt, dtype)
    launched = i8.INT8_LAUNCHES - before
    apart = [i8.int8_matmul(x[0 if shared else e], quant.QuantizedTensor(qt.q[e], qt.scale[e]),
                            dtype) for e in range(MOE_EXPERTS)]
    torch.cuda.synchronize()
    with f32_accumulating_plain():
        want = i8.int8_matmul_experts_plain(x, qt, dtype)
    err = (got.float() - want.float()).abs()
    limit = INT8_ABS[dtype] * want.float().abs().max().item()
    if dtype == torch.bfloat16:
        limit = INT8_REL_BF16 * want.float().abs() + limit
    check(launched == 1 and tuple(got.shape) == (MOE_EXPERTS, BATCH, n),
          f"int8_matmul experts {name}: one launch, [{MOE_EXPERTS}, {BATCH}, {n}]")
    check(all(torch.equal(got[e], apart[e]) for e in range(MOE_EXPERTS)),
          f"int8_matmul experts {name}: each expert equals its 2-D launch bit for bit")
    check(bool((err <= limit).all()),
          f"int8_matmul experts {name}: within tolerance (max|d| {err.max().item():.3e})")
    return err.max().item()


def time_int8_experts(dtype, k, n, shared, rows=BATCH) -> dict:
    """L2-cold times of one expert-stack launch at a decode step's shape
    (x [E or 1, rows, k]; stacks of int8 alternate, four or more, 128 MB
    or more in all: four of 32 MB at the flagship): the kernel; eight 2-D
    launches; the plain version (dequantize, batched matmul); torch.matmul
    on the stack dequantized to dtype beforehand (`library_ms`, the product
    at twice the weight bytes); the bound (bytes)."""
    from jobset_tpu_torch.models import quant
    from jobset_tpu_torch.ops import int8_matmul as i8

    gen = torch.Generator(device="cuda").manual_seed(k * 3 + n)
    n_sets = max(4, -(-(128 << 20) // (MOE_EXPERTS * k * n)))
    sets = [quant.quantize_int8(torch.randn((MOE_EXPERTS, k, n), generator=gen, device="cuda")
                                / k ** 0.5) for _ in range(n_sets)]
    parts = [[quant.QuantizedTensor(qt.q[e], qt.scale[e]) for e in range(MOE_EXPERTS)]
             for qt in sets]
    dense = [quant.weight_cast(qt, dtype) for qt in sets]
    x = torch.randn((1 if shared else MOE_EXPERTS, rows, k), generator=gen,
                    device="cuda").to(dtype)
    if dtype == torch.float32:
        plain_is_f32("int8 expert timing")
    size = torch.tensor([], dtype=dtype).element_size()
    moved = MOE_EXPERTS * (k * n + 4 * n + size * rows * n) + size * x.numel()
    out = {
        "ms": rotating_ms(lambda i: i8.int8_matmul_experts(x, sets[i], dtype), n_sets, ITERS),
        "apart_ms": rotating_ms(lambda i: [i8.int8_matmul(x[0 if shared else e], parts[i][e], dtype)
                                           for e in range(MOE_EXPERTS)], n_sets, ITERS),
        "plain_ms": rotating_ms(lambda i: i8.int8_matmul_experts_plain(x, sets[i], dtype), n_sets,
                                ITERS),
        "library_ms": rotating_ms(lambda i: torch.matmul(x, dense[i]), n_sets, ITERS),
        "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
        "bound_by": "bytes",
    }
    del sets, parts, dense
    torch.cuda.empty_cache()
    return out


def moe_kernel_checks(results, baseline=None):
    """Phase 12a: the grouped kernel at the prefill's two products (four
    routings checked, three timed; bf16 and f32) and the int8 kernel's
    expert axis at the decode step's two stacks; their L2-cold times (and
    the baseline wrapper's grouped kernel beside them, given one)."""
    from jobset_tpu_torch.ops import grouped_matmul as gm

    card = results["card"]
    check(gm.kernel_layout() == gm.layout(),
          "grouped_matmul: the built kernel's constants equal the wrapper's")
    errs, seed = {}, 40
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, (k, n) in MOE_PRODUCTS.items():
            for routing in MOE_CHECK_ROUTINGS:
                errs[f"{tag} {label} {routing}"] = grouped_case(
                    f"{tag} {label} [{MOE_SLOTS},{k}]x[{MOE_EXPERTS},{k},{n}] {routing}", dtype,
                    k, n, routing, seed)
                seed += 1
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, (k, n) in MOE_PRODUCTS.items():
            routings = MOE_ROUTINGS if dtype == torch.bfloat16 else ("balanced",)
            for routing in routings:
                t = time_grouped(dtype, k, n, routing, baseline)
                times[f"{tag} {label} {routing}"] = t
                lib = (f"{t['library_ms']:.4f} ms" if t["library_ms"] is not None
                       else f"none ({t['library_missing']})")
                parent = (f", parent kernel {t['parent_ms']:.4f} ms (runs {t['parent_ms_runs']}, "
                          f"kernel runs {t['ms_runs']})" if baseline is not None else "")
                fma = (f", FMA-pipe bound {t['bound_fma_ms']:.4f} ms" if "bound_fma_ms" in t
                       else "")
                print(f"grouped_matmul {tag} {label} [{MOE_SLOTS},{k}]x[{MOE_EXPERTS},{k},{n}] "
                      f"{routing}, L2-cold: kernel {t['ms']:.4f} ms{parent}, plain "
                      f"{t['plain_ms']:.4f} ms, torch.matmul a group {t['loop_ms']:.4f} ms, "
                      f"library_ms (torch._grouped_mm) {lib}, bound {t['bound_ms']:.4f} ms "
                      f"({t['bound_by']}){fma}, {t['bound_ms'] / t['ms']:.1%} of bound ({card})",
                      flush=True)
    int8_errs, int8_times = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, (k, n), shared in (("we1", MOE_PRODUCTS["we1"], True),
                                      ("we2", MOE_PRODUCTS["we2"], False)):
            name = f"{tag} {label} x [{1 if shared else MOE_EXPERTS},{BATCH},{k}]"
            int8_errs[f"{tag} {label}"] = int8_experts_case(name, dtype, k, n, shared, seed)
            seed += 1
            t = time_int8_experts(dtype, k, n, shared)
            int8_times[f"{tag} {label}"] = t
            print(f"int8_matmul experts {name} x int8 [{MOE_EXPERTS},{k},{n}], L2-cold: kernel "
                  f"{t['ms']:.4f} ms, {MOE_EXPERTS} 2-D launches {t['apart_ms']:.4f} ms, plain "
                  f"{t['plain_ms']:.4f} ms, library_ms (torch.matmul, {tag} stack) "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes), "
                  f"{t['bound_ms'] / t['ms']:.1%} of bound ({card})", flush=True)
    results["grouped_matmul"] = {"max_abs_err": errs, "by_shape": times}
    results["int8_experts"] = {"max_abs_err": int8_errs, "by_shape": int8_times}


# The grouped product's counters: the forward's (all, TMA, f32) and the
# backward's (dgrad and wgrad, all and f32; f32 wgrad's TMA kernel).
GROUPED_COUNTERS = ("GROUPED_LAUNCHES", "GROUPED_TMA_LAUNCHES", "GROUPED_F32_LAUNCHES",
                    "GROUPED_DGRAD_LAUNCHES", "GROUPED_DGRAD_F32_LAUNCHES",
                    "GROUPED_WGRAD_LAUNCHES", "GROUPED_WGRAD_F32_LAUNCHES",
                    "GROUPED_WGRAD_TMA_LAUNCHES", "GROUPED_WGRAD_F32_TMA_LAUNCHES")


def moe_launches_now() -> dict:
    from jobset_tpu_torch.ops import grouped_matmul as gm
    from jobset_tpu_torch.ops import int8_matmul as i8

    return {**{name: getattr(gm, name) for name in GROUPED_COUNTERS},
            "INT8_LAUNCHES": i8.INT8_LAUNCHES, **launches_now()}


def reset_moe_launches():
    from jobset_tpu_torch.ops import grouped_matmul as gm
    from jobset_tpu_torch.ops import int8_matmul as i8

    reset_launches()
    for name in GROUPED_COUNTERS:
        setattr(gm, name, 0)
    i8.INT8_LAUNCHES = 0


def moe_layerwise(cfg, params, prompt, serving=False) -> list:
    """Each layer of the MoE path (the forward's `_layer`, or with serving
    the generate prefill's `_prefill_layer` on the cast parameters) run on
    the kernel path's input to it, and again with the grouped products
    plain: the outputs within the dense forward's tolerance, and the layer's
    routing identical by construction (the same attention kernel before
    it). Returns each layer's (max|d|, mean|d|)."""
    from jobset_tpu_torch.models import decode, transformer

    p = decode.cast_params(params, cfg.dtype) if serving else params
    cache = decode.init_kv_cache(cfg, BATCH, PROMPT, "cuda") if serving else None
    name = "MoE generate prefill" if serving else "MoE forward"

    def layer(i, x):
        lp = transformer.layer_params(p, i)
        if serving:
            return decode._prefill_layer(lp, x, cache["k"][i], cache["v"][i], cfg)
        return transformer._layer(lp, x, cfg)[0]

    out = []
    with torch.no_grad():
        x = transformer._embed_tokens(p["embed"], prompt, cfg)
        for i in range(cfg.n_layers):
            got = layer(i, x)
            with plain_grouped():
                want = layer(i, x)
            d = (got.float() - want.float()).abs()
            ref = want.float().abs()
            out.append((d.max().item(), d.mean().item()))
            check(d.max().item() <= LOGITS_MAX_REL * ref.max().item()
                  and d.mean().item() <= LOGITS_MEAN_REL * ref.mean().item(),
                  f"{name} layer {i}, kernel vs plain grouped products on the same input: "
                  f"max|d| {d.max().item():.4g} (ref max {ref.max().item():.4g}), mean|d| "
                  f"{d.mean().item():.4g} (ref mean {ref.mean().item():.4g})")
            x = got
    return out


def moe_no_sync(cfg, params, label):
    """One prefill layer (B=8, T=1024) and one decode step's layer of the
    MoE flagship under set_sync_debug_mode("error"): a host sync raises."""
    from jobset_tpu_torch.models import decode, transformer

    cast = decode.cast_params(params, cfg.dtype)
    layer = transformer.layer_params(cast, 0)
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((BATCH, PROMPT, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
    cache = decode.init_kv_cache(cfg, BATCH, PROMPT + 1, "cuda")
    ok, why = True, ""
    with torch.no_grad():
        decode._prefill_layer(layer, x, cache["k"][0], cache["v"][0], cfg)  # warm (masks)
        decode._decode_layer(layer, x[:, :1], cache["k"][0], cache["v"][0], PROMPT, cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode._prefill_layer(layer, x, cache["k"][0], cache["v"][0], cfg)
            decode._decode_layer(layer, x[:, :1], cache["k"][0], cache["v"][0], PROMPT, cfg)
        except RuntimeError as e:
            ok, why = False, str(e)[:300]
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(ok, f"MoE {label}: a prefill layer and a decode layer make no host sync "
              f"(set_sync_debug_mode error){' - ' + why if why else ''}")


def phase_moe(results, baseline=None):
    """Phase 12: mixture-of-experts serving and the dropless forward at the
    flagship's width and depth. `baseline`: another checkout, whose grouped
    kernel phase 12a times beside this one's."""
    from jobset_tpu_torch.models import (build_forward, build_generate, init_params,
                                         quantize_params_for_serving)
    from jobset_tpu_torch.runtime.model_bench import run_decode_bench

    card = results["card"]
    moe_kernel_checks(results, load_baseline(baseline, "grouped_matmul") if baseline else None)
    cfg = moe_config()
    cfg.validate()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    qparams = quantize_params_for_serving(params)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda",
                           dtype=torch.int32)

    # The dropless forward, B=8 T=1024: launches, twice the same bits, and
    # against its plain path (grouped products and attention plain).
    forward = build_forward(cfg)
    forward(params, prompt[:, :64])  # warm-up
    torch.cuda.synchronize()
    reset_moe_launches()
    logits, secs = wall_s(lambda: forward(params, prompt))
    counts = moe_launches_now()
    results["moe_forward_launches"] = counts
    check(counts["GROUPED_LAUNCHES"] == counts["GROUPED_TMA_LAUNCHES"] == MOE_GROUPED_LAUNCHES
          and counts["TENSOR_CORE_LAUNCHES"] == FORWARD_LAUNCHES,
          f"MoE forward: launches {counts} (expected {MOE_GROUPED_LAUNCHES} grouped, all on the "
          f"TMA/wgmma kernel, {FORWARD_LAUNCHES} flash)")
    again = forward(params, prompt)
    check(torch.equal(logits, again), "MoE forward: two runs give the same bits")
    del again
    check(bool(torch.isfinite(logits.float()).all())
          and tuple(logits.shape) == (BATCH, PROMPT, cfg.vocab_size),
          f"MoE forward: finite logits of shape {tuple(logits.shape)} ({secs:.4f} s wall)")
    with plain_grouped(), plain_attention():
        plain = forward(params, prompt)
    d = (logits.float() - plain.float()).abs()
    results["moe_forward"] = {
        "wall_s": secs, "end_to_end_mean_rel": d.mean().item() / plain.float().abs().mean().item(),
        "end_to_end_max_abs": d.max().item(),
        "end_to_end_argmax_agree": (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()}
    print(f"MoE forward end to end, kernel vs plain path (information: the paths route apart): "
          f"mean|d| {results['moe_forward']['end_to_end_mean_rel']:.3e} of mean|ref|, argmax "
          f"agrees at {results['moe_forward']['end_to_end_argmax_agree']:.4%} of positions",
          flush=True)
    del logits, plain, d
    torch.cuda.empty_cache()
    results["moe_forward"]["layers"] = moe_layerwise(cfg, params, prompt)

    # The main path: each serving variant's generate and TTFT call, counts
    # set to 0 just before and read just after.
    launches, walls = {}, {}
    for point, (quantized, quantized_kv) in SERVING_POINTS.items():
        p = qparams if quantized else params
        flags = dict(quantized=quantized, quantized_kv=quantized_kv)
        generate, first = build_generate(cfg, NEW_TOKENS, **flags), build_generate(cfg, 1, **flags)
        first(p, prompt)  # warm-up
        torch.cuda.synchronize()
        for call, fn, want_int8 in (("generate", generate, INT8_GENERATE_LAUNCHES),
                                    ("ttft", first, 1)):
            reset_moe_launches()
            tokens, secs = wall_s(lambda: fn(p, prompt))
            counts = moe_launches_now()
            launches[f"{point} {call}"], walls[f"{point} {call}"] = counts, secs
            want = want_int8 if quantized else 0
            check(counts["GROUPED_LAUNCHES"] == counts["GROUPED_TMA_LAUNCHES"]
                  == MOE_GROUPED_LAUNCHES
                  and counts["INT8_LAUNCHES"] == want
                  and counts["TENSOR_CORE_LAUNCHES"] == GENERATE_LAUNCHES,
                  f"MoE {point} {call}: launches {counts} (expected {MOE_GROUPED_LAUNCHES} "
                  f"grouped, all on the TMA/wgmma kernel, {want} int8, {GENERATE_LAUNCHES} flash) "
                  f"({secs:.4f} s wall)")
            new = NEW_TOKENS if call == "generate" else 1
            check(tuple(tokens.shape) == (BATCH, PROMPT + new)
                  and bool((tokens[:, :PROMPT] == prompt).all())
                  and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                  f"MoE {point} {call}: tokens shape {tuple(tokens.shape)}, prompt kept, "
                  "ids in vocab")
    results["moe_launches"], results["moe_walls"] = launches, walls

    # The serving prefill's layers against the plain path, a layer at a time.
    results["moe_prefill_layers"] = moe_layerwise(cfg, params, prompt, serving=True)

    for label, p in (("bf16", params), ("int8", qparams)):
        moe_no_sync(cfg, p, label)

    # Where a decode step's and a TTFT call's device time goes.
    traces = {}
    for point, (quantized, quantized_kv) in SERVING_POINTS.items():
        if point == "decode_int8_kv":
            continue
        p = qparams if quantized else params
        first = build_generate(cfg, 1, quantized=quantized, quantized_kv=quantized_kv)
        traces[f"{point} ttft"] = traced(lambda: first(p, prompt),
                                         f"MoE {point} first_token (B={BATCH}, prompt {PROMPT})",
                                         "grouped_mm")
        traces[f"{point} step"] = serving_decode_step_trace(
            cfg, p, f"MoE {point} decode step (B={BATCH}, cache {PROMPT + 2})", quantized_kv)
    results["moe_traces"] = traces
    del params, qparams
    torch.cuda.empty_cache()

    bench = {}
    for point, (quantized, quantized_kv) in SERVING_POINTS.items():
        runs = [run_decode_bench(batch=BATCH, prompt_len=PROMPT, max_new_tokens=NEW_TOKENS,
                                 config=moe_config(max_seq_len=PROMPT + NEW_TOKENS),
                                 quantized=quantized, quantized_kv=quantized_kv,
                                 measure_ttft=True) for _ in range(2)]
        tps = sorted(r["decode_tokens_per_sec"] for r in runs)
        ttft = sorted(r["ttft_ms"] for r in runs)
        bench[point] = {**runs[0], "decode_tokens_per_sec_runs": tps, "ttft_ms_runs": ttft}
        print(f"run_decode_bench MoE {point} B={BATCH} prompt {PROMPT} new {NEW_TOKENS}, 2 runs: "
              f"{tps[0]:.1f}-{tps[-1]:.1f} new tokens/s, TTFT {ttft[0]:.3f}-{ttft[-1]:.3f} ms "
              f"({card})", flush=True)
    results["moe_decode_bench"] = bench

    # A small f32 MoE config: the card's tokens equal the CPU's, plain and
    # with int8 weights, the int8 cache and both.
    small = moe_config(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                       d_ff_expert=96, dtype=torch.float32)
    small_params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    small_q = quantize_params_for_serving(small_params)
    small_prompt = torch.randint(0, 128, (2, 40), generator=torch.Generator().manual_seed(1))
    small_launches = {}
    for label, quantized, quantized_kv in (("f32", False, False), ("int8 weights", True, False),
                                           ("int8 KV cache", False, True),
                                           ("int8 weights and KV cache", True, True)):
        p = small_q if quantized else small_params
        flags = dict(quantized=quantized, quantized_kv=quantized_kv)
        want = build_generate(small, 6, "cpu", **flags)(p, small_prompt)
        generate, p_card = build_generate(small, 6, **flags), to_device(p, "cuda")
        reset_moe_launches()
        got = generate(p_card, small_prompt)
        counts = moe_launches_now()
        small_launches[label] = counts["GROUPED_F32_LAUNCHES"]
        check(torch.equal(got.cpu(), want)
              and small_launches[label] == counts["GROUPED_LAUNCHES"] == 2 * small.n_layers,
              f"MoE generate small f32 config, {label}: card tokens equal the CPU path's; "
              f"{small_launches[label]} f32 grouped launches (expected {2 * small.n_layers})")

    g = results["grouped_matmul"]
    pair = [g["by_shape"][f"bf16 {label} balanced"] for label in MOE_PRODUCTS]
    f32_pair = [g["by_shape"][f"f32 {label} balanced"] for label in MOE_PRODUCTS]

    def total(rows, key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    def entry(tag, rows):
        return {
            "ms": total(rows, "ms"),
            "parent_ms": total(rows, "parent_ms") if baseline else None,
            "plain_ms": total(rows, "plain_ms"),
            "bound_ms": total(rows, "bound_ms"),
            "bound_by": "operations",
            **({"bound_fma_ms": total(rows, "bound_fma_ms")} if tag == "f32" else {}),
            "library_ms": total(rows, "library_ms"),
            "library_call": f"torch._grouped_mm ({tag}), where the card's torch has it",
            "loop_ms": total(rows, "loop_ms"),
            "shape": f"{tag}, a prefill layer's two products: [{MOE_SLOTS},1024] x "
                     f"[{MOE_EXPERTS},1024,{MOE_D_FF}] and [{MOE_SLOTS},{MOE_D_FF}] x "
                     f"[{MOE_EXPERTS},{MOE_D_FF},1024], balanced routing; L2-cold",
            "max_abs_err": max(g["max_abs_err"][f"{tag} {label} balanced"]
                               for label in MOE_PRODUCTS),
            "max_abs_err_by_case": {k: v for k, v in g["max_abs_err"].items()
                                    if k.startswith(tag)},
            "by_shape": {k: v for k, v in g["by_shape"].items() if k.startswith(tag)},
        }

    replaces = {"replaces": "jobset_tpu/models/transformer.py:670",
                "replaces_is": "lax.ragged_dot in sorted_ragged_expert_ffn (:670 and :675), an "
                               "XLA program (no Pallas kernel)"}
    return [
        {
            "name": "grouped_matmul",
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/grouped_matmul.cu",
            **replaces,
            "variant": "bf16: wgmma fed by TMA from a producer warp, persistent over the row "
                       "slots, output staged in shared memory and copied a row at a time by the "
                       "bulk-copy engine (grouped_mm_tma_kernel); operands TMA cannot take go to "
                       "mma.sync (grouped_mm_bf16_kernel); the f32 variant is its own entry",
            "launches": launches["decode generate"]["GROUPED_LAUNCHES"],
            "tma_launches": launches["decode generate"]["GROUPED_TMA_LAUNCHES"],
            "launches_by_path": {"forward": results["moe_forward_launches"]["GROUPED_LAUNCHES"],
                                 **{k: v["GROUPED_LAUNCHES"] for k, v in launches.items()}},
            **entry("bf16", pair),
        },
        {
            "name": "grouped_matmul_f32",
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/grouped_matmul.cu",
            **replaces,
            "variant": "f32 variant (grouped_mm_f32_kernel): 3xTF32 on mma.sync.m16n8k8 from a "
                       "4-stage cp.async ring, operands split into TF32 big and small parts where "
                       "a warp reads them, each K step's sums added to the output in f32; the "
                       "small f32 MoE config's paths; launches counted on its f32 generate",
            "launches": small_launches["f32"],
            "launches_by_path": {f"small f32 config generate, {k}": v
                                 for k, v in small_launches.items()},
            **entry("f32", f32_pair),
        },
    ]


# The kernels behind each grouped entry of the `kernels` line (dgrad runs
# the forward's kernels on the transposed weights).
GROUPED_ENTRY_KERNELS = {
    "grouped_matmul": ("grouped_mm_tma_kernel", "grouped_mm_bf16_kernel"),
    "grouped_matmul_f32": ("grouped_mm_f32_kernel",),
    "grouped_matmul_dgrad": ("grouped_mm_tma_kernel", "grouped_mm_bf16_kernel"),
    "grouped_matmul_dgrad_f32": ("grouped_mm_f32_kernel",),
    "grouped_matmul_wgrad": ("grouped_wgrad_tma_kernel", "grouped_wgrad_bf16_kernel"),
    "grouped_matmul_wgrad_f32": ("grouped_wgrad_f32_tma_kernel", "grouped_wgrad_f32_kernel"),
}


def attach_grouped_ptxas(entries, ptxas, sass=None) -> None:
    """Each grouped entry gets its kernels' ptxas reports from a build log
    this process parsed (none when the kernel was built elsewhere) and
    their SASS counts."""
    for entry in entries:
        kernels = GROUPED_ENTRY_KERNELS[entry["name"]]
        if ptxas:
            entry["ptxas"] = {k: v for k, v in ptxas.items() if any(s in k for s in kernels)}
        if sass:
            entry["sass"] = {k: v for k, v in sass.items() if any(s in k for s in kernels)}


def phase_moe_apart(results, baseline=None):
    """Phase 12 in a process of its own (`--moe-only`). Returns its
    `kernels` entries (none if it failed)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe.json")
        extra = ["--grouped-baseline", baseline] if baseline else []
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--moe-only",
                              "--out", path, *extra], capture_output=True, text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 12 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            moe = json.load(f)
    for key in ("grouped_matmul", "int8_experts", "moe_forward", "moe_forward_launches",
                "moe_launches", "moe_walls", "moe_traces", "moe_decode_bench", "moe_prefill_layers",
                "grouped_sass"):
        results[key] = moe.get(key)
    return moe.get("moe_kernels") or []


# ---------------------------------------------------------------------------
# Phase 13: mixture-of-experts training
# ---------------------------------------------------------------------------

# A MoE flagship train step's grouped launches: (forward, dgrad, wgrad).
# Two products a layer, each differentiated once; under "full" and "dots"
# the forward's run again in the backward (the reference's checkpoint_dots
# saves no ragged_dot_general either). The flash launches are phase 7's.
MOE_TRAIN_LAUNCHES = {"off": (2 * LAYERS, 2 * LAYERS, 2 * LAYERS),
                      "full": (4 * LAYERS, 2 * LAYERS, 2 * LAYERS),
                      "dots": (4 * LAYERS, 2 * LAYERS, 2 * LAYERS)}
MOE_TRAIN_FLASH = {"off": LAYERS, "full": 2 * LAYERS, "dots": LAYERS}
BACKWARD_OPS = ("dgrad", "wgrad")


def train_counts(counts, f32) -> tuple:
    """(forward, dgrad, wgrad) launches from the counters, each of which
    must have gone to the variant of the dtype."""
    if f32:
        return (counts["GROUPED_F32_LAUNCHES"], counts["GROUPED_DGRAD_F32_LAUNCHES"],
                counts["GROUPED_WGRAD_F32_LAUNCHES"])
    return (counts["GROUPED_TMA_LAUNCHES"],
            counts["GROUPED_DGRAD_LAUNCHES"] - counts["GROUPED_DGRAD_F32_LAUNCHES"],
            counts["GROUPED_WGRAD_LAUNCHES"] - counts["GROUPED_WGRAD_F32_LAUNCHES"])


def check_train_launches(path, counts, want, flash, f32, backward):
    """Every grouped launch of `path` on the dtype's kernels, in the counts
    `want` (forward, dgrad, wgrad), wgrad's all on the dtype's TMA kernel,
    `flash` block launches and `backward` launches of the block's backward
    kernel, on the dtype's variant."""
    total = (counts["GROUPED_LAUNCHES"], counts["GROUPED_DGRAD_LAUNCHES"],
             counts["GROUPED_WGRAD_LAUNCHES"])
    block = counts["F32_LAUNCHES" if f32 else "TENSOR_CORE_LAUNCHES"]
    wgrad_tma = counts["GROUPED_WGRAD_F32_TMA_LAUNCHES" if f32 else "GROUPED_WGRAD_TMA_LAUNCHES"]
    check(train_counts(counts, f32) == total == tuple(want) and block == flash
          and counts["KERNEL_LAUNCHES"] == flash and wgrad_tma == want[2]
          and counts["BACKWARD_LAUNCHES"] == backward
          and counts["BACKWARD_F32_LAUNCHES"] == (backward if f32 else 0)
          and counts["BACKWARD_F32_MMA_LAUNCHES"] == 0,
          f"{path}: grouped (forward, dgrad, wgrad) launches {total}, on the "
          f"{'f32' if f32 else 'bf16'} kernels {train_counts(counts, f32)} (expected {tuple(want)}); "
          f"{wgrad_tma} on the {'f32' if f32 else 'bf16'} wgrad TMA kernel; {block} flash block "
          f"launches (expected {flash}); {counts['BACKWARD_LAUNCHES']} flash backward launches, "
          f"{counts['BACKWARD_F32_LAUNCHES']} of them f32 (expected {backward}), by variant "
          f"{f32_backward_by_variant(counts)} (all on tf32 wgmma fed by TMA)")


def backward_operands(dtype, k, n, gen, rows=MOE_SLOTS):
    """A prefill-sized product's operands and its output's gradient."""
    xs, w = grouped_operands(dtype, k, n, gen, rows)
    return xs, w, torch.randn((rows, n), generator=gen, device="cuda").to(dtype)


def backward_case(which, name, dtype, k, n, routing, seed, baseline=None, rows=MOE_SLOTS):
    """dgrad or wgrad against its plain version at one product of the MoE
    flagship: the grouped kernels' tolerance, one launch counted on the
    dtype's variant (f32 wgrad's on its TMA kernel), two launches equal bit
    for bit, and wgrad's empty experts exactly 0; with a baseline wrapper,
    equal bit for bit to its kernel on the same inputs, but for f32 wgrad,
    whose TMA kernel adds in another order than the parent's: there the
    parent's output, too, within the tolerance of the plain version, both
    max|d| printed. `rows`: a gang rank's product instead. Returns
    max|got - want|."""
    from jobset_tpu_torch.ops import grouped_matmul as gm

    xs, w, dy = backward_operands(dtype, k, n, torch.Generator(device="cuda").manual_seed(seed),
                                  rows)
    sizes = moe_group_sizes(routing, rows)
    if which == "dgrad":
        fn, plain, args, shape = (gm.grouped_matmul_dgrad, gm.grouped_matmul_dgrad_plain,
                                  (dy, w, sizes), (rows, k))
    else:
        fn, plain, args, shape = (gm.grouped_matmul_wgrad, gm.grouped_matmul_wgrad_plain,
                                  (xs, dy, sizes), (MOE_EXPERTS, k, n))
    before = moe_launches_now()
    got = fn(*args)
    launched = {key: v - before[key] for key, v in moe_launches_now().items() if v != before[key]}
    again = fn(*args)
    torch.cuda.synchronize()
    with f32_accumulating_plain():
        want = plain(*args)
    err = (got.float() - want.float()).abs()
    limit = INT8_ABS[dtype] * want.float().abs().max().item()
    if dtype == torch.bfloat16:
        limit = INT8_REL_BF16 * want.float().abs() + limit
    worst = err.max().item()
    counter = f"GROUPED_{which.upper()}_LAUNCHES"
    expect = {counter: 1}
    if dtype == torch.float32:
        expect[counter.replace("_LAUNCHES", "_F32_LAUNCHES")] = 1
    if which == "wgrad":
        expect["GROUPED_WGRAD_F32_TMA_LAUNCHES" if dtype == torch.float32
               else "GROUPED_WGRAD_TMA_LAUNCHES"] = 1
    check(launched == expect and got.dtype == dtype and tuple(got.shape) == shape
          and bool(torch.isfinite(got.float()).all()),
          f"grouped_matmul_{which} {name}: launches {launched} (expected {expect}), {dtype} "
          f"{list(shape)}, finite")
    check(bool((err <= limit).all()), f"grouped_matmul_{which} {name}: within tolerance "
                                      f"(max|d| {worst:.3e})")
    check(torch.equal(got, again), f"grouped_matmul_{which} {name}: two launches equal bit for bit")
    if which == "dgrad" and dtype == torch.bfloat16:
        # The TMA kernel reading w K-major against the forward's launch on a
        # transposed copy of w: the same products in the same order.
        check(torch.equal(got, gm.grouped_matmul(dy, w.transpose(1, 2).contiguous(), sizes)),
              f"grouped_matmul_dgrad {name}: w read K-major equals the forward kernel on w "
              "transposed, bit for bit")
    if which == "wgrad":
        empty = [e for e, size in enumerate(sizes.tolist()) if size == 0]
        check(all(bool((got[e] == 0).all()) for e in empty),
              f"grouped_matmul_wgrad {name}: the empty experts' {empty} gradients are exactly 0")
    if baseline is not None:
        parent = getattr(baseline, f"grouped_matmul_{which}")(*args)
        apart = (got.float() - parent.float()).abs().max().item()
        if which == "wgrad" and dtype == torch.float32:
            parent_worst = (parent.float() - want.float()).abs().max().item()
            check(bool(((parent.float() - want.float()).abs() <= limit).all()),
                  f"grouped_matmul_wgrad {name}: the parent's kernel within tolerance too (max|d| "
                  f"{parent_worst:.3e}, this kernel {worst:.3e}, limit {limit:.3e}; the two "
                  f"{apart:.3e} apart: another order of sums)")
        else:
            check(torch.equal(got, parent),
                  f"grouped_matmul_{which} {name}: equal bit for bit to the parent's kernel on "
                  f"the same inputs (max|d| {apart:.3e})")
    return worst


def wgrad_mm_library(xs, dy, sizes):
    """torch._grouped_mm's ragged-K form (2-D x 2-D, offsets on the
    contraction) for xs^T dy, where the card's torch runs it (a yardstick
    only): a callable, or the reason there is none."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch has no _grouped_mm"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    errors = []
    for a in (xs.T, xs.T.contiguous()):
        for b in (dy, dy.T.contiguous().T):
            try:
                out = fn(a, b, offs=offs, out_dtype=xs.dtype)
                torch.cuda.synchronize()
                if tuple(out.shape) == (MOE_EXPERTS, xs.shape[1], dy.shape[1]):
                    return (lambda a=a, b=b: fn(a, b, offs=offs, out_dtype=xs.dtype)), None
                errors.append(f"shape {tuple(out.shape)}")
            except Exception as e:  # a yardstick that does not run is reported, not fatal
                errors.append(f"{type(e).__name__}: {str(e)[:120]}")
    return None, "; ".join(errors)


def time_backward(dtype, k, n, routing="balanced", baseline=None) -> dict:
    """L2-cold times of dgrad and wgrad at one product of the MoE flagship
    (two input sets of 224 MB or more alternate): the wrapper's kernels
    (dgrad: bf16 reads w K-major; f32 copies w to [E, N, K] first), the
    copy of w alone (the f32 dgrad's, and what bf16 saves), the plain
    versions, torch._grouped_mm where it runs (`library_ms`) and the bound
    (every routed row once: 2 M K N operations; each operand read and the
    result written once); with a baseline wrapper, its kernels on the same
    inputs (`parent_ms`), kernel and parent each twice in turns, the
    faster of each kept."""
    from jobset_tpu_torch.ops import grouped_matmul as gm

    gen = torch.Generator(device="cuda").manual_seed(2 * k + n)
    sets = [backward_operands(dtype, k, n, gen) for _ in range(2)]
    sizes = moe_group_sizes(routing)
    if dtype == torch.float32:
        plain_is_f32("grouped backward timing")
    out = {
        "dgrad": {
            "ms": rotating_ms(lambda i: gm.grouped_matmul_dgrad(sets[i][2], sets[i][1], sizes), 2,
                              ITERS),
            "copy_ms": rotating_ms(lambda i: sets[i][1].transpose(1, 2).contiguous(), 2, ITERS),
            "plain_ms": rotating_ms(
                lambda i: gm.grouped_matmul_dgrad_plain(sets[i][2], sets[i][1], sizes), 2,
                ITERS // 4),
        },
        "wgrad": {
            "ms": rotating_ms(lambda i: gm.grouped_matmul_wgrad(sets[i][0], sets[i][2], sizes), 2,
                              ITERS),
            "plain_ms": rotating_ms(
                lambda i: gm.grouped_matmul_wgrad_plain(sets[i][0], sets[i][2], sizes), 2,
                ITERS // 4),
        },
    }
    if baseline is not None:
        calls = {"dgrad": lambda mod, i: mod.grouped_matmul_dgrad(sets[i][2], sets[i][1], sizes),
                 "wgrad": lambda mod, i: mod.grouped_matmul_wgrad(sets[i][0], sets[i][2], sizes)}
        for which, call in calls.items():
            mine, parent = [out[which]["ms"]], []
            for runs, mod in ((parent, baseline), (mine, gm), (parent, baseline)):
                runs.append(rotating_ms(lambda i: call(mod, i), 2, ITERS))
            out[which].update(ms=min(mine), ms_runs=mine, parent_ms=min(parent),
                              parent_ms_runs=parent)
    libraries = {"dgrad": [grouped_mm_library(dy, w.transpose(1, 2), sizes) for _, w, dy in sets],
                 "wgrad": [wgrad_mm_library(xs, dy, sizes) for xs, _, dy in sets]}
    bound, bound_by = grouped_bound_ms(MOE_SLOTS, k, n, dtype)
    for which in BACKWARD_OPS:
        calls = libraries[which]
        if all(fn is not None for fn, _ in calls):
            out[which]["library_ms"] = rotating_ms(lambda i: calls[i][0](), 2, ITERS)
        else:
            out[which]["library_ms"] = None
            out[which]["library_missing"] = calls[0][1] or calls[1][1]
        out[which]["bound_ms"], out[which]["bound_by"] = bound, bound_by
        if dtype == torch.float32:
            out[which]["bound_fma_ms"] = grouped_fma_bound_ms(MOE_SLOTS, k, n)
    del sets, libraries
    torch.cuda.empty_cache()
    return out


def wgrad_busiest_tiles(sizes, k, n) -> int:
    """The most tiles with rows to walk that one block of the bf16 wgrad
    kernel's persistent grid takes (one block an SM, each taking tiles b,
    b + grid, ... of (expert, K tile, N tile), N tiles fastest): a tile
    change for each but its first."""
    k_tiles, n_tiles = -(-k // 128), -(-n // 256)
    tiles = len(sizes) * k_tiles * n_tiles
    grid = min(tiles, torch.cuda.get_device_properties(0).multi_processor_count)
    return max(sum(1 for t in range(b, tiles, grid) if sizes[t // (k_tiles * n_tiles)] > 0)
               for b in range(grid))


def moe_backward_checks(results, baseline=None):
    """Phase 13a: dgrad and wgrad at the MoE flagship's two products, four
    routings, bf16 and f32, against their plain versions (and, given a
    baseline wrapper, against its kernels bit for bit, f32 wgrad within
    tolerance); their L2-cold times (balanced and skewed; the baseline's
    beside them), and the bf16 wgrad kernel's cost a tile change: balanced
    against skewed time, over the busiest block's extra tiles."""
    card = results["card"]
    errs, seed = {}, 70
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, (k, n) in MOE_PRODUCTS.items():
            for routing in MOE_CHECK_ROUTINGS:
                for which in BACKWARD_OPS:
                    errs[f"{which} {tag} {label} {routing}"] = backward_case(
                        which, f"{tag} {label} [{MOE_SLOTS},{k}]x[{MOE_EXPERTS},{k},{n}] {routing}",
                        dtype, k, n, routing, seed, baseline)
                    seed += 1
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, (k, n) in MOE_PRODUCTS.items():
            for routing in ("balanced", "skewed"):
                t = time_backward(dtype, k, n, routing, baseline)
                times[f"{tag} {label} {routing}"] = t
                for which in BACKWARD_OPS:
                    r = t[which]
                    lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
                           else f"none ({r['library_missing']})")
                    copy = ("" if "copy_ms" not in r else
                            f" (of which the copy of w {r['copy_ms']:.4f} ms)" if tag == "f32" else
                            f" (w read K-major; a copy of w would take {r['copy_ms']:.4f} ms)")
                    parent = (f" (runs {r['ms_runs']}), parent kernel {r['parent_ms']:.4f} ms "
                              f"(runs {r['parent_ms_runs']})" if "parent_ms" in r else "")
                    print(f"grouped_matmul_{which} {tag} {label} [{MOE_SLOTS},{k}]x"
                          f"[{MOE_EXPERTS},{k},{n}] {routing}, L2-cold: kernel {r['ms']:.4f} ms"
                          f"{copy}{parent}, plain {r['plain_ms']:.4f} ms, library_ms "
                          f"(torch._grouped_mm) {lib}, bound {r['bound_ms']:.4f} ms "
                          f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of bound ({card})",
                          flush=True)
    tile_change = {}
    for label, (k, n) in MOE_PRODUCTS.items():
        busiest = {routing: wgrad_busiest_tiles(moe_group_sizes(routing).tolist(), k, n)
                   for routing in ("balanced", "skewed")}
        extra = busiest["balanced"] - busiest["skewed"]
        row = {"busiest_block_tiles": busiest}
        for key in ("ms", "parent_ms"):
            bal, skew = (times[f"bf16 {label} {r}"]["wgrad"].get(key) for r in ("balanced", "skewed"))
            if bal is not None and extra > 0:
                row[f"{key[:-3] or 'kernel'}_us"] = 1e3 * (bal - skew) / extra
        tile_change[label] = row
        print(f"grouped_matmul_wgrad bf16 {label}: per tile change "
              + ", ".join(f"{key[:-3]} {v:.3f} us" for key, v in row.items() if key.endswith("_us"))
              + f" ((balanced - skewed) / ({busiest['balanced']} - {busiest['skewed']}) tiles of "
              f"the busiest block; {card})", flush=True)
    results["grouped_backward"] = {"max_abs_err": errs, "by_shape": times,
                                   "wgrad_tile_change": tile_change}


def moe_train_layerwise(cfg, params, batch) -> list:
    """Each layer of the bf16 MoE flagship, forward and backward, on the
    kernel path's input to it, with the grouped products through the
    kernels and again plain (the same routing: the router sees the same
    input): its output within the dense forward's tolerance, and the
    gradients of its input and of each of its parameters (through a random
    cotangent on the output and on the gate-probability sums, as the aux
    loss gives them) within TRAIN_GRAD_REL in relative norm. Returns each
    layer's worst relative gradient."""
    from jobset_tpu_torch.models import transformer

    gen = torch.Generator(device="cuda").manual_seed(11)
    with torch.no_grad():
        x = transformer._embed_tokens(params["embed"], batch["inputs"], cfg)
    worst = []
    for i in range(cfg.n_layers):
        lp = {name: t.detach().requires_grad_() for name, t in
              transformer.layer_params(params, i).items()}
        cot = torch.randn(x.shape, generator=gen, device="cuda").to(cfg.dtype)
        cot_stats = torch.randn((cfg.n_experts,), generator=gen, device="cuda")

        def run():
            xi = x.detach().requires_grad_()
            out, stats = transformer._layer(lp, xi, cfg)
            grads = torch.autograd.grad((out, stats[1]), [xi, *lp.values()], (cot, cot_stats))
            return out.detach(), grads

        got, got_grads = run()
        with plain_grouped():
            want, want_grads = run()
        d, ref = (got.float() - want.float()).abs(), want.float().abs()
        rels = [((g.float() - w.float()).norm() / w.float().norm()).item()
                for g, w in zip(got_grads, want_grads)]
        worst.append(max(rels))
        check(d.max().item() <= LOGITS_MAX_REL * ref.max().item()
              and d.mean().item() <= LOGITS_MEAN_REL * ref.mean().item()
              and max(rels) <= TRAIN_GRAD_REL,
              f"MoE train layer {i} bf16, kernels vs plain grouped products on the same input: "
              f"output max|d| {d.max().item():.4g} (ref max {ref.max().item():.4g}); input and "
              f"{len(lp)} parameter gradients within {TRAIN_GRAD_REL} in relative norm (worst "
              f"{max(rels):.3e})")
        x = got
        del got_grads, want_grads, want
    return worst


def moe_train_no_sync(cfg, params):
    """One MoE flagship layer's forward and backward (bf16, B=8, T=1024)
    under set_sync_debug_mode("error"): a host sync raises."""
    from jobset_tpu_torch.models import transformer

    lp = {name: t.detach().requires_grad_() for name, t in
          transformer.layer_params(params, 0).items()}
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((BATCH, PROMPT, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)

    def run():
        xi = x.detach().requires_grad_()
        out, stats = transformer._layer(lp, xi, cfg)
        torch.autograd.grad((out.float().sum(), stats[1].sum()), [xi, *lp.values()])

    run()  # warm (masks)
    torch.cuda.synchronize()
    ok, why = True, ""
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    except RuntimeError as e:
        ok, why = False, str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(ok, "MoE train: a layer's forward and backward make no host sync "
              f"(set_sync_debug_mode error){' - ' + why if why else ''}")


def moe_train_trace(fn, label, f32=False):
    """`traced` over one train step (remat off), with the grouped kernels'
    device time: the forward kernel's first 2 x LAYERS launches (the TMA
    kernel's; with f32 the f32 kernel's) are the forward's (every one
    precedes the backward), the rest dgrad's; and the top 10 ops' names in
    full."""
    trace = traced(fn, label, keep_events=True)
    if trace is None:
        return None
    events = trace.pop("events")
    kernel = "grouped_mm_f32_kernel" if f32 else "grouped_mm_tma_kernel"
    forward = sorted((e for e in events if kernel in e[0]), key=lambda e: e[1])
    parts = {"forward": forward[:2 * LAYERS], "dgrad": forward[2 * LAYERS:],
             "wgrad": [e for e in events if "grouped_wgrad_" in e[0]],
             "flash backward": [e for e in events if "flash_bwd" in e[0]]}
    names = {e[0] for e in events}
    for top in trace["top10"]:
        top["name"] = next((n for n in names if n.startswith(top["name"])), top["name"])[:400]
        print(f"  top op {top['ms']:.3f} ms {top['count']}x: {top['name']}", flush=True)
    for part, mine in parts.items():
        ms = sum(end - start for _, start, end in mine) / 1e3
        trace[f"{part}_ms"], trace[f"{part}_ops"] = ms, len(mine)
        trace[f"{part}_share"] = ms / trace["device_busy_ms"]
        print(f"  {'' if part.startswith('flash') else 'grouped '}{part}: {ms:.3f} ms in "
              f"{len(mine)} launches, {ms / trace['device_busy_ms']:.1%} of device busy",
              flush=True)
    return trace


def phase_moe_train(results, baseline=None):
    """Phase 13: mixture-of-experts training at the MoE flagship's width and
    depth. `baseline`: another checkout, whose backward kernels are held to
    this one's bit for bit and timed beside them. Returns its `kernels`
    entries."""
    from dataclasses import replace

    from jobset_tpu_torch.models import build_train_step, init_params
    from jobset_tpu_torch.runtime import model_bench, optim

    card = results["card"]
    moe_backward_checks(results, load_baseline(baseline, "grouped_matmul") if baseline else None)

    # The main path: run_model_bench on the MoE flagship (B=8, T=1024,
    # remat off, adam), counts set to 0 just before and read just after.
    cfg = moe_config()
    empty_mask_cache()
    reset_moe_launches()
    bench = model_bench.run_model_bench(steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, batch=BATCH,
                                        seq_len=PROMPT, config=cfg)
    steps = TRAIN_WARMUP + TRAIN_STEPS
    counts = moe_launches_now()
    results["moe_train_bench_launches"] = counts
    check_train_launches(f"MoE run_model_bench ({steps} steps)", counts,
                         [steps * c for c in MOE_TRAIN_LAUNCHES["off"]], steps * LAYERS, False,
                         steps * LAYERS)
    losses = bench.pop("losses")
    check(all(l == l and abs(l) < float("inf") for l in losses) and losses[-1] < losses[0],
          f"MoE run_model_bench: every loss finite, last {losses[-1]:.4f} < first {losses[0]:.4f}")
    results["moe_model_bench"], results["moe_model_bench_losses"] = bench, losses
    lo, hi = bench["step_time_ms_range"]
    print(f"MoE train step flagship B={BATCH} T={PROMPT} (remat off, adam): median of "
          f"{TRAIN_STEPS} {bench['step_time_ms_median']:.3f} ms ({lo:.3f}-{hi:.3f}), "
          f"{bench['tokens_per_sec']:.1f} tokens/s, {bench['achieved_tflops']:.2f} TFLOP/s at "
          f"activated FLOPs, MFU {bench['mfu_pct']}% of {bench['peak_tflops']} TFLOP/s, peak "
          f"memory {bench['peak_memory_gb']:.2f} GB (information; {card})", flush=True)
    torch.cuda.empty_cache()

    # The step in f32 at full width and depth, through the kernels against
    # the same step on the plain grouped products (the attention kernel in
    # both), and remat "full" and "dots" against none.
    cfg32 = moe_config(dtype=torch.float32)
    params = init_params(cfg32, torch.Generator(device="cuda").manual_seed(0))
    batch = token_batch(cfg32.vocab_size, BATCH, PROMPT, seed=3)
    stepped, launches = {}, {}
    for policy in ("off", "full", "dots"):
        c = replace(cfg32, remat=policy != "off", remat_policy="full" if policy == "off" else policy)
        reset_moe_launches()
        stepped[policy] = sgd_step(c, params, batch)
        launches[policy] = moe_launches_now()
        check_train_launches(f"MoE train step f32, remat {policy}", launches[policy],
                             MOE_TRAIN_LAUNCHES[policy], MOE_TRAIN_FLASH[policy], True,
                             LAYERS)
    results["moe_train_step_launches"] = launches
    with plain_grouped():
        plain = sgd_step(cfg32, params, batch)
    results["moe_train_grad_rel_vs_plain"] = compare_step(
        "MoE train step f32 flagship, kernels vs plain grouped products", stepped["off"], plain,
        F32_LOSS_REL, F32_GRAD_REL)
    del plain
    for policy in ("full", "dots"):
        compare_step(f"MoE train step f32 flagship, remat {policy!r} vs off", stepped[policy],
                     stepped["off"], F32_LOSS_REL, F32_GRAD_REL)
    del stepped
    torch.cuda.empty_cache()

    # The trace of one warm f32 step (remat off, sgd): its 16 wgrad
    # launches' device time and share of busy (information).
    sgd = optim.sgd(1.0)
    step32, state32 = build_train_step(cfg32, sgd), sgd.init(params)
    step32(params, state32, batch)  # warm-up
    results["moe_train_f32_trace"] = moe_train_trace(
        lambda: step32(params, state32, batch),
        f"MoE train step f32 (B={BATCH}, T={PROMPT}, remat off, sgd)", f32=True)
    del step32, state32, params
    torch.cuda.empty_cache()

    # bf16 a layer at a time on the same routing, and no host sync.
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    results["moe_train_layers"] = moe_train_layerwise(cfg, params, batch)
    moe_train_no_sync(cfg, params)

    # The trace of one warm bf16 step (remat off, adam).
    opt = optim.adam(1e-3)
    state = opt.init(params)
    step = build_train_step(cfg, opt)
    params, state, _ = step(params, state, batch)  # warm-up
    holder = {}

    def one_step():
        holder["out"] = step(params, state, batch)

    results["moe_train_trace"] = moe_train_trace(
        one_step, f"MoE train step (B={BATCH}, T={PROMPT}, remat off, adam)")
    del params, state, holder, step
    torch.cuda.empty_cache()

    # A small f32 MoE config: the card's step against the CPU's (its launches
    # count the f32 backward kernels' entries).
    small = moe_config(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                       d_ff_expert=96, dtype=torch.float32)
    small_params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    small_batch = token_batch(128, 4, 64, seed=5, device="cpu")
    reset_moe_launches()
    card_step = sgd_step(small, to_device(small_params, "cuda"),
                         {k: t.cuda() for k, t in small_batch.items()})
    small_counts = moe_launches_now()
    check_train_launches("MoE train step small f32 config", small_counts,
                         [c // LAYERS * small.n_layers for c in MOE_TRAIN_LAUNCHES["off"]],
                         small.n_layers, True, small.n_layers)
    compare_step("MoE train step small f32 config, card vs CPU plain path", card_step,
                 sgd_step(small, small_params, small_batch, device="cpu"), F32_LOSS_REL,
                 F32_GRAD_REL)

    g = results["grouped_backward"]

    def entry(name, which, tag, launches, by_path, variant):
        rows = [g["by_shape"][f"{tag} {label} balanced"][which] for label in MOE_PRODUCTS]

        def total(key):
            vals = [r.get(key) for r in rows]
            return None if any(v is None for v in vals) else sum(vals)

        return {
            "name": name,
            "route": "cuda",
            "source": "jobset_tpu_torch/ops/csrc/grouped_matmul.cu",
            "replaces": "jobset_tpu/models/transformer.py:670",
            "replaces_is": f"the {which} ragged_dot_general of the VJP of lax.ragged_dot in "
                           "sorted_ragged_expert_ffn (:670 and :675), an XLA program (no Pallas "
                           "kernel)",
            "variant": variant,
            "launches": launches,
            "launches_by_path": by_path,
            "ms": total("ms"),
            **({"copy_ms": total("copy_ms")} if which == "dgrad" else {}),
            "plain_ms": total("plain_ms"),
            **({"parent_ms": total("parent_ms")} if baseline else {}),
            "bound_ms": total("bound_ms"),
            "bound_by": rows[0]["bound_by"],
            **({"bound_fma_ms": total("bound_fma_ms")} if tag == "f32" else {}),
            "library_ms": total("library_ms"),
            "library_call": f"torch._grouped_mm ({tag}), where the card's torch runs it",
            "shape": f"{tag}, the backward of a layer's two products: [{MOE_SLOTS},1024] x "
                     f"[{MOE_EXPERTS},1024,{MOE_D_FF}] and [{MOE_SLOTS},{MOE_D_FF}] x "
                     f"[{MOE_EXPERTS},{MOE_D_FF},1024], balanced routing; L2-cold",
            "max_abs_err": max(g["max_abs_err"][f"{which} {tag} {label} balanced"]
                               for label in MOE_PRODUCTS),
            "max_abs_err_by_case": {k: v for k, v in g["max_abs_err"].items()
                                    if k.startswith(f"{which} {tag}")},
            "by_shape": {k: v[which] for k, v in g["by_shape"].items() if k.startswith(tag)},
        }

    bench_counts = results["moe_train_bench_launches"]
    by_path = {f"f32 flagship train step, remat {p}": v for p, v in launches.items()}
    return [
        entry("grouped_matmul_dgrad", "dgrad", "bf16", bench_counts["GROUPED_DGRAD_LAUNCHES"],
              {"MoE run_model_bench, all steps": bench_counts["GROUPED_DGRAD_LAUNCHES"],
               **{k: v["GROUPED_DGRAD_LAUNCHES"] for k, v in by_path.items()}},
              "the forward's TMA kernel with B read K-major (grouped_mm_tma_kernel<true>: wgmma "
              "fed by TMA, w as it lies, no copy); where TMA cannot take the operands, w copied "
              "to [E, N, K] and grouped_mm_bf16_kernel"),
        entry("grouped_matmul_dgrad_f32", "dgrad", "f32", small_counts["GROUPED_DGRAD_F32_LAUNCHES"],
              {"small f32 config train step": small_counts["GROUPED_DGRAD_F32_LAUNCHES"],
               **{k: v["GROUPED_DGRAD_F32_LAUNCHES"] for k, v in by_path.items()}},
              "w copied to [E, N, K], then the forward's f32 kernel (grouped_mm_f32_kernel, "
              "3xTF32 on mma.sync)"),
        entry("grouped_matmul_wgrad", "wgrad", "bf16", bench_counts["GROUPED_WGRAD_LAUNCHES"],
              {"MoE run_model_bench, all steps": bench_counts["GROUPED_WGRAD_LAUNCHES"],
               **{k: v["GROUPED_WGRAD_LAUNCHES"] for k, v in by_path.items()}},
              "grouped_wgrad_tma_kernel: one block a (256-column N tile, 128-row K tile, "
              "expert) walking its segment's rows in steps of 64 loaded by TMA from a producer "
              "warp, wgmma m64n256k16 with xs^T read M-major and dy N-major, rows past the "
              "segment zeroed in shared memory, the tile staged in shared memory and stored by "
              "TMA while the next tile's products run; operands TMA cannot take go to "
              "grouped_wgrad_bf16_kernel (mma.sync, ldmatrix.trans)"),
        entry("grouped_matmul_wgrad_f32", "wgrad", "f32", small_counts["GROUPED_WGRAD_F32_LAUNCHES"],
              {"small f32 config train step": small_counts["GROUPED_WGRAD_F32_LAUNCHES"],
               **{k: v["GROUPED_WGRAD_F32_LAUNCHES"] for k, v in by_path.items()}},
              "grouped_wgrad_f32_tma_kernel: persistent over (expert, 128-row K tile, 128-column "
              "N tile), steps of 32 rows loaded by TMA from a producer warp, dy split into big "
              "and small TF32 and written K-major in shared memory by the consumer warps a step "
              "ahead, xs^T from registers, 3xTF32 on tf32 wgmma m64n128k8, sums promoted "
              "to f32 every 64 rows; operands TMA cannot take go to grouped_wgrad_f32_kernel "
              "(3xTF32 on mma.sync m16n8k8, 4-byte copies)"),
    ]


def phase_moe_train_apart(results, baseline=None):
    """Phase 13 in a process of its own (`--moe-train-only`). Returns its
    `kernels` entries (none if it failed)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moe_train.json")
        extra = ["--grouped-baseline", baseline] if baseline else []
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--moe-train-only",
                              "--out", path, *extra], capture_output=True, text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 13 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            train = json.load(f)
    for key in ("grouped_backward", "moe_model_bench", "moe_model_bench_losses",
                "moe_train_bench_launches", "moe_train_step_launches",
                "moe_train_grad_rel_vs_plain", "moe_train_layers", "moe_train_trace",
                "moe_train_f32_trace"):
        results[key] = train.get(key)
    return train.get("moe_train_kernels") or []


# ---------------------------------------------------------------------------
# Phase 14: the remaining workload kinds (mlp, cnn), adafactor and the
# simulator's WorkloadRunner
# ---------------------------------------------------------------------------

# examples/training/mlp-checkpoint.yaml's payload (its checkpoint_dir is
# set per run) and failure policy.
MLP_CHECKPOINT_PAYLOAD = {"kind": "mlp", "steps": 10, "checkpoint_every": 2, "fail_at_step": 5,
                          "config": {"d_in": 8, "d_hidden": 32, "d_out": 4}}
MLP_CHECKPOINT_MAX_RESTARTS = 2
# The card's f32 paths against the CPU's (no TF32 in cuBLAS or cuDNN): the
# MLP's losses over its steps, rtol 1e-4 (f32 sums in another order, carried
# through adam's steps); the runner's final-loss annotation (6 decimals) the
# same. The default CNN payload is bf16: its losses within 2e-2 relative
# (cuDNN and the CPU round each bf16 convolution's output apart; on the CPU
# the payload's four losses in bf16 and in f32 differ by at most 4.1e-3).
# The mlp and cnn kinds draw their parameters on a CPU generator, so both
# runs start from the same weights.
WORKLOAD_F32_REL, CNN_BF16_LOSS_REL = 1e-4, 2e-2
# He et al., "Deep Residual Learning for Image Recognition" (2016), sec.
# 4.2: CIFAR-10 (32x32x3, 10 classes) at a mini-batch of 128.
CNN_BATCH, CNN_IMAGE, CNN_WARMUP, CNN_STEPS = 128, 32, 3, 20
ADAFACTOR_WARMUP, ADAFACTOR_STEPS = 3, 20


class StandInCluster:
    """The control plane as far as `WorkloadRunner` reads it, for one JobSet
    of one replicated job (the card's machine has no `jobset_tpu`): `pods`
    (with the labels and annotations `distributed.pod_env_for` reads),
    `jobsets`, `get_jobset`, `jobs_for_jobset`, `fail_job`,
    `complete_all_jobs` and `run_until_stable`. Its failure policy is the
    JobSet controller's: a failed child job restarts the gang (every job
    and pod recreated Running and Ready, `status.restarts` + 1) while
    restarts < max_restarts, and otherwise fails the JobSet; completing
    every child job completes it."""

    JOBSET_NAME_KEY = "jobset.sigs.k8s.io/jobset-name"

    def __init__(self, name, payload, replicas=1, parallelism=1, max_restarts=2):
        self.pod_spec = NS(workload=payload)
        job_spec = NS(parallelism=parallelism, template=NS(spec=self.pod_spec),
                      pods_expected=lambda: parallelism)
        self.js = NS(name=name, namespace="default",
                     metadata=NS(uid=f"uid-{name}", annotations={}, namespace="default",
                                 name=name),
                     spec=NS(replicated_jobs=[NS(name="trainer", replicas=replicas,
                                                 template=NS(spec=job_spec))], network=None),
                     status=NS(terminal_state="", restarts=0))
        self.jobsets = {("default", name): self.js}
        self.replicas, self.parallelism, self.max_restarts = replicas, parallelism, max_restarts
        self.log: list[str] = []
        self._create_gang()

    def _create_gang(self):
        from jobset_tpu_torch.runtime import distributed as d

        js = self.js
        self.jobs = [NS(metadata=NS(namespace="default", name=f"{js.name}-trainer-{i}"))
                     for i in range(self.replicas)]
        self.pods = {("default", f"{job.metadata.name}-{p}-r{js.status.restarts}"): NS(
            annotations={self.JOBSET_NAME_KEY: js.name, d.POD_COMPLETION_INDEX_KEY: str(p)},
            labels={d.REPLICATED_JOB_NAME_KEY: "trainer", d.JOB_INDEX_KEY: str(i),
                    d.JOB_GLOBAL_INDEX_KEY: str(i), d.RESTARTS_KEY: str(js.status.restarts)},
            metadata=NS(namespace="default"), spec=self.pod_spec,
            status=NS(phase="Running", ready=True))
            for i, job in enumerate(self.jobs) for p in range(self.parallelism)}

    def get_jobset(self, namespace, name):
        return self.jobsets.get((namespace, name))

    def jobs_for_jobset(self, js):
        return list(self.jobs) if js is self.js else []

    def fail_job(self, namespace, name):
        js = self.js
        self.log.append(f"job {name} failed at restart {js.status.restarts}")
        if js.status.restarts < self.max_restarts:
            js.status.restarts += 1
            self._create_gang()
            self.log.append(f"gang restarted (restarts {js.status.restarts})")
        else:
            js.status.terminal_state = "Failed"
            self.pods = {}
            self.log.append("JobSet Failed")

    def complete_all_jobs(self, js):
        js.status.terminal_state = "Completed"
        self.pods = {}
        self.log.append("JobSet Completed")

    def run_until_stable(self):
        return 0


def mlp_checkpoint_sequence(device, checkpoint_dir) -> dict:
    """mlp-checkpoint.yaml's payload through the port's `WorkloadRunner` on
    `device`, over `StandInCluster`: the first incarnation fails at step 5,
    the gang restarts, the rerun resumes from step 4's checkpoint and the
    JobSet completes. Returns what each `run_pending` ran, the cluster's
    log, the final state, the latest checkpoint and the annotations."""
    from jobset_tpu_torch.runtime import WorkloadRunner
    from jobset_tpu_torch.runtime.checkpoint import Checkpointer

    payload = dict(MLP_CHECKPOINT_PAYLOAD, checkpoint_dir=checkpoint_dir)
    cluster = StandInCluster("mlp-checkpoint", payload, max_restarts=MLP_CHECKPOINT_MAX_RESTARTS)
    runner = WorkloadRunner(cluster, device)
    ready = runner.gang_ready(cluster.js)
    first = runner.run_pending()
    after_first = (cluster.js.status.restarts, cluster.js.status.terminal_state)
    latest_after_failure = Checkpointer(checkpoint_dir).latest_step()
    second = runner.run_pending()
    third = runner.run_pending()  # ran for this incarnation: nothing more
    return {"gang_ready": ready, "ran": [first, second, third], "after_first": after_first,
            "checkpoint_after_failure": latest_after_failure,
            "latest_step": Checkpointer(checkpoint_dir).latest_step(),
            "restarts": cluster.js.status.restarts,
            "terminal_state": cluster.js.status.terminal_state,
            "annotations": dict(cluster.js.metadata.annotations), "log": cluster.log}


def cnn_conv_flops(cfg, image: int) -> float:
    """Forward FLOPs of one image through the CNN, from its conv shapes (2
    per multiply-add; "SAME" outputs of ceil(size / stride)) and the head;
    GroupNorm, ReLU, the residual adds and the pooling are left out."""
    total, size = 2.0 * image * image * 9 * cfg.in_channels * cfg.widths[0], image
    cin = cfg.widths[0]
    for s, width in enumerate(cfg.widths):
        for b in range(cfg.blocks_per_stage):
            stride = 2 if (b == 0 and s > 0) else 1
            out = -(-size // stride)
            c1 = cin if b == 0 else width
            total += 2.0 * out * out * 9 * c1 * width + 2.0 * out * out * 9 * width * width
            if b == 0 and (s > 0 or cin != width):
                total += 2.0 * out * out * cin * width
            size = out
        cin = width
    return total + 2.0 * cfg.widths[-1] * cfg.num_classes


def state_bytes(state) -> int:
    from jobset_tpu_torch import tree

    return sum(t.numel() * t.element_size() for t in tree.leaves(state) if torch.is_tensor(t))


def median_step_ms(step, params, state, batch, warmup, steps):
    """Run warmup + steps train steps, each synchronized; (median ms of the
    timed ones, their range, losses, params, state)."""
    times, losses = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    times.sort()
    return times[len(times) // 2], (times[0], times[-1]), losses, params, state


def phase_workloads_mlp(results):
    import tempfile

    from jobset_tpu_torch.runtime import runner

    payload = dict(MLP_CHECKPOINT_PAYLOAD, steps=20)
    payload.pop("fail_at_step")
    payload.pop("checkpoint_every")
    reset_launches()
    card = runner.train_workload(payload, "cuda")
    flash = launches_now()["KERNEL_LAUNCHES"]
    cpu = runner.train_workload(payload, "cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    check(len(card) == 20 and rel <= WORKLOAD_F32_REL and card[-1] < card[0],
          f"mlp train_workload (mlp-checkpoint widths, 20 steps): card losses within "
          f"{WORKLOAD_F32_REL} of the CPU's (worst {rel:.2e}), {card[0]:.4f} -> {card[-1]:.4f}")
    check(flash == 0, f"mlp train_workload: no flash launch ({flash})")
    default = runner.train_workload({"steps": 3}, "cuda")  # no kind: the reference's "mlp"
    check(len(default) == 3 and all(np.isfinite(default)),
          f"a payload with no kind trains the default mlp: {[round(l, 4) for l in default]}")
    results["mlp_losses"] = {"card": list(card), "cpu": list(cpu), "worst_rel": rel}

    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        seq = mlp_checkpoint_sequence("cuda", os.path.join(tmp, "card"))
        flash = launches_now()["KERNEL_LAUNCHES"]
        ref = mlp_checkpoint_sequence("cpu", os.path.join(tmp, "cpu"))
    for line in seq["log"]:
        print(f"  WorkloadRunner on the card: {line}", flush=True)
    final = float(seq["annotations"].get("tpu.jobset.x-k8s.io/final-loss", "nan"))
    want = float(ref["annotations"].get("tpu.jobset.x-k8s.io/final-loss", "nan"))
    check(seq["gang_ready"] and seq["ran"] == [["mlp-checkpoint"], ["mlp-checkpoint"], []]
          and seq["after_first"] == (1, "") and seq["checkpoint_after_failure"] == 4
          and seq["latest_step"] == 10 and seq["terminal_state"] == "Completed",
          f"WorkloadRunner, mlp-checkpoint.yaml on the card: fails at step 5 with step 4 "
          f"checkpointed ({seq['checkpoint_after_failure']}), the gang restarts "
          f"({seq['after_first']}), the rerun resumes and completes (latest step "
          f"{seq['latest_step']}, {seq['terminal_state']}), one run an incarnation "
          f"({seq['ran']})")
    check(abs(final - want) <= WORKLOAD_F32_REL * abs(want) + 1e-6 and ref["terminal_state"]
          == "Completed", f"WorkloadRunner: final-loss annotation {final} on the card vs "
          f"{want} on the CPU")
    check(flash == 0, f"WorkloadRunner mlp: no flash launch ({flash})")
    results["workload_runner"] = {"card": seq, "cpu": ref}


def phase_workloads_cnn(results):
    from jobset_tpu_torch import tree
    from jobset_tpu_torch.models import cnn
    from jobset_tpu_torch.runtime import optim, runner

    card_name = results["card"]
    # The runner's default cnn payload: the default CNNConfig (bf16 over
    # f32 params), B=8, 32x32 images.
    payload = {"kind": "cnn", "steps": 4}
    reset_launches()
    card = runner.train_workload(payload, "cuda")
    flash = launches_now()["KERNEL_LAUNCHES"]
    cpu = runner.train_workload(payload, "cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    check(len(card) == 4 and all(np.isfinite(card)) and rel <= CNN_BF16_LOSS_REL,
          f"cnn train_workload, default payload (B=8, 32x32, bf16): card losses within "
          f"{CNN_BF16_LOSS_REL} of the CPU's (worst {rel:.2e}): {[round(l, 4) for l in card]}")
    check(flash == 0, f"cnn train_workload: no flash launch ({flash})")
    results["cnn_default_losses"] = {"card": list(card), "cpu": list(cpu), "worst_rel": rel}

    # A small f32 config's step, card against CPU (cuDNN's TF32 off).
    small = cnn.CNNConfig(widths=(16, 32), blocks_per_stage=1, groups=4, dtype=torch.float32)
    params = cnn.init_params(small, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(6)
    batch = {"images": rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, (8,))}

    def sgd_cnn_step(p, device):
        opt = optim.sgd(1.0)
        new, _, loss = cnn.build_train_step(small, opt, device)(p, opt.init(p), batch)
        return float(loss), [a - b for a, b in zip(tree.leaves(p), tree.leaves(new))]

    check(not torch.backends.cudnn.allow_tf32, "cnn f32 check: cuDNN's TF32 is off")
    compare_step("small f32 cnn train step, card vs CPU",
                 sgd_cnn_step(tree.tree_map(lambda t: t.cuda(), params), "cuda"),
                 sgd_cnn_step(params, "cpu"), F32_LOSS_REL, F32_GRAD_REL)

    # At a real size: the default CNNConfig on CIFAR-10's shape at B=128.
    cfg = cnn.CNNConfig()
    params = cnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = optim.adam(1e-3)
    step = cnn.build_train_step(cfg, opt, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"images": torch.randn((CNN_BATCH, CNN_IMAGE, CNN_IMAGE, cfg.in_channels),
                                   generator=gen, device="cuda"),
             "labels": torch.randint(0, cfg.num_classes, (CNN_BATCH,), generator=gen,
                                     device="cuda")}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    median, (lo, hi), losses, params, state = median_step_ms(
        step, params, opt.init(params), batch, CNN_WARMUP, CNN_STEPS)
    flash = launches_now()["KERNEL_LAUNCHES"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flops = 3.0 * cnn_conv_flops(cfg, CNN_IMAGE) * CNN_BATCH
    mfu = flops / (median / 1e3) / BF16_FLOPS
    check(all(np.isfinite(losses)) and losses[-1] < losses[0] and flash == 0,
          f"cnn B={CNN_BATCH} {CNN_IMAGE}x{CNN_IMAGE}: every loss finite, {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, no flash launch ({flash})")
    print(f"cnn train step, default CNNConfig (widths 32/64/128, 2 blocks a stage, GroupNorm 8, "
          f"bf16 over f32) B={CNN_BATCH} {CNN_IMAGE}x{CNN_IMAGE}x3, adam: median of {CNN_STEPS} "
          f"{median:.3f} ms ({lo:.3f}-{hi:.3f}), {CNN_BATCH / median * 1e3:.1f} images/s, "
          f"{flops / 1e9:.2f} GFLOP a step ({cnn_conv_flops(cfg, CNN_IMAGE) / 1e9:.4f} GFLOP an "
          f"image forward, x3 to train), {flops / (median / 1e3) / 1e12:.2f} TFLOP/s, MFU "
          f"{mfu:.2%} of {BF16_FLOPS / 1e12:.0f} TFLOP/s, peak memory {peak_gb:.3f} GB "
          f"(information; {card_name})", flush=True)
    holder = {}

    def one_step():
        holder["out"] = step(params, state, batch)

    trace = traced(one_step, f"cnn train step (B={CNN_BATCH}, {CNN_IMAGE}x{CNN_IMAGE}, adam)")
    results["cnn_bench"] = {"batch": CNN_BATCH, "image": CNN_IMAGE, "step_ms_median": median,
                            "step_ms_range": [lo, hi], "images_per_s": CNN_BATCH / median * 1e3,
                            "gflop_per_step": flops / 1e9, "mfu": mfu, "peak_memory_gb": peak_gb,
                            "losses": losses, "flash_launches": flash, "trace": trace}
    del params, state, holder, step, batch
    torch.cuda.empty_cache()


def phase_workloads_adafactor(results):
    from jobset_tpu_torch import tree
    from jobset_tpu_torch.models import TransformerConfig, build_train_step, init_params
    from jobset_tpu_torch.runtime import optim

    card_name = results["card"]
    cfg = flagship_config()
    batch = token_batch(cfg.vocab_size, BATCH, PROMPT, seed=3)  # phase 7's inputs
    runs = {}
    for name, opt in (("adam", optim.adam(1e-3)), ("adafactor", optim.adafactor(1e-3))):
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        state = opt.init(params)
        nbytes = state_bytes(state)
        step = build_train_step(cfg, opt)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        median, (lo, hi), losses, params, state = median_step_ms(
            step, params, state, batch, ADAFACTOR_WARMUP, ADAFACTOR_STEPS)
        n = ADAFACTOR_WARMUP + ADAFACTOR_STEPS
        counts = launches_now()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(counts["KERNEL_LAUNCHES"] == LAYERS * n
              and counts["TENSOR_CORE_LAUNCHES"] == LAYERS * n,
              f"flagship train step, {name}: {LAYERS} flash launches a step, all on the "
              f"tensor-core variant ({counts} over {n} steps)")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"flagship train step, {name}: every loss finite, {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}")
        print(f"flagship train step B={BATCH} T={PROMPT} (remat off), {name} 1e-3: median of "
              f"{ADAFACTOR_STEPS} {median:.3f} ms ({lo:.3f}-{hi:.3f}), peak memory "
              f"{peak_gb:.3f} GB, optimizer state {nbytes / 1e6:.3f} MB (information; "
              f"{card_name})", flush=True)
        # The update's own device time: one traced optimizer update on a
        # step's gradients (sgd at lr 1 gives them as p - p').
        sgd = optim.sgd(1.0)
        new, _, _ = build_train_step(cfg, sgd)(params, sgd.init(params), batch)
        grads = tree.tree_map(lambda p, q: p - q, params, new)
        del new
        update = traced(lambda: opt.update(grads, state, params),
                        f"{name} update alone (flagship, {sum(t.numel() for t in tree.leaves(params)) / 1e6:.1f} M params)")
        holder = {}

        def one_step():
            holder["out"] = step(params, state, batch)

        trace = traced(one_step, f"flagship train step, {name}")
        runs[name] = {"step_ms_median": median, "step_ms_range": [lo, hi],
                      "peak_memory_gb": peak_gb, "state_bytes": nbytes, "losses": losses,
                      "launches": counts, "update_trace": update, "step_trace": trace}
        del params, state, grads, holder, step
        torch.cuda.empty_cache()
    results["adafactor_vs_adam"] = runs
    ratio = runs["adafactor"]["state_bytes"] / runs["adam"]["state_bytes"]
    check(ratio < 0.01, f"adafactor's state is {ratio:.2e} of adam's "
          f"({runs['adafactor']['state_bytes']} vs {runs['adam']['state_bytes']} bytes)")

    # A small f32 config with factored and unfactored leaves: two adafactor
    # steps on the card against the CPU.
    small = TransformerConfig(vocab_size=256, d_model=128, n_heads=4, d_ff=256, n_layers=2,
                              dtype=torch.float32, remat=False)
    params = init_params(small, torch.Generator().manual_seed(0), "cpu")
    factored = [tuple(p.shape) for p in tree.leaves(params)
                if optim.factored_dims(p.shape) is not None]
    batches = [token_batch(256, 4, 32, seed=8 + i, device="cpu") for i in range(2)]

    def two_steps(p, device):
        opt = optim.adafactor(1e-2)
        step, state, losses = build_train_step(small, opt, device=device), opt.init(p), []
        for b in batches:
            p, state, loss = step(p, state, {k: t.to(device) for k, t in b.items()})
            losses.append(float(loss))
        return losses, p

    start = tree.leaves(params)
    card_losses, card_params = two_steps(tree.tree_map(lambda t: t.cuda(), params), "cuda")
    cpu_losses, cpu_params = two_steps(params, "cpu")
    rels = [((c.cpu() - s) - (w - s)).norm().item() / max((w - s).norm().item(), 1e-30)
            for c, w, s in zip(tree.leaves(card_params), tree.leaves(cpu_params), start)]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    check(factored and len(factored) < len(start) and loss_rel <= F32_LOSS_REL
          and max(rels) <= F32_GRAD_REL,
          f"small f32 LM, two adafactor steps, card vs CPU: losses within {F32_LOSS_REL} "
          f"(worst {loss_rel:.2e}), each leaf's move within {F32_GRAD_REL} in relative norm "
          f"(worst {max(rels):.2e}; {len(factored)} of {len(start)} leaves factored)")


def phase_workloads(results):
    """Phase 14: the mlp and cnn workload kinds, adafactor and the
    simulator's WorkloadRunner on the card, each against the port's CPU
    path; the CNN at a real size; adafactor beside adam on the flagship."""
    phase_workloads_mlp(results)
    phase_workloads_cnn(results)
    phase_workloads_adafactor(results)


def phase_workloads_apart(results):
    """Phase 14 in a process of its own (`--workloads-only`)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "workloads.json")
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--workloads-only",
                              "--out", path], capture_output=True, text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 14 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return
        with open(path) as f:
            workloads = json.load(f)
    for key in ("mlp_losses", "workload_runner", "cnn_default_losses", "cnn_bench",
                "adafactor_vs_adam"):
        results[key] = workloads.get(key)


# ---------------------------------------------------------------------------
# Phase 15: the gang
# ---------------------------------------------------------------------------

# The gang runs: GANG_STEPS adam steps (lr GANG_LR) after one gradient
# step, then GANG_WARMUP + GANG_TIMED timed steps (the adam steps warm the
# path) and one step with its all-reduces timed, each rank its own process
# on the one card.
GANG_STEPS, GANG_LR, GANG_WARMUP, GANG_TIMED = 3, 1e-3, 0, 1
GANG_TIMEOUT_S = 600
# (c)'s MoE gangs (bf16 and f32) run 1 of the MoE flagship's 8 layers,
# (a) and (b) 2 of the dense flagship's 8, phase 16's dense flagship 2 of
# its 8 and phase 17's 4 (the interleave takes 2 chunks of a stage's
# layers): full width, cut in depth, so that the whole run with phase 19
# stays well inside its time limit on a slow host.
GANG_MOE_LAYERS, GANG_DENSE_LAYERS, SP_LAYERS, PP_LAYERS = 1, 2, 2, 4
# Held against the single-process run on the card, same parameters and
# batches (the ranks' all-reduces add the shards' partial sums in another
# order than one product does):
# - bf16 (the dense flagship at tp 2, the MoE flagship at dp 2 x tp 2):
#   phase 7's bounds, loss within 1e-2 relative and each gradient leaf
#   within 5e-2 in relative norm (bf16 products rounded at other places:
#   the tp partial sums are rounded to bf16 before they are added), and
#   each leaf's move over the adam steps within 0.15 in relative norm
#   (tests/test_torch_train.py's bf16 Adam bound: the scale-free update
#   turns every gradient entry within bf16 noise of zero into a move of
#   about lr in either direction);
# - f32 with TF32 off (a small config at tp 2): losses and gradient leaves
#   within 1e-5 relative (norm), and every parameter's move within 0.05 *
#   lr a step (the CPU tests' f32 Adam bound: the same scale-free update);
# - NCCL at world 1 (the dense flagship): bit for bit.
GANG_BF16_LOSS_REL, GANG_BF16_GRAD_REL, GANG_BF16_MOVE_REL = 1e-2, 5e-2, 0.15
GANG_F32_REL = 1e-5
# The MoE flagship's gang in bf16 is held on its losses only: end to end
# bf16 routes apart (phase 13), a token whose top-2 gates lie within the
# tp partial sums' rounding picking another expert, which moves every
# leaf's gradient (0.08-0.19 in relative norm on the card); its kernels
# are held at the rank's shapes (`gang_kernel_checks`). Its gradients and
# moves are held in f32 (TF32 off), at (c)'s B=8 (the four f32 ranks took
# 72.6-74.6 GB together on the card): losses within 1e-5, gradient leaves
# within 1e-4 relative (norm; f32 sums in another order through 8 layers
# and two grouped products a layer), and the first adam step's moves entry
# by entry (ADAM_NOISE_GRAD). The moves over all the steps are printed,
# not bounded: in the card's run rank 0's tokens took one process's
# experts in steps 1-2 and 21 token-layer picks differed in step 3 (top-2
# gates within the f32 rounding of parameters one step apart), and the
# changed gradients of entries near zero move them by up to lr either way
# under Adam (most in the experts, the embedding and the unembedding).
GANG_F32_MOE_BATCH, GANG_F32_MOE_GRAD_REL = BATCH, 1e-4
# Adam's first step moves an entry by lr * g / (|g| + eps), eps = 1e-8
# (optax's default): where |g| is within a few eps its move is set by the
# gradient's rounding (~1e-9 absolute on the card's run, sums of f32
# partials in another order), not by the gradient, so the f32 MoE gang's
# first-step moves are held entry by entry only where one process's
# |gradient| exceeds 10 eps; below it the entries past the bound are
# counted. On the card's run every entry past 0.05 * lr had |g| <= 1.2e-8.
ADAM_NOISE_GRAD = 1e-7
# examples/training/lm-moe-dropless.yaml's payload (held to the file by
# tests/test_torch_workloads.py) and its gang: 2 jobs of 2 pods.
LM_MOE_DROPLESS_PAYLOAD = {
    "kind": "lm", "steps": 8, "batch_size": 4, "seq_len": 16,
    "config": {"vocab_size": 128, "d_model": 64, "n_heads": 4, "d_ff": 128, "n_layers": 2,
               "max_seq_len": 32, "n_experts": 4, "d_ff_expert": 64, "moe_top_k": 2,
               "moe_dispatch": "dropless"},
    "mesh": {"dp": 2, "tp": 2}}
LM_MOE_DROPLESS_GANG = (2, 2)  # replicas, pods a job


# A gang rank's grouped products in (c): a dp rank routes its B/dp rows of
# the batch (top 2), a tp rank holds d_ff_expert/tp columns of we1 and rows
# of we2.
GANG_MOE_ROWS = BATCH // 2 * PROMPT * MOE_TOP_K
GANG_MOE_PRODUCTS = {"we1": (1024, MOE_D_FF // 2), "we2": (MOE_D_FF // 2, 1024)}


def gang_kernel_checks() -> dict:
    """The grouped forward, dgrad and wgrad kernels at a rank's products in
    (c), bf16 and f32, four routings each, against their plain versions:
    phase 12a's and 13a's checks (the kernels' tolerance, one launch on
    the dtype's TMA kernel, two launches equal bit for bit, bf16 dgrad
    equal bit for bit to the forward on w transposed, wgrad's empty experts
    exactly 0). Returns max|got - want| by case."""
    errs, seed = {}, 400
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for label, (k, n) in GANG_MOE_PRODUCTS.items():
            for routing in MOE_CHECK_ROUTINGS:
                name = (f"gang rank {tag} {label} [{GANG_MOE_ROWS},{k}]x[{MOE_EXPERTS},{k},{n}] "
                        f"{routing}")
                errs[f"forward {tag} {label} {routing}"] = grouped_case(
                    name, dtype, k, n, routing, seed, GANG_MOE_ROWS)
                for which in BACKWARD_OPS:
                    errs[f"{which} {tag} {label} {routing}"] = backward_case(
                        which, name, dtype, k, n, routing, seed + 1, rows=GANG_MOE_ROWS)
                seed += 2
    torch.cuda.empty_cache()
    return errs


def gang_small_config():
    """Phase 7's small f32 GQA config (TF32 off)."""
    from jobset_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                             n_layers=2, dtype=torch.float32, remat=False)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def grads_optimizer():
    """An optimizer that moves nothing and keeps the gradients of its first
    update as `state["g"]`: one train step's (dp-summed) gradients."""
    from jobset_tpu_torch import tree
    from jobset_tpu_torch.runtime.optim import Optimizer

    def init(params):
        return {"count": 0, "g": tree.tree_map(lambda p: p.new_zeros(p.shape), params)}

    def update(grads, state, params):
        return (tree.tree_map(lambda g: g.new_zeros(g.shape), grads),
                {"count": state["count"] + 1, "g": grads if state["count"] == 0 else state["g"]})

    return Optimizer(init, update, lambda specs, shapes: {"count": None, "g": specs})


@contextlib.contextmanager
def recording_routes(into: list):
    """While active, each top-k pick of the MoE paths (`renormalized_topk`)
    appends its experts [tokens, k] to `into`, on the host."""
    from jobset_tpu_torch.models import transformer

    real = transformer.renormalized_topk

    def recording(gates, k):
        top_w, top_i = real(gates, k)
        into.append(top_i.detach().to("cpu", torch.int16))
        return top_w, top_i

    transformer.renormalized_topk = recording
    try:
        yield
    finally:
        transformer.renormalized_topk = real


def route_flips(routes, ref_routes, rows, seq, per_step) -> list:
    """For each step, the tokens of `rows` (of the global batch) whose
    set of experts differs from the reference's, summed over the step's
    `per_step` picks (one a layer)."""
    tokens = (torch.as_tensor(rows)[:, None] * seq + torch.arange(seq)).flatten()
    flips = [0] * (len(routes) // per_step)
    for i, (got, want) in enumerate(zip(routes, ref_routes)):
        got, want = got.sort(dim=-1).values, want[tokens].sort(dim=-1).values
        flips[i // per_step] += int((got != want).any(dim=-1).sum())
    return flips


def gang_reference(cfg, batch, seq, path, device="cuda", first_move=False,
                   steps=GANG_STEPS) -> dict:
    """The single-process run a gang is held to, on the card: the gradients
    of one step and `steps` adam steps from the parameters of seed 0 on
    phase 7's batches (seeds 3, 4, ...); the gradients, each leaf's move
    (with first_move, also its move after the first adam step and the
    experts each token took in each adam step) and the losses saved to
    `path` (CPU tensors). Run in a process of its own
    (`reference_apart`), so that its memory leaves the card with it."""
    from jobset_tpu_torch import tree
    from jobset_tpu_torch.models import build_train_step, init_params
    from jobset_tpu_torch.runtime import optim

    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    batches = [token_batch(cfg.vocab_size, batch, seq, seed=3 + i, device=device)
               for i in range(steps)]
    grads_opt = grads_optimizer()
    same, state, grad_loss = build_train_step(cfg, grads_opt, device=device)(
        params, grads_opt.init(params), batches[0])
    grads = tree.tree_map(lambda g: g.cpu(), state["g"])
    del same, state
    opt = optim.adam(GANG_LR)
    step = build_train_step(cfg, opt, device=device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    moved, opt_state, losses, moves1, routes = params, opt.init(params), [], None, []
    for b in batches:
        with recording_routes(routes) if first_move else contextlib.nullcontext():
            moved, opt_state, loss = step(moved, opt_state, b)
        losses.append(float(loss))
        if first_move and moves1 is None:
            moves1 = tree.tree_map(lambda a, b: (a - b).cpu(), moved, params)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    moves = tree.tree_map(lambda a, b: (a - b).cpu(), moved, params)
    out = {"grads": grads, "moves": moves, "moves1": moves1, "routes": routes,
           "losses": losses, "grad_loss": float(grad_loss)}
    torch.save(out, path)
    del params, moved, opt_state, batches, grads, moves, out
    if cuda:
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_loss": float(grad_loss), "peak_gb": peak_gb}


def reference_apart(cfg, batch, seq, path, first_move=False) -> dict:
    """`gang_reference` on the card in a process of its own (a gang of one
    whose process group it does not use)."""
    from jobset_tpu_torch.runtime import gang

    return gang.spawn(gang_reference, 1, (cfg, batch, seq, path, "cuda", first_move),
                      backend="gloo", device="cuda", timeout_s=GANG_TIMEOUT_S, threads=0)[0]


def gang_references(jobs: list) -> list:
    """`gang_reference(**job)` for each job in turn, in one process."""
    return [gang_reference(**job) for job in jobs]


def references_and_rank(jobs: list, spec: dict) -> tuple:
    """`gang_references(jobs)`, then `gang_rank(spec)` in the same process
    (a gang of one on its process group): phase 15's single-process runs,
    then (a)."""
    return gang_references(jobs), gang_rank(spec)


def gathered(leaf, spec, mesh):
    """A leaf's shards gathered over each axis its spec splits it over (tp,
    pp); every rank of each group takes part."""
    from jobset_tpu_torch.parallel import collectives

    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            leaf = collectives.gather(leaf, dim, mesh.group(axis))
    return leaf


def pp_view(pp: int, virtual: int):
    """A single-process tree (layer leaves [1, n_layers, ...]) as a pp gang
    holds it globally: the layer leaves restacked [pp, n_layers / pp, ...]
    and, for the interleave, permuted (`interleave_stage_params`)."""
    from jobset_tpu_torch.parallel.pipeline import interleave_stage_params

    def view(t):
        if pp == 1 or t is None:
            return t
        layers = {k: v.reshape(pp, -1, *v.shape[2:]) for k, v in t["layers"].items()}
        if virtual > 1:
            layers = interleave_stage_params(layers, pp, virtual)
        return dict(t, layers=layers)

    return view


def gathered_diffs(local, ref, specs, mesh, device, grads=None, bound=0.0) -> list:
    """Leaf by leaf, the shards gathered over tp and pp (every rank takes
    part) and, on rank 0, (||got - ref|| / ||ref||, max|got - ref|,
    max|ref|) against the reference tree (CPU, loaded lazily, in the gang's
    layout); other ranks get []. With `grads` (the reference's first-step
    gradients), two more: max|got - ref| over the entries whose |gradient|
    exceeds ADAM_NOISE_GRAD, and the count of the other entries where
    |got - ref| exceeds `bound`."""
    from jobset_tpu_torch import tree

    out = []
    refs = tree.leaves(ref) if ref is not None else None
    for i, (leaf, spec) in enumerate(zip(tree.leaves(local), tree.leaves(specs))):
        full = gathered(leaf, spec, mesh)
        if refs is not None:
            want = refs[i].to(device).float()
            d = (full.float() - want).abs()
            row = (float(d.norm() / want.norm().clamp(min=1e-30)), float(d.max()),
                   float(want.abs().max()))
            if grads is not None:
                held = tree.leaves(grads)[i].to(device).float().abs() > ADAM_NOISE_GRAD
                row += (float(d[held].max()) if bool(held.any()) else 0.0,
                        int(((d > bound) & ~held).sum()))
            out.append(row)
        del full
    return out


def leaf_names(node, prefix="") -> list:
    """The leaves' paths, in `tree.leaves` order."""
    if isinstance(node, dict):
        return [n for key in sorted(node) for n in leaf_names(node[key], f"{prefix}/{key}")]
    if isinstance(node, list):
        return [n for i, item in enumerate(node) for n in leaf_names(item, f"{prefix}[{i}]")]
    return [prefix.lstrip("/")]


def move_outliers(moves, grads, ref_moves, ref_grads, specs, mesh, device, bound,
                  top=3) -> list:
    """Where a gang's moves stray from one process's (`ref_moves`, on rank
    0; None elsewhere) by more than `bound` an entry: leaf by leaf (the tp
    shards gathered, every rank taking part), on rank 0, the entries over
    the bound, the largest |ref gradient| among them (the first step's),
    and the `top` worst entries, each with its index, both moves and both
    first-step gradients; other ranks get []."""
    from jobset_tpu_torch import tree
    from jobset_tpu_torch.parallel import collectives

    def full(leaf, spec):
        dim = spec.index("tp") if "tp" in spec else None
        return collectives.gather(leaf, dim, mesh.group("tp")) if dim is not None else leaf

    out = []
    names = leaf_names(moves)
    pairs = zip(tree.leaves(moves), tree.leaves(grads), tree.leaves(specs))
    for i, (move, grad, spec) in enumerate(pairs):
        move, grad = full(move, spec).float(), full(grad.to(device), spec).float()
        if ref_moves is None:
            continue
        want = tree.leaves(ref_moves)[i].to(device).float()
        want_g = tree.leaves(ref_grads)[i].to(device).float()
        d = (move - want).abs()
        over = d > bound
        worst = torch.topk(d.flatten(), min(top, d.numel())).indices
        out.append({
            "leaf": names[i], "shape": list(move.shape), "over": int(over.sum()),
            "max_ref_grad_over": float(want_g.abs()[over].max()) if bool(over.any()) else None,
            "worst": [{"index": [int(x) for x in np.unravel_index(int(j), tuple(move.shape))],
                       "move": float(move.flatten()[j]), "ref_move": float(want.flatten()[j]),
                       "grad": float(grad.flatten()[j]), "ref_grad": float(want_g.flatten()[j])}
                      for j in worst]})
        del move, grad, want, want_g, d, over
    return out


def gang_rank(spec: dict) -> dict:
    """One rank of phase 15, in a process of its own (`gang.spawn`): the
    transformer spec["cfg"] over the mesh spec["mesh"] from the parameters
    of seed 0 cut to this rank's shards, fed its rows of phase 7's batches:
    one gradient step (its kernel launches counted), GANG_STEPS adam steps
    (peak memory), timed steps (median ms) and one step traced
    (`collective_trace`). Rank 0 holds the gradients and the moves against
    the saved single-process run spec["reference"] (in the gang's layout,
    `pp_view`); with spec["diagnose"],
    where the moves stray (`move_outliers`). spec["device"] is the card
    unless it names the CPU (a rehearsal). Each rank takes its dp rows and
    its sp chunk of positions of every batch. spec["steps"] (default
    GANG_STEPS) adam steps; with spec["draw_on_cpu"] the parameters and
    batches are drawn on CPU generators, so the card's run and the CPU's
    start alike. The constant-mask cache starts empty, so the first step
    counts the run's tile-class passes. Over pp the parameters are drawn
    stacked [pp, n_layers / pp, ...] (the same numbers), and with
    spec["interleave"] = v permuted for the interleave
    (`interleave_stage_params`)."""
    import torch.distributed as dist

    from jobset_tpu_torch import tree
    from jobset_tpu_torch.convert import shard_params
    from jobset_tpu_torch.models import build_train_step, init_params
    from jobset_tpu_torch.models.transformer import param_specs
    from jobset_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from jobset_tpu_torch.parallel.pipeline import interleave_stage_params
    from jobset_tpu_torch.runtime import optim
    from jobset_tpu_torch.runtime.data import sequence_shard
    from jobset_tpu_torch.runtime.runner import batch_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    empty_mask_cache()
    cfg = spec["cfg"]
    device = torch.device(spec.get("device") or f"cuda:{torch.cuda.current_device()}")
    cuda = device.type == "cuda"
    draw = "cpu" if spec.get("draw_on_cpu") else device
    steps = spec.get("steps", GANG_STEPS)
    mesh = build_mesh(MeshConfig(**spec["mesh"]), device, allow_submesh=True)
    if mesh is None:  # a rank past the spec's mesh
        return None
    specs = param_specs(cfg)
    full = init_params(cfg, torch.Generator(device=draw).manual_seed(0), device, mesh.config)
    virtual = spec.get("interleave", 1)
    if virtual > 1:
        full["layers"] = interleave_stage_params(full["layers"], mesh.size("pp"), virtual)
    start = shard_params(full, cfg, mesh)
    del full
    rows = torch.as_tensor(batch_rows(spec["batch"], mesh.size("dp"), mesh.index("dp")),
                           device=device)
    columns = sequence_shard(spec["seq"], mesh.size("sp"), mesh.index("sp"))
    batches = [{k: v.to(device)[rows][:, columns]
                for k, v in token_batch(cfg.vocab_size, spec["batch"], spec["seq"], seed=3 + i,
                                        device=draw).items()}
               for i in range(steps)]
    out = {"rank": mesh.rank, "coords": mesh.coords, "backend": dist.get_backend()}

    grads_opt = grads_optimizer()
    grad_step = build_train_step(cfg, grads_opt, device=device, mesh=mesh)
    sync(device)
    if cuda:
        out["first_held_gb"] = settled_gb()
    reset_moe_launches()
    with counting_saved() as saved:
        same, state, loss = grad_step(start, grads_opt.init(start), batches[0])
    sync(device)
    out["saved_gb"] = saved["bytes"] / 1e9
    out["first_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    del same
    out["launches"] = moe_launches_now()
    out["grad_loss"] = float(loss)
    ref = (torch.load(spec["reference"], map_location="cpu", mmap=True, weights_only=True)
           if mesh.rank == 0 and spec.get("reference") else None)
    if ref is not None and mesh.size("pp") > 1:
        view = pp_view(mesh.size("pp"), virtual)
        ref = dict(ref, **{k: view(ref[k]) for k in ("grads", "moves", "moves1")})
    out["grads"] = gathered_diffs(state["g"], ref["grads"] if ref else None, specs, mesh, device)
    # Kept on the host: the card is full with four f32 ranks.
    grads = tree.tree_map(lambda g: g.cpu(), state["g"]) if spec.get("diagnose") else None
    del state, grad_step

    opt = optim.adam(GANG_LR)
    step = build_train_step(cfg, opt, device=device, mesh=mesh)
    if cuda:
        out["held_gb"] = settled_gb()
    params, opt_state, losses, routes = start, opt.init(start), [], []
    for b in batches:
        with recording_routes(routes) if spec.get("diagnose") else contextlib.nullcontext():
            params, opt_state, loss = step(params, opt_state, b)
        losses.append(float(loss))
        if spec.get("first_move") and "moves1" not in out:
            first = tree.tree_map(lambda a, b: a - b, params, start)
            out["moves1"] = gathered_diffs(first, ref["moves1"] if ref else None, specs, mesh,
                                           device, ref["grads"] if ref else None,
                                           0.05 * GANG_LR)
            if spec.get("diagnose"):
                out["move1_outliers"] = move_outliers(
                    first, grads, ref["moves1"] if ref else None, ref["grads"] if ref else None,
                    specs, mesh, device, 0.05 * GANG_LR)
            del first
            if cuda:  # the peak of the steps, not of the gathers
                torch.cuda.reset_peak_memory_stats()
    out["losses"] = losses
    moves = tree.tree_map(lambda a, b: a - b, params, start)
    del start
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    out["moves"] = gathered_diffs(moves, ref["moves"] if ref else None, specs, mesh, device)
    if spec.get("diagnose"):
        out["move_outliers"] = move_outliers(
            moves, grads, ref["moves"] if ref else None, ref["grads"] if ref else None, specs,
            mesh, device, 0.05 * GANG_LR * GANG_STEPS)
        if ref is not None and ref["routes"]:
            out["route_flips"] = route_flips(routes, ref["routes"], rows.cpu(), spec["seq"],
                                             len(routes) // GANG_STEPS)
    del moves, ref, grads
    if not spec.get("timed", True):
        return out

    times = []
    for i in range(GANG_WARMUP + GANG_TIMED):
        sync(device)
        t0 = time.perf_counter()
        params, opt_state, _ = step(params, opt_state, batches[-1])
        sync(device)
        if i >= GANG_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = float(np.median(times))
    out["step_ms_range"] = (min(times), max(times))

    from torch.profiler import ProfilerActivity, profile, record_function

    # Two steps under the profiler, the second kept: the first takes the
    # profiler's start-up, the ranks' included.
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kept = []
    sync(device)
    with profile(activities=activities,
                 schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(list(p.events()))) as prof:
        for _ in range(2):
            with record_function(GANG_STEP_RANGE):
                params, opt_state, _ = step(params, opt_state, batches[-1])
                sync(device)
            prof.step()
    out.update(collective_trace(kept[0]))
    return out


@contextlib.contextmanager
def counting_saved():
    """While active, the bytes of the distinct storages autograd saves for
    the backward (`saved_tensors_hooks`), under "bytes"."""
    seen, count = set(), {"bytes": 0}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            count["bytes"] += storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield count


# The range that marks the traced step of a gang rank.
GANG_STEP_RANGE = "gang train step"


# The collectives' names in a trace: c10d's entries and gloo's own ranges.
COLLECTIVE_OPS = ("all_reduce", "allreduce", "all_to_all", "alltoall")


def collective_trace(events, range_name=GANG_STEP_RANGE) -> dict:
    """From a torch.profiler trace of one gang step (no synchronization in
    it but the one that closes the step): the step's span (its
    GANG_STEP_RANGE), the union of the collective ops' host spans within
    it (all-reduce and all-to-all: c10d's entries on the calling thread and
    the backend's own ranges, gloo's "gloo:all_reduce" from when its
    thread takes the op to the op's end, which for CUDA tensors includes
    waiting for the device to finish the input and the copies through the
    host), the collective calls, and
    the union of the device ops' spans within the step (None on the CPU or
    where the trace holds none)."""
    from torch.autograd import DeviceType

    events = list(events)
    (window,) = [e for e in events if e.name == range_name
                 and e.device_type != DeviceType.CUDA]
    start, end = window.time_range.start, window.time_range.end

    def clipped(es):
        return [(max(e.time_range.start, start), min(e.time_range.end, end)) for e in es
                if e.time_range.end > start and e.time_range.start < end]

    host = [e for e in events if e.device_type != DeviceType.CUDA]
    reduces = [e for e in host if any(op in e.name for op in COLLECTIVE_OPS)]
    device_ops = [e for e in events if e.device_type == DeviceType.CUDA]
    span = end - start
    spent = merged_span_us(clipped(reduces))
    busy = merged_span_us(clipped(device_ops)) if device_ops else None
    out = {"traced_step_ms": span / 1e3, "collective_ms": spent / 1e3,
           "collective_calls": sum(1 for e in reduces if e.name.startswith("c10d::")),
           "collective_share": spent / span,
           "device_busy_share": None if busy is None else busy / span}
    # By kind: the all-to-alls (the pipeline's shifts, the ring's rotations,
    # Ulysses' re-splits, the gathers) and the all-reduces.
    for kind, ops in (("all_to_all", ("all_to_all", "alltoall")),
                      ("all_reduce", ("all_reduce", "allreduce"))):
        mine = [e for e in reduces if any(op in e.name for op in ops)]
        ms = merged_span_us(clipped(mine)) / 1e3
        out[f"{kind}_ms"], out[f"{kind}_share"] = ms, ms * 1e3 / span
        out[f"{kind}_calls"] = sum(1 for e in mine if e.name.startswith("c10d::"))
    return out


def gang_print(label, ranks, card):
    for r in ranks:
        if "step_ms" not in r:
            continue
        counts = r["launches"]
        peak = ("not measured" if r["peak_gb"] is None else
                f"{r['peak_gb']:.2f} GB ({r['peak_gb'] - r['held_gb']:.2f} over the "
                f"{r['held_gb']:.2f} GB it held before the steps)")
        busy = ("not measured" if r["device_busy_share"] is None
                else f"{r['device_busy_share']:.1%}")
        print(f"  {label} rank {r['rank']} {r['coords']} ({r['backend']}): one step launches "
              f"flash bf16 {counts['TENSOR_CORE_LAUNCHES']}, f32 {counts['F32_LAUNCHES']}, "
              f"tile-class {counts['TILE_CLASS_LAUNCHES']}, flash backward "
              f"{counts['BACKWARD_LAUNCHES']} (f32 by variant {f32_backward_by_variant(counts)}); "
              f"grouped fwd "
              f"{counts['GROUPED_LAUNCHES']} (TMA {counts['GROUPED_TMA_LAUNCHES']}, f32 "
              f"{counts['GROUPED_F32_LAUNCHES']}), dgrad {counts['GROUPED_DGRAD_LAUNCHES']}, "
              f"wgrad {counts['GROUPED_WGRAD_LAUNCHES']} (TMA {counts['GROUPED_WGRAD_TMA_LAUNCHES']}"
              f", f32 TMA {counts['GROUPED_WGRAD_F32_TMA_LAUNCHES']}); step median "
              f"{r['step_ms']:.3f} ms ({r['step_ms_range'][0]:.3f}-{r['step_ms_range'][1]:.3f}), "
              f"peak memory {peak}; first step: saved for the backward {r['saved_gb']:.2f} GB, "
              f"peak {r['first_peak_gb'] - r['first_held_gb']:.2f} GB over what it held; traced step {r['traced_step_ms']:.3f} ms: collective ops' "
              f"host spans {r['collective_ms']:.3f} ms in {r['collective_calls']} collectives = "
              f"{r['collective_share']:.1%} of it, device busy {busy} (torch.profiler; ranks "
              f"sharing one card; gloo stages CUDA tensors through the host: no scaling "
              f"figure; {card})", flush=True)


def gang_check(label, ranks, ref, loss_rel, grad_rel, move_rel=None, f32_moves=False,
               first_move=False):
    """Rank 0's gradients, losses and moves against the single-process run;
    every rank's losses alike; with first_move, the moves of the first adam
    step held entry by entry and those of all GANG_STEPS printed. Returns
    the worst relative differences."""
    first = ranks[0]
    loss_d = max([abs(first["grad_loss"] - ref["grad_loss"]) / abs(ref["grad_loss"])]
                 + [abs(a - b) / abs(b) for a, b in zip(first["losses"], ref["losses"])])
    grad_d = max(rel for rel, _, _ in first["grads"])
    check(all(r["losses"] == first["losses"] and r["grad_loss"] == first["grad_loss"]
              for r in ranks), f"{label}: every rank reports the same global losses")
    check(loss_d <= loss_rel, f"{label}: losses {first['losses']} vs one process's "
          f"{ref['losses']} (worst {loss_d:.2e}, bound {loss_rel})")
    if grad_rel is None:
        move_d = max(rel for rel, _, _ in first["moves"])
        print(f"  {label}: gradient leaves {grad_d:.2e} and {GANG_STEPS} adam steps' moves "
              f"{move_d:.2e} from one process's in relative norm at worst (information: bf16 "
              "routes apart end to end; the f32 run below holds them)", flush=True)
        return {"loss_rel": loss_d, "grad_rel": grad_d, "move": move_d}
    check(grad_d <= grad_rel, f"{label}: each gradient leaf within {grad_rel} of one process's "
          f"in relative norm (worst {grad_d:.2e} over {len(first['grads'])} leaves)")
    if first_move:
        move_d = max(held for _, _, _, held, _ in first["moves1"])
        noise = sum(n for _, _, _, _, n in first["moves1"])
        check(move_d <= 0.05 * GANG_LR, f"{label}: the first adam step's move of each parameter "
              f"whose first-step gradient exceeds {ADAM_NOISE_GRAD:.0e} within 0.05 * lr of one "
              f"process's (worst {move_d:.2e}; past that bound at or below it, where the move "
              f"is the gradient's rounding over eps: {noise} entries)")
        steps_d = max(rel for rel, _, _ in first["moves"])
        print(f"  {label}: each leaf's move over {GANG_STEPS} adam steps {steps_d:.2e} from one "
              "process's in relative norm at worst (information: see the entries below)",
              flush=True)
    elif f32_moves:
        ok = all(d <= 0.05 * GANG_LR * GANG_STEPS for _, d, _ in first["moves"])
        move_d = max(d for _, d, _ in first["moves"])
        check(ok, f"{label}: each parameter's move within 0.05 * lr a step of one process's "
              f"(worst {move_d:.2e})")
    else:
        move_d = max(rel for rel, _, _ in first["moves"])
        check(move_d <= move_rel, f"{label}: each leaf's move over {GANG_STEPS} adam steps "
              f"within {move_rel} of one process's in relative norm (worst {move_d:.2e})")
    return {"loss_rel": loss_d, "grad_rel": grad_d, "move": move_d}


def gang_runner_sequence(device, backend) -> dict:
    """lm-moe-dropless.yaml's payload through the port's `WorkloadRunner` on
    `device`, over `StandInCluster` (2 jobs of 2 pods): 4 worker processes
    on `backend`; the annotations, the terminal state and each rank's
    result line."""
    from jobset_tpu_torch.runtime import WorkloadRunner

    replicas, pods = LM_MOE_DROPLESS_GANG
    cluster = StandInCluster("lm-moe-dropless", dict(LM_MOE_DROPLESS_PAYLOAD), replicas=replicas,
                             parallelism=pods)
    runner = WorkloadRunner(cluster, device, backend=backend)
    t0 = time.perf_counter()
    ran = runner.run_pending()
    return {"ran": ran, "seconds": time.perf_counter() - t0,
            "terminal_state": cluster.js.status.terminal_state,
            "annotations": dict(cluster.js.metadata.annotations),
            "results": runner.last_gang_results}


def gang_moe_f32_spec(batch, path) -> dict:
    """The `gang_rank` spec of (c)'s gang in f32 at `batch`, held to the
    single-process run saved at `path`."""
    from dataclasses import replace

    moe32 = replace(moe_config(), dtype=torch.float32, n_layers=GANG_MOE_LAYERS)
    return {"cfg": moe32, "mesh": {"dp": 2, "tp": 2}, "batch": batch, "seq": PROMPT,
            "reference": path, "timed": False, "diagnose": True, "first_move": True}


def gang_moe_f32(tmp, batch, card, ranks=None, ref=None) -> dict:
    """(c)'s gang in f32 (TF32 off), where the first step routes as one
    process does: its losses, gradients and first adam step held to one
    process's, and where the moves of all GANG_STEPS stray printed
    (`move_outliers`); each rank's peak memory beside the single
    process's; no timing. `ranks` and `ref`: the gang's results and the
    single-process run (saved at tmp/moe32.pt), both taken here when not
    given."""
    from jobset_tpu_torch.runtime import gang

    t0 = time.perf_counter()
    spec = gang_moe_f32_spec(batch, os.path.join(tmp, "moe32.pt"))
    if ranks is None:
        ref = reference_apart(spec["cfg"], batch, PROMPT, spec["reference"], first_move=True)
        ranks = gang.spawn(gang_rank, 4, (spec,), backend="gloo", device="cuda",
                           timeout_s=GANG_TIMEOUT_S, threads=0)
    print(f"  gang (c) f32 B={batch}: peak memory by rank "
          f"{[round(r['peak_gb'], 2) for r in ranks]} GB, {sum(r['peak_gb'] for r in ranks):.2f} "
          f"GB together; the single process's {ref['peak_gb']:.2f} GB ({card})", flush=True)
    for key, steps in (("move1_outliers", 1), ("move_outliers", GANG_STEPS)):
        for row in ranks[0][key]:
            if row["over"]:
                print(f"  gang (c) f32 moves over {steps} adam step(s) past "
                      f"{0.05 * GANG_LR * steps:.1e} an entry: {row['leaf']} {row['shape']}: "
                      f"{row['over']} entries, largest |first-step gradient| among them "
                      f"{row['max_ref_grad_over']}; worst {row['worst']}", flush=True)
    print(f"  gang (c) f32: of rank 0's {batch // 2 * PROMPT} tokens, those that took other "
          f"experts than in one process's run, summed over the {GANG_MOE_LAYERS} layers, by adam "
          f"step: "
          f"{ranks[0]['route_flips']}", flush=True)
    worst = gang_check(f"gang (c) MoE flagship dp=2 x tp=2 in f32, B={batch} T={PROMPT}", ranks,
                       ref, GANG_F32_REL, GANG_F32_MOE_GRAD_REL, first_move=True)
    check(all(r["launches"]["GROUPED_F32_LAUNCHES"] == 2 * GANG_MOE_LAYERS for r in ranks),
          f"gang (c) f32: {2 * GANG_MOE_LAYERS} f32 grouped forward launches a step on each rank")
    return {"ranks": ranks, "reference": ref, "worst": worst,
            "seconds": time.perf_counter() - t0}


def phase_gang(results):
    """Phase 15: gangs of processes on the card through `torch.distributed`
    (each rank a process; the card holds them all)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from dataclasses import replace

    from jobset_tpu_torch.runtime import gang

    card = results["card"]
    gang_results: dict = {}
    dense, small = replace(flagship_config(), n_layers=GANG_DENSE_LAYERS), gang_small_config()
    moe = replace(moe_config(), n_layers=GANG_MOE_LAYERS)
    # Up to four ranks share the card: their allocators grow segments
    # instead of caching fragments of each rank's peak (the ranks read it
    # when they start; this process's allocator is already set).
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    gang_results["local_kernels"] = gang_kernel_checks()
    with tempfile.TemporaryDirectory() as tmp:
        # The single-process runs (a)-(c) are held to, in one process.
        t0 = time.perf_counter()
        paths = {key: os.path.join(tmp, f"{key}.pt")
                 for key in ("dense", "small", "moe", "moe32")}
        jobs = [dict(cfg=dense, batch=BATCH, seq=PROMPT, path=paths["dense"]),
                dict(cfg=small, batch=4, seq=64, path=paths["small"]),
                dict(cfg=moe, batch=BATCH, seq=PROMPT, path=paths["moe"]),
                dict(cfg=replace(moe, dtype=torch.float32), batch=GANG_F32_MOE_BATCH,
                     seq=PROMPT, path=paths["moe32"], first_move=True)]
        # (a) NCCL at world 1, in the same process after the references:
        # the gang path equals phase 7's step.
        spec = {"cfg": dense, "mesh": {}, "batch": BATCH, "seq": PROMPT,
                "reference": paths["dense"]}
        ((ref_list, one),) = gang.spawn(references_and_rank, 1, (jobs, spec), backend="nccl",
                                        device="cuda", timeout_s=GANG_TIMEOUT_S, threads=0)
        refs = dict(zip(paths, ref_list))
        gang_results["references_s"] = time.perf_counter() - t0
        ref = refs["dense"]
        check(one["backend"] == "nccl" and one["grad_loss"] == ref["grad_loss"]
              and one["losses"] == ref["losses"]
              and all(d == 0.0 for _, d, _ in one["grads"] + one["moves"]),
              f"gang (a) NCCL at world 1, dense flagship ({GANG_DENSE_LAYERS} layers) B={BATCH} T={PROMPT}: loss, gradients "
              f"and {GANG_STEPS} adam steps' moves equal the single-process step bit for bit "
              f"(worst max|d| {max(d for _, d, _ in one['grads'] + one['moves'])})")
        gang_print("gang (a)", [one], card)
        gang_results["nccl_world1"] = {"rank": one, "reference": ref}

        # (b) the dense flagship at tp 2 (ranks 0 and 1), (c) the MoE
        # flagship at dp 2 x tp 2 and its f32 run, one gang of four on the
        # card (NCCL refuses two ranks on one device, so they run gloo on
        # CUDA tensors), beside a small f32 config at tp 2 (TF32 off) and
        # (d) lm-moe-dropless.yaml through WorkloadRunner, the card's gang
        # against the CPU's (f32 payload; rtol WORKLOAD_F32_REL): the step
        # times beside theirs, no scaling figure either way.
        t0 = time.perf_counter()
        specs = [dict(spec, mesh={"tp": 2}),
                 {"cfg": moe, "mesh": {"dp": 2, "tp": 2}, "batch": BATCH, "seq": PROMPT,
                  "reference": paths["moe"]},
                 gang_moe_f32_spec(GANG_F32_MOE_BATCH, paths["moe32"])]
        small_spec = {"cfg": small, "mesh": {"tp": 2}, "batch": 4, "seq": 64,
                      "reference": paths["small"]}
        with ThreadPoolExecutor(3) as pool:
            small_ranks = pool.submit(gang.spawn, gang_rank, 2, (small_spec,), backend="gloo",
                                      device="cuda", timeout_s=GANG_TIMEOUT_S, threads=0)
            runs = [pool.submit(gang_runner_sequence, device, "gloo")
                    for device in ("cuda", "cpu")]
            by_rank = gang.spawn(gang_ranks, 4, (specs,), backend="gloo", device="cuda",
                                 timeout_s=GANG_TIMEOUT_S, threads=0)
            gang_results["gang_s"] = time.perf_counter() - t0
            small_ranks = small_ranks.result()
            card_run, cpu_run = (run.result() for run in runs)
        gang_results["beside_s"] = time.perf_counter() - t0
        ranks = [r[0] for r in by_rank[:2]]
        gang_print("gang (b)", ranks, card)
        worst = gang_check(f"gang (b) dense flagship ({GANG_DENSE_LAYERS} layers) tp=2 (8 heads of 64 a rank), B={BATCH} "
                           f"T={PROMPT} bf16", ranks, ref, GANG_BF16_LOSS_REL,
                           GANG_BF16_GRAD_REL, GANG_BF16_MOVE_REL)
        for r in ranks:
            check(r["launches"]["TENSOR_CORE_LAUNCHES"] == GANG_DENSE_LAYERS
                  and r["launches"]["KERNEL_LAUNCHES"] == GANG_DENSE_LAYERS
                  and r["launches"]["F32_LAUNCHES"] == 0,
                  f"gang (b) rank {r['rank']}: {GANG_DENSE_LAYERS} bf16 flash launches a step, on the "
                  f"tensor-core variant ({r['launches']['TENSOR_CORE_LAUNCHES']})")
        gang_results["dense_tp2"] = {"ranks": ranks, "reference": ref, "worst": worst}

        ref = refs["moe"]
        ranks = [r[1] for r in by_rank]
        gang_print("gang (c)", ranks, card)
        worst = gang_check(f"gang (c) MoE flagship dp=2 x tp=2 ({MOE_EXPERTS} experts, "
                           f"we1 [8, 1024, {MOE_D_FF // 2}] a rank), B={BATCH} T={PROMPT} bf16",
                           ranks, ref, GANG_BF16_LOSS_REL, None)
        for r in ranks:
            c = r["launches"]
            n = GANG_MOE_LAYERS
            check(c["GROUPED_LAUNCHES"] == c["GROUPED_TMA_LAUNCHES"] == 2 * n
                  and c["GROUPED_DGRAD_LAUNCHES"] == 2 * n
                  and c["GROUPED_WGRAD_LAUNCHES"] == c["GROUPED_WGRAD_TMA_LAUNCHES"] == 2 * n
                  and c["TENSOR_CORE_LAUNCHES"] == n,
                  f"gang (c) rank {r['rank']}: a step launches {2 * n} grouped forward "
                  f"(all TMA), dgrad and wgrad (all TMA) kernels and {n} flash kernels ({c})")
        gang_results["moe_dp2_tp2"] = {"ranks": ranks, "reference": ref, "worst": worst}

        gang_results["moe_dp2_tp2_f32"] = gang_moe_f32(
            tmp, GANG_F32_MOE_BATCH, card, [r[2] for r in by_rank], refs["moe32"])

        ref, ranks = refs["small"], small_ranks
        gang_print("gang small f32", ranks, card)
        worst = gang_check("gang small f32 config tp=2 (TF32 off)", ranks, ref, GANG_F32_REL,
                           GANG_F32_REL, f32_moves=True)
        check(all(r["launches"]["F32_LAUNCHES"] == small.n_layers for r in ranks),
              f"gang small f32: {small.n_layers} f32 flash launches a step on each rank")
        gang_results["small_f32_tp2"] = {"ranks": ranks, "reference": ref, "worst": worst}

    # (d) against the CPU gang.
    final = float(card_run["annotations"].get("tpu.jobset.x-k8s.io/final-loss", "nan"))
    want = float(cpu_run["annotations"].get("tpu.jobset.x-k8s.io/final-loss", "nan"))
    check(card_run["terminal_state"] == "Completed" == cpu_run["terminal_state"]
          and len(card_run["results"] or []) == 4
          and abs(final - want) <= WORKLOAD_F32_REL * abs(want) + 1e-6,
          f"gang (d) lm-moe-dropless.yaml through WorkloadRunner as 4 processes on the card: "
          f"{card_run['terminal_state']} in {card_run['seconds']:.1f} s, final loss {final} vs "
          f"the CPU gang's {want}")
    for line in card_run["results"] or []:
        print(f"  gang (d) rank {line['process_id']}: mesh {line['mesh']}, kernel launches "
              f"{line['kernel_launches']}", flush=True)
    gang_results["workload_runner"] = {"card": card_run, "cpu": cpu_run}
    results["gang"] = gang_results


def gang_launches(results) -> dict:
    """The gang path's launches of each kernel entry: rank 0's step in (b)
    (flash), the small f32 run (f32 flash), (c) (bf16 grouped) and its f32
    run, and the whole run of (d) (f32 flash and grouped)."""
    g = results.get("gang") or {}

    def first(key):
        ranks = (g.get(key) or {}).get("ranks") or [{}]
        return ranks[0].get("launches") or {}

    runner_lines = ((g.get("workload_runner") or {}).get("card") or {}).get("results") or [{}]
    whole = runner_lines[0].get("kernel_launches") or {}
    b, small, c = first("dense_tp2"), first("small_f32_tp2"), first("moe_dp2_tp2")
    c32 = first("moe_dp2_tp2_f32")
    return {
        "flash_block": {"dense tp=2 step": b.get("TENSOR_CORE_LAUNCHES"),
                        "MoE dp=2 x tp=2 step": c.get("TENSOR_CORE_LAUNCHES")},
        "flash_block_f32": {"small f32 tp=2 step": small.get("F32_LAUNCHES"),
                            "lm-moe-dropless.yaml run, rank 0": whole.get("F32_LAUNCHES")},
        "flash_block_tile_classes": {"dense tp=2 step": b.get("TILE_CLASS_LAUNCHES")},
        "flash_block_backward": {"dense tp=2 step": b.get("BACKWARD_LAUNCHES"),
                                 "MoE dp=2 x tp=2 step": c.get("BACKWARD_LAUNCHES")},
        "flash_block_backward_f32": {"small f32 tp=2 step": f32_backward_by_variant(small),
                                     "MoE f32 dp=2 x tp=2 step": f32_backward_by_variant(c32),
                                     "lm-moe-dropless.yaml run, rank 0":
                                         f32_backward_by_variant(whole)},
        "grouped_matmul": {"MoE dp=2 x tp=2 step": c.get("GROUPED_LAUNCHES")},
        "grouped_matmul_dgrad": {"MoE dp=2 x tp=2 step": c.get("GROUPED_DGRAD_LAUNCHES")},
        "grouped_matmul_wgrad": {"MoE dp=2 x tp=2 step": c.get("GROUPED_WGRAD_LAUNCHES")},
        "grouped_matmul_f32": {"MoE f32 dp=2 x tp=2 step": c32.get("GROUPED_F32_LAUNCHES"),
                               "lm-moe-dropless.yaml run, rank 0": whole.get(
                                   "GROUPED_F32_LAUNCHES")},
        "grouped_matmul_dgrad_f32": {"MoE f32 dp=2 x tp=2 step": c32.get(
            "GROUPED_DGRAD_F32_LAUNCHES"), "lm-moe-dropless.yaml run, rank 0": whole.get(
            "GROUPED_DGRAD_LAUNCHES")},
        "grouped_matmul_wgrad_f32": {"MoE f32 dp=2 x tp=2 step": c32.get(
            "GROUPED_WGRAD_F32_LAUNCHES"), "lm-moe-dropless.yaml run, rank 0": whole.get(
            "GROUPED_WGRAD_F32_LAUNCHES")},
    }


def phase_gang_apart(results):
    """Phase 15 in a process of its own (`--gang-only`), this process's
    cached blocks handed back to the card first: up to four ranks share it
    with this process."""
    import tempfile

    torch.cuda.empty_cache()
    print(f"phase 15: this process holds {torch.cuda.memory_allocated() / 1e9:.2f} GB of the "
          f"card ({torch.cuda.memory_reserved() / 1e9:.2f} GB reserved)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gang.json")
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--gang-only",
                              "--out", path], capture_output=True, text=True, timeout=1000)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 15 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return
        with open(path) as f:
            results["gang"] = json.load(f).get("gang")

# ---------------------------------------------------------------------------
# Phase 16: sequence parallelism (ring and Ulysses) and ZeRO-1
# ---------------------------------------------------------------------------

# A rank's ring block of the flagship at sp = 2: [B, T/sp, H, D].
SP, SP_BLOCK = 2, (BATCH, PROMPT // 2, 16, 64)
# Flash launches of a rank's step at sp = 2, remat off: the ring folds sp
# blocks a layer (the diagonal, then the block of the other chunk: zeros
# on rank 1, fully masked on rank 0); Ulysses folds the causal chunk pairs
# of the whole sequence on H/sp heads, sp(sp+1)/2 a layer. On the first
# step each builds two constant masks at [T/sp, T/sp] (the diagonal, and
# the masked or zero block), each with its one tile-class pass.
SP_RING_LAUNCHES, SP_ULYSSES_LAUNCHES, SP_FIRST_PASSES = SP * SP_LAYERS, 3 * SP_LAYERS, 2
# A block merged into an accumulator and differentiated, kernel against
# plain version: gradient leaves in relative norm, bf16 at phase 7's
# bound (p rounded to bf16 against another max), f32 (3xTF32 forward, f32
# backward with TF32 off) at 1e-4.
SP_BLOCK_GRAD_REL = {torch.bfloat16: TRAIN_GRAD_REL, torch.float32: 1e-4}
# (d): the dense flagship at one sequence of 8192 tokens, 2 adam steps.
LONG_SEQ, LONG_STEPS = 8192, 2
# ZeRO-1's adafactor against the run without it: each leaf within 1e-6 of
# its largest entry (block RMSs summed over dp in another order).
ZERO_ADAFACTOR_REL = 1e-6
# examples/training/lm-adafactor.yaml and lm-long-context.yaml's payloads
# (held to the files by tests/test_torch_gang_runner.py) and their gangs
# (replicas, pods a job); each runs as one worker process a device of its
# mesh.
LM_ADAFACTOR_PAYLOAD = {
    "kind": "lm", "steps": 8, "batch_size": 4, "seq_len": 16, "optimizer": "adafactor",
    "zero1": True, "lr_schedule": "cosine", "warmup_steps": 2,
    "config": {"vocab_size": 128, "d_model": 64, "n_heads": 4, "d_ff": 128, "n_layers": 2,
               "max_seq_len": 32, "remat": True, "remat_policy": "dots"},
    "mesh": {"dp": 2}}
LM_LONG_CONTEXT_PAYLOAD = {
    "kind": "lm", "steps": 8, "batch_size": 4, "seq_len": 32, "eval_every": 4,
    "mesh": {"sp": 2, "tp": 2},
    "config": {"vocab_size": 128, "d_model": 64, "n_heads": 8, "n_kv_heads": 4, "d_ff": 128,
               "n_layers": 2, "max_seq_len": 64, "attn_impl": "ulysses"}}
SP_EXAMPLES = {"lm-adafactor": (LM_ADAFACTOR_PAYLOAD, (2, 2)),
               "lm-long-context": (LM_LONG_CONTEXT_PAYLOAD, (4, 1))}


def rel_norm(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def sp_block_case(dtype, kind, seed) -> dict:
    """A ring step's block at [8, 512, 16, 64] under the constant mask
    `kind` ("causal", "zero", "masked"), as the ring hands it to the kernel
    (classes given), against the plain version on the same inputs: the
    raw outputs (not for "masked", whose block the merge drops), then the
    block merged into a real accumulator (the diagonal block of the same q
    against other keys, as a rank's ring folds it first), normalized, and
    the gradients of sum(out * w) for q, k and v. The masked block must
    leave the accumulator as it was, bit for bit, and give k and v zero
    gradients."""
    from jobset_tpu_torch.ops import flash_block as fb

    gen = torch.Generator(device="cuda").manual_seed(seed)
    inputs = [torch.randn(SP_BLOCK, generator=gen, device="cuda").to(dtype) for _ in range(5)]
    w = torch.randn(SP_BLOCK, generator=gen, device="cuda")
    t = SP_BLOCK[1]
    bias, classes = fb.constant_mask(kind, t, t, inputs[0].device)
    diag, diag_classes = fb.constant_mask("causal", t, t, inputs[0].device)
    name = f"ring block {'bf16' if dtype == torch.bfloat16 else 'f32'} {kind} {list(SP_BLOCK)}"
    check(torch.equal(classes, fb.tile_classes_reference(bias)),
          f"{name}: the mask's tile classes equal the plain version's")

    def run(block):
        q, k, v, k0, v0 = (x.detach().requires_grad_() for x in inputs)
        acc = block(q, k0, v0, diag, diag_classes)
        blk = block(q, k, v, bias, classes)
        merged = fb.merge_block_stats(acc, blk)
        out = fb.normalize_block_stats(merged[1], merged[2])
        (out * w).sum().backward()
        alone = fb.normalize_block_stats(acc[1], acc[2])
        return [x.detach() for x in blk], out.detach(), alone.detach(), [q.grad, k.grad, v.grad]

    counter = "TENSOR_CORE_LAUNCHES" if dtype == torch.bfloat16 else "F32_LAUNCHES"
    before = launches_now()[counter]
    blk, out, alone, grads = run(lambda q, k, v, b, c: fb.block_attention(q, k, v, b, classes=c))
    torch.cuda.synchronize()
    launches = launches_now()[counter] - before
    check(launches == 2, f"{name}: the diagonal and the block each launch the {counter} variant "
          f"once ({launches})")
    if dtype == torch.float32:
        plain_is_f32(name)
    with plain_attention():
        p_blk, p_out, _, p_grads = run(
            lambda q, k, v, b, c: fb.block_attention(q, k, v, b, classes=c))
    errs = {}
    if kind == "masked":
        check(bool((blk[1] == 0).all() and (blk[2] == 0).all()
                   and (blk[0] <= fb.NEG_INF / 2).all()),
              f"{name}: the kernel skips every tile: max ~NEG_INF, sum 0, weighted 0")
        check(torch.equal(out, alone) and all(bool((g == 0).all()) for g in grads[1:]),
              f"{name}: merged into the accumulator it leaves it as it was, bit for bit, and "
              f"gives k and v zero gradients")
    else:
        for label, g, want in zip(("max", "sum", "weighted"), blk, p_blk):
            rtol, atol = KERNEL_TOL[dtype][label]
            errs[label] = max_abs(g, want)
            limit = atol + rtol * want.abs().max().item()
            check(errs[label] <= limit, f"{name}: {label} max|d|={errs[label]:.3e} <= "
                  f"{limit:.3e}")
    rtol, atol = KERNEL_TOL[dtype]["weighted"]
    errs["merged"] = max_abs(out, p_out)
    limit = atol + rtol * p_out.abs().max().item()
    check(bool(torch.isfinite(out).all()) and errs["merged"] <= limit,
          f"{name}: merged and normalized, max|d|={errs['merged']:.3e} <= {limit:.3e}")
    grad_rels = [rel_norm(g, want) for g, want in zip(grads, p_grads) if want.norm() > 0]
    errs["grad_rel"] = max(grad_rels)
    check(errs["grad_rel"] <= SP_BLOCK_GRAD_REL[dtype],
          f"{name}: dq, dk, dv through the merge within {SP_BLOCK_GRAD_REL[dtype]} of the plain "
          f"version's in relative norm (worst {errs['grad_rel']:.3e})")
    print(f"{name}: {errs}", flush=True)
    return {"launches": launches, "errs": errs}


def sp_kernel_checks() -> dict:
    """(a): the kernel at the ring's blocks, bf16 and f32, each mask kind."""
    out, seed = {}, 700
    for dtype in (torch.bfloat16, torch.float32):
        for kind in ("causal", "zero", "masked"):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            out[f"{tag} {kind}"] = sp_block_case(dtype, kind, seed)
            seed += 1
    torch.cuda.empty_cache()
    return out


def gang_ranks(specs: list) -> list:
    """`gang_rank` of each spec in turn on this rank, the card's cached
    blocks handed back between them."""
    out = []
    for spec in specs:
        out.append(gang_rank(spec))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


def settled_gb() -> float:
    """What this process holds on the card once its garbage is collected
    and its streams are done (GB), the peak counter reset to it: the
    baseline a run's peak memory is read against."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def state_bytes_of(state) -> int:
    from jobset_tpu_torch import tree

    return sum(t.numel() * t.element_size() for t in tree.leaves(state) if torch.is_tensor(t))


def zero_rank(cfg, batch, seq) -> dict:
    """One rank of (c), in a process of its own: the dense flagship at dp 2
    from the parameters of seed 0 on phase 7's batches (this rank's rows),
    GANG_STEPS steps under adam and under adafactor, each with and without
    ZeRO-1 (`optim.zero1`): the losses, the parameters' largest
    difference a leaf (adam: whether every leaf is equal bit for bit), the
    optimizer state's bytes on this rank, and its peak memory."""
    from jobset_tpu_torch import tree
    from jobset_tpu_torch.models import build_train_step, init_params
    from jobset_tpu_torch.models.transformer import param_specs
    from jobset_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from jobset_tpu_torch.runtime import optim
    from jobset_tpu_torch.runtime.runner import batch_rows

    device = torch.device(f"cuda:{torch.cuda.current_device()}")
    mesh = build_mesh(MeshConfig(dp=2), device)
    specs = param_specs(cfg)
    start = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    rows = torch.as_tensor(batch_rows(batch, 2, mesh.index("dp")), device=device)
    batches = [{k: v[rows] for k, v in token_batch(cfg.vocab_size, batch, seq, seed=3 + i,
                                                   device=device).items()}
               for i in range(GANG_STEPS)]
    makers = {"adam": lambda: optim.adam(GANG_LR),
              "adafactor": lambda: optim.adafactor(GANG_LR, specs, None)}
    out = {"rank": mesh.rank}
    for name, make in makers.items():
        finals = {}
        for zero1 in (False, True):
            opt = optim.zero1(make(), specs, mesh) if zero1 else make()
            held = settled_gb() * 1e9
            state = opt.init(start)
            step = build_train_step(cfg, opt, device=device, mesh=mesh)
            params, losses = start, []
            for b in batches:
                params, state, loss = step(params, state, b)
                losses.append(float(loss))
            torch.cuda.synchronize()
            out[f"{name} {'zero1' if zero1 else 'plain'}"] = {
                "losses": losses, "state_bytes": state_bytes_of(state),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "peak_over_held_gb": (torch.cuda.max_memory_allocated() - held) / 1e9}
            finals[zero1] = params
            del state, step, params
        pairs = list(zip(tree.leaves(finals[True]), tree.leaves(finals[False])))
        out[f"{name} equal"] = all(torch.equal(a, b) for a, b in pairs)
        out[f"{name} worst_rel"] = max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs)
        del finals, pairs
        torch.cuda.empty_cache()
    return out


def gloo_cuda_probe(which: str) -> dict:
    """On each rank of a gang of 2 on gloo, CUDA tensors: `which`
    "collectives" runs the port's `gather` (dim 1), `rotate` and
    `all_to_all` (split dim 2, concat dim 1), built on gloo's
    `all_to_all_single`, in f32 and bf16, each result held bit for bit
    against the one this rank builds from every rank's known input;
    "send_recv" a pair (its wait bounded by 20 s), which the port does not
    use. For each, "ran, right", "ran, wrong result" or the error it
    raised."""
    from datetime import timedelta

    import torch.distributed as dist

    from jobset_tpu_torch.parallel import collectives

    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device(f"cuda:{torch.cuda.current_device()}")
    group = dist.group.WORLD
    out = {}

    def attempt(name, fn):
        try:
            out[name] = "ran, right" if fn() else "ran, wrong result"
        except Exception as exc:  # the probe's finding is the refusal
            out[name] = f"raised {type(exc).__name__}: {str(exc).splitlines()[0][:160]}"

    def of(r, dtype):
        base = torch.arange(2 * 8 * 4 * 64, dtype=torch.float32).reshape(2, 8, 4, 64)
        return (base % 251 + 256 * r).to(dtype)

    def moved(dtype):
        x = of(rank, dtype).to(device)
        want = {"gather": torch.cat([of(r, dtype) for r in range(world)], dim=1),
                "rotate": of((rank - 1) % world, dtype),
                "all_to_all": torch.cat([of(r, dtype).chunk(world, 2)[rank]
                                         for r in range(world)], dim=1)}
        got = {"gather": collectives.gather(x, 1, group),
               "rotate": collectives.rotate(x, group),
               "all_to_all": collectives.all_to_all(x, 2, 1, group)}
        return all(got[k].is_cuda and got[k].dtype == dtype
                   and torch.equal(got[k].cpu(), want[k]) for k in want)

    def send_recv():
        x = torch.arange(4, dtype=torch.float32, device=device)
        if rank == 0:
            dist.isend(x, 1).wait(timeout=timedelta(seconds=20))
            return True
        got = torch.empty_like(x)
        dist.irecv(got, 0).wait(timeout=timedelta(seconds=20))
        return torch.equal(got.cpu(), torch.arange(4.0))

    if which == "collectives":
        for dtype in (torch.float32, torch.bfloat16):
            attempt(f"gather, rotate, all_to_all {str(dtype)[6:]}", lambda: moved(dtype))
    else:
        attempt("send_recv", send_recv)
    return out


def sp_workload_sequence(name, device, backend) -> dict:
    """An SP_EXAMPLES, PP_EXAMPLES or EP_EXAMPLES payload through the
    port's `WorkloadRunner` on `device`, over `StandInCluster`: one worker
    process a device of its mesh, on `backend`; the annotations, the
    terminal state and each rank's result line."""
    from jobset_tpu_torch.runtime import WorkloadRunner

    payload, (replicas, pods) = {**SP_EXAMPLES, **PP_EXAMPLES, **EP_EXAMPLES}[name]
    cluster = StandInCluster(name, json.loads(json.dumps(payload)), replicas=replicas,
                             parallelism=pods)
    runner = WorkloadRunner(cluster, device, backend=backend)
    t0 = time.perf_counter()
    ran = runner.run_pending()
    return {"ran": ran, "seconds": time.perf_counter() - t0,
            "terminal_state": cluster.js.status.terminal_state,
            "annotations": dict(cluster.js.metadata.annotations),
            "results": runner.last_gang_results}


def gloo_probe(which) -> object:
    """(f)'s probe gang for `which`; a gang that fails (a rank aborted) is
    the probe's finding, reported as such."""
    from jobset_tpu_torch.runtime import gang

    try:
        return gang.spawn(gloo_cuda_probe, 2, (which,), backend="gloo", device="cuda",
                          timeout_s=90, threads=0)
    except RuntimeError as exc:
        return f"the probe's gang failed: {str(exc).splitlines()[0][:200]}"


def phase_sp(results):
    """Phase 16: sequence parallelism and ZeRO-1 at the flagship's width,
    gangs of ranks sharing the card on gloo with CUDA tensors. The
    single-process references run beside the block checks (a), then the
    timed gang (b, d) beside the untimed gangs (c), (e), (f) and the CPU
    gang, in threads, each in processes of its own (the step times beside
    theirs: no scaling figure either way)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from dataclasses import replace

    from jobset_tpu_torch.runtime import gang

    card = results["card"]
    t_phase = time.perf_counter()
    out: dict = {}
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    dense = replace(flagship_config(), remat=False, n_layers=SP_LAYERS)
    ulysses = replace(dense, attn_impl="ulysses")
    small = gang_small_config()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        # The single-process runs the gangs are held to, in one process,
        # while (a) runs here.
        t0 = time.perf_counter()
        paths = {key: os.path.join(tmp, f"{key}.pt") for key in ("dense", "long")}
        jobs = [dict(cfg=dense, batch=BATCH, seq=PROMPT, path=paths["dense"]),
                dict(cfg=dense, batch=1, seq=LONG_SEQ, path=paths["long"], steps=LONG_STEPS)]
        pending_refs = pool.submit(gang.spawn, gang_references, 1, (jobs,), backend="gloo",
                                   device="cuda", timeout_s=GANG_TIMEOUT_S, threads=0)
        out["blocks"] = sp_kernel_checks()
        refs = dict(zip(paths, pending_refs.result()[0]))
        out["references_s"] = time.perf_counter() - t0

        # (b) and (d): sp = 2, two ranks, every timed run in one gang.
        t0 = time.perf_counter()
        specs = [
            {"cfg": dense, "mesh": {"sp": SP}, "batch": BATCH, "seq": PROMPT,
             "reference": paths["dense"]},
            {"cfg": ulysses, "mesh": {"sp": SP}, "batch": BATCH, "seq": PROMPT,
             "reference": paths["dense"]},
            {"cfg": dense, "mesh": {"sp": SP}, "batch": 1, "seq": LONG_SEQ,
             "reference": paths["long"], "steps": LONG_STEPS, "timed": False},
            {"cfg": small, "mesh": {"sp": SP}, "batch": 4, "seq": 64, "draw_on_cpu": True,
             "timed": False},
            {"cfg": replace(small, attn_impl="ulysses"), "mesh": {"sp": SP}, "batch": 4,
             "seq": 64, "draw_on_cpu": True, "timed": False},
        ]
        # Untimed, beside the sp gang: (c) ZeRO-1 at dp = 2, the small f32
        # config's CPU gang, (e) the two examples through WorkloadRunner on
        # the card and on the CPU, and (f) the gloo probes.
        zero = pool.submit(gang.spawn, zero_rank, 2, (dense, BATCH, PROMPT), backend="gloo",
                           device="cuda", timeout_s=GANG_TIMEOUT_S, threads=0)
        cpu = pool.submit(gang.spawn, gang_ranks, SP,
                          ([dict(spec, device="cpu") for spec in specs[3:]],), backend="gloo",
                          device="cpu", timeout_s=GANG_TIMEOUT_S, threads=0)
        examples = {(name, device): pool.submit(sp_workload_sequence, name, device, "gloo")
                    for name in SP_EXAMPLES for device in ("cuda", "cpu")}
        probes = {which: pool.submit(gloo_probe, which) for which in ("collectives", "send_recv")}
        by_rank = gang.spawn(gang_ranks, SP, (specs,), backend="gloo", device="cuda",
                             timeout_s=GANG_TIMEOUT_S, threads=0)
        ring, uly, long_, small_ring, small_uly = ([r[i] for r in by_rank] for i in range(5))
        out["sp_gang_s"] = time.perf_counter() - t0
        zero, cpu = zero.result(), cpu.result()
        runs = {key: job.result() for key, job in examples.items()}
        out["gloo_probe"] = {which: job.result() for which, job in probes.items()}
        out["untimed_s"] = time.perf_counter() - t0

    for label, ranks, want, passes in (("ring", ring, SP_RING_LAUNCHES, SP_FIRST_PASSES),
                                       ("ulysses", uly, SP_ULYSSES_LAUNCHES, SP_FIRST_PASSES)):
        gang_print(f"sp (b) {label}", ranks, card)
        out[label] = {"ranks": ranks, "worst": gang_check(
            f"sp (b) dense flagship sp=2 {label}, B={BATCH} T={PROMPT} bf16", ranks,
            refs["dense"], GANG_BF16_LOSS_REL, GANG_BF16_GRAD_REL, GANG_BF16_MOVE_REL)}
        for r in ranks:
            c = r["launches"]
            check(c["TENSOR_CORE_LAUNCHES"] == c["KERNEL_LAUNCHES"] == want
                  and c["F32_LAUNCHES"] == 0 and c["TILE_CLASS_LAUNCHES"] == passes,
                  f"sp (b) {label} rank {r['rank']}: {want} bf16 flash launches and "
                  f"{passes} tile-class passes on the first step ({c['KERNEL_LAUNCHES']}, "
                  f"{c['TILE_CLASS_LAUNCHES']})")

    # The small f32 config at sp = 2 against the port's CPU gang.
    for i, (label, ranks) in enumerate((("ring", small_ring), ("ulysses", small_uly))):
        want, got = cpu[0][i], ranks[0]
        worst = max(abs(a - b) / abs(b) for a, b in zip([got["grad_loss"]] + got["losses"],
                                                       [want["grad_loss"]] + want["losses"]))
        check(worst <= GANG_F32_REL and all(r["launches"]["F32_LAUNCHES"] == (
                  SP if label == "ring" else 3) * small.n_layers for r in ranks),
              f"sp small f32 {label} sp=2 (TF32 off): losses {got['losses']} against the "
              f"CPU gang's {want['losses']} (worst {worst:.2e}, bound {GANG_F32_REL}); "
              f"f32 flash launches {[r['launches']['F32_LAUNCHES'] for r in ranks]}")
        out[f"small_f32_{label}"] = {"card": ranks, "cpu": [c[i] for c in cpu], "worst": worst}

    # (d) long context: one process against the ring at sp = 2.
    one = refs["long"]
    out["long"] = {"ranks": long_, "reference": one, "worst": gang_check(
        f"sp (d) dense flagship B=1 T={LONG_SEQ} ring sp=2 ({LONG_STEPS} adam steps)",
        long_, one, GANG_BF16_LOSS_REL, GANG_BF16_GRAD_REL, GANG_BF16_MOVE_REL)}
    print(f"  sp (d) peak memory: one process {one['peak_gb']:.2f} GB; ring sp=2 by rank "
          f"{[round(r['peak_gb'], 2) for r in long_]} GB ({card})", flush=True)
    for r in long_:
        check(r["launches"]["TENSOR_CORE_LAUNCHES"] == SP_RING_LAUNCHES,
              f"sp (d) rank {r['rank']}: {SP_RING_LAUNCHES} bf16 flash launches a step "
              f"at [1, {LONG_SEQ // SP}, 16, 64] ({r['launches']['TENSOR_CORE_LAUNCHES']})")

    # (c) ZeRO-1 at dp = 2.
    for r in zero:
        for name in ("adam", "adafactor"):
            z, plain = r[f"{name} zero1"], r[f"{name} plain"]
            print(f"  zero (c) rank {r['rank']} {name}: state {z['state_bytes'] / 1e6:.3f} MB a "
                  f"rank with zero1 against {plain['state_bytes'] / 1e6:.3f} MB without; peak "
                  f"{z['peak_gb']:.2f} against {plain['peak_gb']:.2f} GB "
                  f"({z['peak_over_held_gb']:.2f} against {plain['peak_over_held_gb']:.2f} GB "
                  f"over what the rank held before the run); losses {z['losses']} and "
                  f"{plain['losses']} ({card})", flush=True)
        check(r["adam equal"] and r["adam zero1"]["losses"] == r["adam plain"]["losses"],
              f"zero (c) rank {r['rank']}: adam at dp=2 with zero1 equals the run without it "
              f"bit for bit after {GANG_STEPS} steps (worst {r['adam worst_rel']:.2e})")
        check(r["adafactor worst_rel"] <= ZERO_ADAFACTOR_REL,
              f"zero (c) rank {r['rank']}: adafactor with zero1 within {ZERO_ADAFACTOR_REL} of "
              f"the run without it (worst leaf {r['adafactor worst_rel']:.2e})")
        check(r["adam zero1"]["state_bytes"] <= 0.51 * r["adam plain"]["state_bytes"],
              f"zero (c) rank {r['rank']}: adam's state halves with zero1")
    out["zero"] = zero

    # (e) the two examples, the card's gangs against the CPU's.
    for name, (payload, _) in SP_EXAMPLES.items():
        card_run, cpu_run = runs[(name, "cuda")], runs[(name, "cpu")]
        final = float(card_run["annotations"].get(FINAL_LOSS, "nan"))
        want = float(cpu_run["annotations"].get(FINAL_LOSS, "nan"))
        n = int(np.prod(list(payload["mesh"].values())))
        check(card_run["terminal_state"] == "Completed" == cpu_run["terminal_state"]
              and len(card_run["results"] or []) == n and abs(final - want) <= 1e-4,
              f"sp (e) {name}.yaml through WorkloadRunner as {n} processes on the card: "
              f"{card_run['terminal_state']} in {card_run['seconds']:.1f} s, final loss {final} "
              f"vs the CPU gang's {want}")
        for line in card_run["results"] or []:
            print(f"  sp (e) {name} rank {line['process_id']}: mesh {line['mesh']}, kernel "
                  f"launches {line['kernel_launches']}", flush=True)
        out[f"example {name}"] = {"card": card_run, "cpu": cpu_run}
    # (f) the port's moving collectives on gloo with CUDA tensors, held
    # bit for bit; send/recv, which the port does not use, as information.
    for which, found in out["gloo_probe"].items():
        print(f"  sp (f) gloo with CUDA tensors, {which}, by rank: {found}", flush=True)
    found = out["gloo_probe"]["collectives"]
    check(isinstance(found, list) and all(v == "ran, right" for r in found for v in r.values()),
          "sp (f) gather, rotate and all_to_all of CUDA tensors on gloo (all_to_all_single), "
          "f32 and bf16, bit for bit on both ranks")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 16: {out['seconds']:.1f} s (block checks beside the references "
          f"{out['references_s']:.1f}, sp gang {out['sp_gang_s']:.1f}, and beside it zero1, "
          f"the CPU gang, examples and probes {out['untimed_s']:.1f})", flush=True)
    results["sp"] = out


FINAL_LOSS = "tpu.jobset.x-k8s.io/final-loss"


def sp_launches(results) -> dict:
    """Phase 16's launches of the flash kernels: rank 0's first step of
    each sp path, (a)'s block checks, and rank 0's whole run of
    lm-long-context.yaml (f32, Ulysses)."""
    sp = results.get("sp") or {}

    def first(key, counter):
        ranks = (sp.get(key) or {}).get("ranks") or [{}]
        return (ranks[0].get("launches") or {}).get(counter)

    lines = ((sp.get("example lm-long-context") or {}).get("card") or {}).get("results") or [{}]
    whole = lines[0].get("kernel_launches") or {}
    blocks = sp.get("blocks") or {}

    def checks(tag):
        return sum(v["launches"] for k, v in blocks.items() if k.startswith(tag))

    return {
        "flash_block": {"ring sp=2 step": first("ring", "TENSOR_CORE_LAUNCHES"),
                        "Ulysses sp=2 step": first("ulysses", "TENSOR_CORE_LAUNCHES"),
                        f"ring sp=2 T={LONG_SEQ} step": first("long", "TENSOR_CORE_LAUNCHES"),
                        "ring block checks": checks("bf16")},
        "flash_block_f32": {"ring block checks": checks("f32"),
                            "lm-long-context.yaml run, rank 0": whole.get("F32_LAUNCHES")},
        "flash_block_tile_classes": {"ring sp=2 first step": first("ring", "TILE_CLASS_LAUNCHES"),
                                     "Ulysses sp=2 first step": first("ulysses",
                                                                      "TILE_CLASS_LAUNCHES")},
        "flash_block_backward": {"ring sp=2 step": first("ring", "BACKWARD_LAUNCHES"),
                                 "Ulysses sp=2 step": first("ulysses", "BACKWARD_LAUNCHES"),
                                 f"ring sp=2 T={LONG_SEQ} step": first("long",
                                                                       "BACKWARD_LAUNCHES")},
        "flash_block_backward_f32": {"lm-long-context.yaml run, rank 0":
                                     f32_backward_by_variant(whole)},
    }


def phase_sp_apart(results):
    """Phase 16 in a process of its own (`--sp-only`), this process's cached
    blocks handed back to the card first."""
    import tempfile

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sp.json")
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--sp-only",
                              "--out", path], capture_output=True, text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 16 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return
        with open(path) as f:
            results["sp"] = json.load(f).get("sp")


# ---------------------------------------------------------------------------
# Phase 17: pipeline parallelism (gpipe, interleaved, 1f1b)
# ---------------------------------------------------------------------------

# The flagship at PP_LAYERS of its layers at pp = 2 (2 a rank), B = 8,
# T = 1024, 4 microbatches of 2 rows; (b) at 8 microbatches of one row.
# Each rank launches the bf16 flash kernel once a layer a microbatch under
# every schedule (remat off): 8 a step.
PP, PP_MICRO, PP_MEMORY_MICRO = 2, 4, 8
PP_LAUNCHES = PP_MICRO * PP_LAYERS // PP
PP_SCHEDULES = {"gpipe": {}, "interleaved": {"pipeline_virtual": 2}, "1f1b": {}}
# (c): the small f32 configs at pp = 2 (4 layers, 4 microbatches), each
# schedule the reference allows (1f1b refuses token-choice top-k).
PP_SMALL_SCHEDULES = {"dense": ("gpipe", "interleaved", "1f1b"),
                      "dropless": ("gpipe", "interleaved")}
# examples/training/lm-pp-interleaved.yaml's payload (held to the file by
# tests/test_torch_gang_runner.py) and its gang (replicas, pods a job).
LM_PP_INTERLEAVED_PAYLOAD = {
    "kind": "lm", "steps": 8, "batch_size": 4, "seq_len": 16, "mesh": {"pp": 2, "tp": 2},
    "config": {"vocab_size": 128, "d_model": 64, "n_heads": 4, "d_ff": 128, "n_layers": 4,
               "max_seq_len": 32, "n_microbatches": 4, "pipeline_schedule": "interleaved",
               "pipeline_virtual": 2}}
PP_EXAMPLES = {"lm-pp-interleaved": (LM_PP_INTERLEAVED_PAYLOAD, (2, 2))}


def pp_config(base, schedule: str, n_micro: int):
    from dataclasses import replace

    return replace(base, n_microbatches=n_micro, pipeline_schedule=schedule,
                   **PP_SCHEDULES[schedule])


def pp_small_configs() -> dict:
    """(c)'s configs by label: phase 15's small f32 GQA config at 4 layers,
    dense and MoE dropless top-2, under each schedule it allows."""
    from dataclasses import replace

    dense = replace(gang_small_config(), n_layers=4)
    bases = {"dense": dense, "dropless": replace(dense, n_experts=4, d_ff_expert=64,
                                                 moe_top_k=2, moe_dispatch="dropless")}
    return {f"{kind} {schedule}": pp_config(bases[kind], schedule, PP_MICRO)
            for kind, schedules in PP_SMALL_SCHEDULES.items() for schedule in schedules}


def pp_print(label, ranks, card):
    for r in ranks:
        if "step_ms" not in r:
            continue
        print(f"  {label} rank {r['rank']} {r['coords']}: pipeline shifts (all-to-all) "
              f"{r['all_to_all_ms']:.3f} ms in {r['all_to_all_calls']} calls = "
              f"{r['all_to_all_share']:.1%} of the traced step, all-reduces "
              f"{r['all_reduce_ms']:.3f} ms in {r['all_reduce_calls']} calls = "
              f"{r['all_reduce_share']:.1%} (torch.profiler host spans; ranks sharing one "
              f"card on gloo; {card})", flush=True)
    gang_print(label, ranks, card)


def phase_pp(results):
    """Phase 17: pipeline parallelism at the flagship's width, gangs of two
    ranks sharing the card on gloo with CUDA tensors. The single-process
    reference and the CPU gangs run first, at once; then the timed gang
    (a) beside (b), (c) and (d) on the card (its step times beside
    theirs: no scaling figure either way)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from dataclasses import replace

    from jobset_tpu_torch.runtime import gang

    card = results["card"]
    t_phase = time.perf_counter()
    out: dict = {}
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    dense = replace(flagship_config(), remat=False, n_layers=PP_LAYERS)
    small = pp_small_configs()
    small_specs = [{"cfg": cfg, "mesh": {"pp": PP}, "batch": 4, "seq": 64, "draw_on_cpu": True,
                    "timed": False, "label": label} for label, cfg in small.items()]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "dense.pt")
        pending_ref = pool.submit(gang.spawn, gang_references, 1,
                                  ([dict(cfg=dense, batch=BATCH, seq=PROMPT, path=path)],),
                                  backend="gloo", device="cuda", timeout_s=GANG_TIMEOUT_S,
                                  threads=0)
        cpu = pool.submit(gang.spawn, gang_ranks, PP,
                          ([dict(spec, device="cpu") for spec in small_specs],), backend="gloo",
                          device="cpu", timeout_s=GANG_TIMEOUT_S, threads=0)
        example_cpu = pool.submit(sp_workload_sequence, "lm-pp-interleaved", "cpu", "gloo")
        ref = pending_ref.result()[0][0]
        cpu, example_cpu = cpu.result(), example_cpu.result()
        out["references_s"] = time.perf_counter() - t0

        # (b), (c) and (d) on the card, untimed, beside (a).
        t0 = time.perf_counter()
        memory = pool.submit(gang.spawn, gang_ranks, PP, (
            [{"cfg": pp_config(dense, schedule, PP_MEMORY_MICRO), "mesh": {"pp": PP},
              "batch": BATCH, "seq": PROMPT, "steps": 1, "timed": False}
             for schedule in ("gpipe", "1f1b")],), backend="gloo", device="cuda",
            timeout_s=GANG_TIMEOUT_S, threads=0)
        card_small = pool.submit(gang.spawn, gang_ranks, PP, (small_specs,), backend="gloo",
                                 device="cuda", timeout_s=GANG_TIMEOUT_S, threads=0)
        example_card = pool.submit(sp_workload_sequence, "lm-pp-interleaved", "cuda", "gloo")

        # (a): each schedule at pp = 2, 4 microbatches, timed, one gang.
        specs = [{"cfg": pp_config(dense, schedule, PP_MICRO), "mesh": {"pp": PP},
                  "batch": BATCH, "seq": PROMPT, "reference": path,
                  "interleave": PP_SCHEDULES[schedule].get("pipeline_virtual", 1)}
                 for schedule in PP_SCHEDULES]
        by_rank = gang.spawn(gang_ranks, PP, (specs,), backend="gloo", device="cuda",
                             timeout_s=GANG_TIMEOUT_S, threads=0)
        timed_runs = {s: [r[i] for r in by_rank] for i, s in enumerate(PP_SCHEDULES)}
        out["timed_gang_s"] = time.perf_counter() - t0
        memory, card_small, example_card = (memory.result(), card_small.result(),
                                            example_card.result())
        out["untimed_s"] = time.perf_counter() - t0

    # (a) each schedule against one process.
    out["reference"] = ref
    for schedule, ranks in timed_runs.items():
        label = f"pp (a) dense flagship ({PP_LAYERS} layers) pp=2 {schedule}"
        pp_print(label, ranks, card)
        out[schedule] = {"ranks": ranks, "worst": gang_check(
            f"{label}, {PP_MICRO} microbatches, B={BATCH} T={PROMPT} bf16", ranks, ref,
            GANG_BF16_LOSS_REL, GANG_BF16_GRAD_REL, GANG_BF16_MOVE_REL)}
        for r in ranks:
            c = r["launches"]
            check(c["TENSOR_CORE_LAUNCHES"] == c["KERNEL_LAUNCHES"] == PP_LAUNCHES
                  and c["F32_LAUNCHES"] == 0,
                  f"{label} rank {r['rank']}: {PP_LAUNCHES} bf16 flash launches a step "
                  f"({PP_MICRO} microbatches x {PP_LAYERS // PP} layers; "
                  f"{c['KERNEL_LAUNCHES']})")

    # (b) what 1f1b is for: the peak over what a rank held before its step.
    for i, schedule in enumerate(("gpipe", "1f1b")):
        for r in (rank[i] for rank in memory):
            over = r["first_peak_gb"] - r["first_held_gb"]
            print(f"  pp (b) {PP_MEMORY_MICRO} microbatches of one row, {schedule}, rank "
                  f"{r['rank']}: one step's peak {over:.3f} GB over the {r['first_held_gb']:.3f} "
                  f"GB it held before it ({r['first_peak_gb']:.3f} GB in all); loss "
                  f"{r['grad_loss']:.6f} ({card})", flush=True)
            check(np.isfinite(r["grad_loss"]) and r["launches"]["TENSOR_CORE_LAUNCHES"]
                  == PP_MEMORY_MICRO * PP_LAYERS // PP,
                  f"pp (b) {schedule} rank {r['rank']}: a finite loss and "
                  f"{PP_MEMORY_MICRO * PP_LAYERS // PP} flash launches")
    gpipe_b, f1b_b = ([rank[i] for rank in memory] for i in range(2))
    check(all(abs(a["grad_loss"] - b["grad_loss"]) <= GANG_BF16_LOSS_REL * abs(a["grad_loss"])
              for a, b in zip(gpipe_b, f1b_b)),
          f"pp (b): 1f1b's loss is gpipe's within {GANG_BF16_LOSS_REL} "
          f"({[r['grad_loss'] for r in f1b_b]}, {[r['grad_loss'] for r in gpipe_b]})")
    out["memory"] = {"gpipe": gpipe_b, "1f1b": f1b_b}

    # (c) the small f32 configs, the card's gang against the CPU's.
    for i, label in enumerate(small):
        want, got = cpu[0][i], card_small[0][i]
        worst = max(abs(a - b) / abs(b) for a, b in zip([got["grad_loss"]] + got["losses"],
                                                       [want["grad_loss"]] + want["losses"]))
        grads = [r["launches"]["GROUPED_F32_LAUNCHES"] for r in (rank[i] for rank in card_small)]
        flash = [r["launches"]["F32_LAUNCHES"] for r in (rank[i] for rank in card_small)]
        check(worst <= GANG_F32_REL and all(n == PP_MICRO * 2 for n in flash),
              f"pp (c) small f32 {label} pp=2 (TF32 off): losses {got['losses']} against the "
              f"CPU gang's {want['losses']} (worst {worst:.2e}, bound {GANG_F32_REL}); f32 "
              f"flash launches a rank's step {flash}")
        if "dropless" in label:
            check(all(n == PP_MICRO * 2 * 2 for n in grads),
                  f"pp (c) small f32 {label}: {PP_MICRO * 2 * 2} f32 grouped forward launches a "
                  f"rank's step (2 products x 2 layers x {PP_MICRO} microbatches; {grads})")
            for r in (rank[i] for rank in card_small):
                c = r["launches"]
                print(f"  pp (c) {label} rank {r['rank']}: grouped launches a step: forward "
                      f"{c['GROUPED_LAUNCHES']} (f32 {c['GROUPED_F32_LAUNCHES']}), dgrad "
                      f"{c['GROUPED_DGRAD_LAUNCHES']}, wgrad {c['GROUPED_WGRAD_LAUNCHES']} (f32 "
                      f"TMA {c['GROUPED_WGRAD_F32_TMA_LAUNCHES']})", flush=True)
        out[f"small {label}"] = {"card": [rank[i] for rank in card_small],
                                 "cpu": [rank[i] for rank in cpu], "worst": worst}

    # (d) the example, the card's gang against the CPU's.
    payload, _ = PP_EXAMPLES["lm-pp-interleaved"]
    final = float(example_card["annotations"].get(FINAL_LOSS, "nan"))
    want = float(example_cpu["annotations"].get(FINAL_LOSS, "nan"))
    n = int(np.prod(list(payload["mesh"].values())))
    check(example_card["terminal_state"] == "Completed" == example_cpu["terminal_state"]
          and len(example_card["results"] or []) == n and abs(final - want) <= 1e-4,
          f"pp (d) lm-pp-interleaved.yaml through WorkloadRunner as {n} processes on the card: "
          f"{example_card['terminal_state']} in {example_card['seconds']:.1f} s, final loss "
          f"{final} vs the CPU gang's {want}")
    for line in example_card["results"] or []:
        print(f"  pp (d) lm-pp-interleaved rank {line['process_id']}: mesh {line['mesh']}, "
              f"kernel launches {line['kernel_launches']}", flush=True)
    out["example lm-pp-interleaved"] = {"card": example_card, "cpu": example_cpu}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 17: {out['seconds']:.1f} s (reference and CPU gangs at once "
          f"{out['references_s']:.1f}, timed gang {out['timed_gang_s']:.1f}, and beside it the "
          f"memory, small f32 and example gangs {out['untimed_s']:.1f})", flush=True)
    results["pp"] = out


def pp_launches(results) -> dict:
    """Phase 17's launches of each kernel entry: rank 0's first step under
    each schedule in (a) (bf16 flash), the small f32 configs' (c) (f32
    flash, f32 grouped), and rank 0's whole run of lm-pp-interleaved.yaml
    (f32 flash)."""
    pp = results.get("pp") or {}

    def first(key):
        runs = pp.get(key) or {}
        ranks = runs.get("ranks") or runs.get("card") or [{}]
        return ranks[0].get("launches") or {}

    lines = ((pp.get("example lm-pp-interleaved") or {}).get("card") or {}).get("results") or [{}]
    whole = lines[0].get("kernel_launches") or {}
    flash = {f"{s} pp=2 step": first(s).get("TENSOR_CORE_LAUNCHES") for s in PP_SCHEDULES}
    dropless = {f"small f32 dropless {s} pp=2 step": first(f"small dropless {s}")
                for s in PP_SMALL_SCHEDULES["dropless"]}
    not_run = {"not on the pp runs (the MoE pp run is f32)": 0}
    return {
        "flash_block": flash,
        "flash_block_f32": {**{f"small f32 {label} pp=2 step": first(f"small {label}").get(
            "F32_LAUNCHES") for label in pp_small_configs()},
            "lm-pp-interleaved.yaml run, rank 0": whole.get("F32_LAUNCHES")},
        "flash_block_tile_classes": {f"{s} pp=2 first step": first(s).get("TILE_CLASS_LAUNCHES")
                                     for s in PP_SCHEDULES},
        "flash_block_backward": {f"{s} pp=2 step": first(s).get("BACKWARD_LAUNCHES")
                                 for s in PP_SCHEDULES},
        "flash_block_backward_f32": {**{f"small f32 {label} pp=2 step": f32_backward_by_variant(
            first(f"small {label}")) for label in pp_small_configs()},
            "lm-pp-interleaved.yaml run, rank 0": f32_backward_by_variant(whole)},
        "grouped_matmul": not_run, "grouped_matmul_dgrad": not_run,
        "grouped_matmul_wgrad": not_run,
        "grouped_matmul_f32": {k: v.get("GROUPED_F32_LAUNCHES") for k, v in dropless.items()},
        "grouped_matmul_dgrad_f32": {k: v.get("GROUPED_DGRAD_F32_LAUNCHES")
                                     for k, v in dropless.items()},
        "grouped_matmul_wgrad_f32": {k: v.get("GROUPED_WGRAD_F32_LAUNCHES")
                                     for k, v in dropless.items()},
    }


def phase_pp_apart(results):
    """Phase 17 in a process of its own (`--pp-only`), this process's cached
    blocks handed back to the card first."""
    import tempfile

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pp.json")
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--pp-only",
                              "--out", path], capture_output=True, text=True, timeout=600)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 17 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return
        with open(path) as f:
            results["pp"] = json.load(f).get("pp")


# ---------------------------------------------------------------------------
# Phase 18: expert parallelism (ep > 1)
# ---------------------------------------------------------------------------

# The MoE flagship at ep = 2: a rank holds 4 of the 8 experts and routes
# the whole token set (the batch is replicated over ep), so its grouped
# products run on every slot of B=8, T=1024, top 2 (16,384 rows), about
# half of them in the foreign tail past its 4 groups.
EP, EP_MOE_LAYERS = 2, 4  # 4 of the MoE flagship's 8 layers
EP_LOCAL = MOE_EXPERTS // EP
# (a)'s routings of an ep rank's slots: the router of a random layer on
# random hidden states (rank 0's groups, ~half the rows foreign), and
# every slot on the other rank's experts (no group has a row).
EP_ROUTINGS = ("routed", "all-foreign")
# A finite fill of the foreign tail that must move no covered output.
EP_TAIL_FILL = 3.0
# (c)'s small f32 configs at ep = 2: phase 15's small config with 4
# experts of d_ff_expert 64 under each router (aux coef 0.1), and
# dropless at (pp 2, ep 2) under gpipe (4 layers, 4 microbatches).
EP_ROUTERS = {"soft": {}, "capacity": {"moe_top_k": 2, "moe_capacity_factor": 1.0},
              "dropless": {"moe_top_k": 2, "moe_dispatch": "dropless"},
              "expert choice": {"moe_router": "expert"}}
# (d): lm-moe-dropless.yaml's payload at mesh {ep: 2}, a gang of 2 (one
# job of two pods).
EP_EXAMPLES = {"lm-moe-dropless-ep": (dict(LM_MOE_DROPLESS_PAYLOAD, mesh={"ep": EP}), (1, EP))}


def ep_small_configs() -> dict:
    from dataclasses import replace

    base = replace(gang_small_config(), n_experts=4, d_ff_expert=64, moe_aux_coef=0.1)
    configs = {f"{router} ep=2": replace(base, **extra) for router, extra in EP_ROUTERS.items()}
    configs["dropless pp=2 x ep=2 gpipe"] = pp_config(
        replace(configs["dropless ep=2"], n_layers=4), "gpipe", PP_MICRO)
    return configs


def ep_group_sizes(routing) -> torch.Tensor:
    """An ep rank's [EP_LOCAL] group sizes over MOE_SLOTS slots: rank 0's
    under a router's top-2 picks of random hidden states (the sort key of
    `sorted_ragged_expert_ffn`'s local form), or none at all."""
    from jobset_tpu_torch.models import transformer

    if routing == "all-foreign":
        return torch.zeros(EP_LOCAL, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((MOE_SLOTS // MOE_TOP_K, 1024), generator=gen, device="cuda")
    wg = torch.randn((1024, MOE_EXPERTS), generator=gen, device="cuda") / 32
    _, top_i = transformer.renormalized_topk(transformer._router_gates(x, wg), MOE_TOP_K)
    expert_of = top_i.reshape(-1)
    key = torch.where(expert_of // EP_LOCAL == 0, expert_of, EP_LOCAL)
    return torch.bincount(key, minlength=EP_LOCAL + 1)[:EP_LOCAL].to(torch.int32)


def ep_bound_ms(which, covered, k, n, dtype) -> tuple[float, str]:
    """The least time of one ep rank's product with `covered` rows in its
    groups: the covered rows of each input read once, the weights (or, for
    wgrad, dw) once, the output written once (forward and dgrad: every
    row, the tail's zeros too), and 2 covered k n products at the dtype's
    rate (`PRODUCT_RATE`); the larger."""
    size = torch.tensor([], dtype=dtype).element_size()
    weights = EP_LOCAL * k * n
    elems = {"forward": covered * k + weights + MOE_SLOTS * n,
             "dgrad": covered * n + weights + MOE_SLOTS * k,
             "wgrad": covered * (k + n) + weights}[which]
    t_bytes = size * elems / HBM_BYTES_PER_S
    peak, passes = PRODUCT_RATE[dtype]
    t_ops = passes * 2 * covered * k * n / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ep_kernel_case(which, dtype, k, n, routing, seed) -> dict:
    """One grouped kernel at an ep rank's product against its plain
    version: the grouped kernels' tolerance, one launch on the dtype's
    kernel (TMA for bf16, and for f32 wgrad), the foreign tail's rows of
    forward and dgrad exactly 0, and another finite fill of the tail
    (xs's, and dy's) leaving every covered output and wgrad's dw the same
    bit for bit. Returns its error and the covered rows."""
    from jobset_tpu_torch.ops import grouped_matmul as gm

    tag = "bf16" if dtype == torch.bfloat16 else "f32"
    name = f"ep rank {which} {tag} [{MOE_SLOTS},{k}]x[{EP_LOCAL},{k},{n}] {routing}"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn((MOE_SLOTS, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((EP_LOCAL, k, n), generator=gen, device="cuda") / k ** 0.5).to(dtype)
    dy = torch.randn((MOE_SLOTS, n), generator=gen, device="cuda").to(dtype)
    sizes = ep_group_sizes(routing)
    covered = int(sizes.sum())
    fn, plain = {"forward": (gm.grouped_matmul, gm.grouped_matmul_plain),
                 "dgrad": (gm.grouped_matmul_dgrad, gm.grouped_matmul_dgrad_plain),
                 "wgrad": (gm.grouped_matmul_wgrad, gm.grouped_matmul_wgrad_plain)}[which]
    args = {"forward": (xs, w), "dgrad": (dy, w), "wgrad": (xs, dy)}[which]
    before = moe_launches_now()
    got = fn(*args, sizes)
    launched = {key: v - before[key] for key, v in moe_launches_now().items() if v != before[key]}
    filled = [a.clone() if a.shape[0] == MOE_SLOTS else a for a in args]
    for a in filled:
        if a.shape[0] == MOE_SLOTS:
            a[covered:] = EP_TAIL_FILL
    again = fn(*filled, sizes)
    torch.cuda.synchronize()
    with f32_accumulating_plain():
        want = plain(*args, sizes)
    err = (got.float() - want.float()).abs()
    limit = INT8_ABS[dtype] * want.float().abs().max().item()
    if dtype == torch.bfloat16:
        limit = INT8_REL_BF16 * want.float().abs() + limit
    worst = err.max().item()
    counter = {"forward": "GROUPED_LAUNCHES", "dgrad": "GROUPED_DGRAD_LAUNCHES",
               "wgrad": "GROUPED_WGRAD_LAUNCHES"}[which]
    expect = {counter: 1}
    if dtype == torch.float32 and which != "forward":
        expect[counter.replace("_LAUNCHES", "_F32_LAUNCHES")] = 1
    if which == "forward":
        expect["GROUPED_TMA_LAUNCHES" if dtype == torch.bfloat16 else "GROUPED_F32_LAUNCHES"] = 1
    if which == "wgrad":
        expect["GROUPED_WGRAD_F32_TMA_LAUNCHES" if dtype == torch.float32
               else "GROUPED_WGRAD_TMA_LAUNCHES"] = 1
    check(launched == expect and got.dtype == dtype and bool(torch.isfinite(got.float()).all()),
          f"grouped {name}: launches {launched} (expected {expect}), {dtype}, finite")
    check(bool((err <= limit).all()), f"grouped {name}: within tolerance of the plain version "
                                      f"(max|d| {worst:.3e})")
    if which == "wgrad":
        check(torch.equal(got, again), f"grouped {name}: the foreign tail refilled with "
                                       f"{EP_TAIL_FILL}, dw equal bit for bit (no tail row read)")
    else:
        check(bool((got[covered:] == 0).all()) and bool((again[covered:] == 0).all())
              and torch.equal(got[:covered], again[:covered]),
              f"grouped {name}: the {MOE_SLOTS - covered} foreign rows exactly 0, and the "
              f"{covered} covered rows equal bit for bit with the tail refilled")
    return {"max_abs_err": worst, "covered": covered}


def ep_time_case(which, dtype, k, n) -> dict:
    """L2-cold times (two input sets alternating) of one kernel at an ep
    rank's product (4 experts, the routed sizes: about half the rows
    foreign) and the same call at ep = 1 (8 experts, every row in a group),
    with the ep rank's bound."""
    from jobset_tpu_torch.ops import grouped_matmul as gm

    fn = {"forward": gm.grouped_matmul, "dgrad": gm.grouped_matmul_dgrad,
          "wgrad": gm.grouped_matmul_wgrad}[which]
    gen = torch.Generator(device="cuda").manual_seed(k + n)
    out = {}
    for label, experts, sizes in (("ep2", EP_LOCAL, ep_group_sizes("routed")),
                                  ("ep1", MOE_EXPERTS, moe_group_sizes("balanced"))):
        sets = []
        for _ in range(2):
            xs = torch.randn((MOE_SLOTS, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((experts, k, n), generator=gen, device="cuda") / k ** 0.5).to(dtype)
            dy = torch.randn((MOE_SLOTS, n), generator=gen, device="cuda").to(dtype)
            sets.append({"forward": (xs, w), "dgrad": (dy, w), "wgrad": (xs, dy)}[which])
        out[f"{label}_ms"] = rotating_ms(lambda i: fn(*sets[i], sizes), 2, ITERS // 2)
        del sets
    covered = int(ep_group_sizes("routed").sum())
    out["covered_rows"] = covered
    out["bound_ms"], out["bound_by"] = ep_bound_ms(which, covered, k, n, dtype)
    torch.cuda.empty_cache()
    return out


def ep_kernel_checks(card) -> dict:
    """(a): every grouped kernel at an ep rank's two products, bf16 and f32,
    each routing (checks), then timed beside ep = 1."""
    errs, times, seed = {}, {}, 1800
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        if dtype == torch.float32:
            plain_is_f32("ep grouped checks")
        for label, (k, n) in MOE_PRODUCTS.items():
            for which in ("forward", "dgrad", "wgrad"):
                for routing in EP_ROUTINGS:
                    errs[f"{which} {tag} {label} {routing}"] = ep_kernel_case(
                        which, dtype, k, n, routing, seed)
                    seed += 1
                times[f"{which} {tag} {label}"] = t = ep_time_case(which, dtype, k, n)
                print(f"  ep (a) {which} {tag} {label} [{MOE_SLOTS},{k}]x[{EP_LOCAL},{k},{n}], "
                      f"{t['covered_rows']} rows in rank 0's groups: {t['ep2_ms']:.4f} ms; the "
                      f"same call at ep = 1 ([{MOE_EXPERTS},{k},{n}], every row routed) "
                      f"{t['ep1_ms']:.4f} ms; the rank's bound {t['bound_ms']:.4f} ms "
                      f"({t['bound_by']}) ({card})", flush=True)
    return {"errors": errs, "times": times}


def phase_ep(results):
    """Phase 18: expert parallelism. (a) the grouped kernels at an ep rank's
    products; (b) the MoE flagship at ep = 2, two ranks sharing the card on
    gloo, against one process; (c) every router of a small f32 config at
    ep = 2, and dropless at (pp 2, ep 2), against the port's CPU gang; (d)
    lm-moe-dropless.yaml's payload at {ep: 2} through the worker, on the
    card and on the CPU. The reference and the CPU gangs run first, at
    once; then (b) beside (c) and (d) on the card."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from dataclasses import replace

    from jobset_tpu_torch.runtime import gang

    card = results["card"]
    t_phase = time.perf_counter()
    out: dict = {}
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    out["kernels"] = ep_kernel_checks(card)
    out["kernels_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    moe = replace(moe_config(), n_layers=EP_MOE_LAYERS)
    small = ep_small_configs()
    small_specs = [{"cfg": cfg, "mesh": {"pp": 2, "ep": EP} if "pp=2" in label else {"ep": EP},
                    "batch": 4, "seq": 64, "draw_on_cpu": True, "timed": False,
                    "label": label} for label, cfg in small.items()]
    cpu_specs = [dict(spec, device="cpu") for spec in small_specs]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "moe.pt")
        pending_ref = pool.submit(gang.spawn, gang_references, 1,
                                  ([dict(cfg=moe, batch=BATCH, seq=PROMPT, path=path)],),
                                  backend="gloo", device="cuda", timeout_s=GANG_TIMEOUT_S,
                                  threads=0)
        cpu_ep = pool.submit(gang.spawn, gang_ranks, EP, ([s for s in cpu_specs
                                                           if s["mesh"] == {"ep": EP}],),
                             backend="gloo", device="cpu", timeout_s=GANG_TIMEOUT_S, threads=0)
        cpu_pp = pool.submit(gang.spawn, gang_ranks, 2 * EP, ([s for s in cpu_specs
                                                               if "pp" in s["mesh"]],),
                             backend="gloo", device="cpu", timeout_s=GANG_TIMEOUT_S, threads=0)
        worker_cpu = pool.submit(sp_workload_sequence, "lm-moe-dropless-ep", "cpu", "gloo")
        ref = pending_ref.result()[0][0]
        cpu, cpu_pp = cpu_ep.result(), cpu_pp.result()
        worker_cpu = worker_cpu.result()
        out["references_s"] = time.perf_counter() - t0

        # (c) and (d) on the card, beside (b).
        t0 = time.perf_counter()
        card_ep = pool.submit(gang.spawn, gang_ranks, EP, ([s for s in small_specs
                                                            if s["mesh"] == {"ep": EP}],),
                              backend="gloo", device="cuda", timeout_s=GANG_TIMEOUT_S, threads=0)
        card_pp = pool.submit(gang.spawn, gang_ranks, 2 * EP, ([s for s in small_specs
                                                                if "pp" in s["mesh"]],),
                              backend="gloo", device="cuda", timeout_s=GANG_TIMEOUT_S,
                              threads=0)
        worker_card = pool.submit(sp_workload_sequence, "lm-moe-dropless-ep", "cuda", "gloo")

        # (b) the MoE flagship at ep 2, timed.
        spec = {"cfg": moe, "mesh": {"ep": EP}, "batch": BATCH, "seq": PROMPT,
                "reference": path}
        ranks = gang.spawn(gang_rank, EP, (spec,), backend="gloo", device="cuda",
                           timeout_s=GANG_TIMEOUT_S, threads=0)
        out["timed_gang_s"] = time.perf_counter() - t0
        card_ep, card_pp, worker_card = card_ep.result(), card_pp.result(), worker_card.result()
        out["untimed_s"] = time.perf_counter() - t0

    # (b) against one process.
    n = EP_MOE_LAYERS
    label = (f"ep (b) MoE flagship ep=2 ({EP_LOCAL} experts, we1 [{EP_LOCAL}, 1024, {MOE_D_FF}] "
             f"a rank), dropless top-2, B={BATCH} T={PROMPT} bf16, {n} layers")
    gang_print("ep (b)", ranks, card)
    for r in ranks:
        if "step_ms" in r:
            print(f"  ep (b) rank {r['rank']}: all-reduces {r['all_reduce_ms']:.3f} ms in "
                  f"{r['all_reduce_calls']} calls = {r['all_reduce_share']:.1%} of the traced "
                  f"step ({r['traced_step_ms']:.3f} ms), all-to-alls {r['all_to_all_calls']} "
                  f"(torch.profiler host spans; ranks sharing one card on gloo: no scaling "
                  f"figure; {card})", flush=True)
    out["moe_ep2"] = {"ranks": ranks, "reference": ref, "worst": gang_check(
        label, ranks, ref, GANG_BF16_LOSS_REL, None)}
    for r in ranks:
        c = r["launches"]
        check(c["GROUPED_LAUNCHES"] == c["GROUPED_TMA_LAUNCHES"] == 2 * n
              and c["GROUPED_DGRAD_LAUNCHES"] == 2 * n
              and c["GROUPED_WGRAD_LAUNCHES"] == c["GROUPED_WGRAD_TMA_LAUNCHES"] == 2 * n
              and c["TENSOR_CORE_LAUNCHES"] == n and c["F32_LAUNCHES"] == 0,
              f"ep (b) rank {r['rank']}: a step launches {n} flash and {2 * n} grouped forward "
              f"(all TMA), dgrad and wgrad (all TMA) kernels ({c})")

    # (c) the small f32 configs, the card's gangs against the CPU's.
    for runs_card, runs_cpu, labels in ((card_ep, cpu, [s["label"] for s in small_specs
                                                        if s["mesh"] == {"ep": EP}]),
                                        (card_pp, cpu_pp, [s["label"] for s in small_specs
                                                           if "pp" in s["mesh"]])):
        for i, label in enumerate(labels):
            got, want = runs_card[0][i], runs_cpu[0][i]
            worst = max(abs(a - b) / abs(b) for a, b in zip([got["grad_loss"]] + got["losses"],
                                                           [want["grad_loss"]] + want["losses"]))
            ok = all(r[i]["losses"] == got["losses"] for r in runs_card)
            check(worst <= GANG_F32_REL and ok,
                  f"ep (c) small f32 {label} (TF32 off): losses {got['losses']} against the CPU "
                  f"gang's {want['losses']} (worst {worst:.2e}, bound {GANG_F32_REL}); every "
                  "rank the same")
            counts = [r[i]["launches"] for r in runs_card]
            if "dropless" in label:
                micro = PP_MICRO if "pp=2" in label else 1
                layers = small[label].n_layers // (2 if "pp=2" in label else 1)
                want_n = 2 * layers * micro
                check(all(c["GROUPED_F32_LAUNCHES"] == c["GROUPED_DGRAD_F32_LAUNCHES"]
                          == c["GROUPED_WGRAD_F32_TMA_LAUNCHES"] == want_n for c in counts),
                      f"ep (c) {label}: {want_n} f32 grouped forward, dgrad and wgrad (TMA) "
                      f"launches a rank's step ({[c['GROUPED_F32_LAUNCHES'] for c in counts]})")
            print(f"  ep (c) {label}: a rank's step launches f32 flash "
                  f"{[c['F32_LAUNCHES'] for c in counts]}, f32 grouped forward "
                  f"{[c['GROUPED_F32_LAUNCHES'] for c in counts]}, dgrad "
                  f"{[c['GROUPED_DGRAD_F32_LAUNCHES'] for c in counts]}, wgrad "
                  f"{[c['GROUPED_WGRAD_F32_LAUNCHES'] for c in counts]}", flush=True)
            out[f"small {label}"] = {"card": [r[i] for r in runs_card],
                                     "cpu": [r[i] for r in runs_cpu], "worst": worst}

    # (d) the worker with an ep payload, the card's gang against the CPU's.
    final = float(worker_card["annotations"].get(FINAL_LOSS, "nan"))
    want = float(worker_cpu["annotations"].get(FINAL_LOSS, "nan"))
    check(worker_card["terminal_state"] == "Completed" == worker_cpu["terminal_state"]
          and len(worker_card["results"] or []) == EP and abs(final - want) <= 1e-4,
          f"ep (d) lm-moe-dropless.yaml's payload at mesh {{ep: 2}} through WorkloadRunner as "
          f"{EP} worker processes on the card: {worker_card['terminal_state']} in "
          f"{worker_card['seconds']:.1f} s, final loss {final} vs the CPU gang's {want}")
    for line in worker_card["results"] or []:
        print(f"  ep (d) rank {line['process_id']}: mesh {line['mesh']}, kernel launches "
              f"{line['kernel_launches']}", flush=True)
    out["workload"] = {"card": worker_card, "cpu": worker_cpu}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 18: {out['seconds']:.1f} s (kernel checks {out['kernels_s']:.1f}, reference "
          f"and CPU gangs at once {out['references_s']:.1f}, timed gang "
          f"{out['timed_gang_s']:.1f}, and beside it the small f32 and worker gangs "
          f"{out['untimed_s']:.1f})", flush=True)
    results["ep"] = out


def ep_launches(results) -> dict:
    """Phase 18's launches of each kernel entry: rank 0's first step of (b)
    (bf16 flash and grouped), the small f32 configs' (c) (f32 flash and
    grouped), and rank 0's whole run of (d)."""
    ep = results.get("ep") or {}

    def first(key):
        runs = ep.get(key) or {}
        ranks = runs.get("ranks") or runs.get("card") or [{}]
        return ranks[0].get("launches") or {}

    lines = ((ep.get("workload") or {}).get("card") or {}).get("results") or [{}]
    whole = lines[0].get("kernel_launches") or {}
    b = first("moe_ep2")
    labels = list(ep_small_configs())
    dropless = [label for label in labels if "dropless" in label]
    run_d = "lm-moe-dropless.yaml at {ep: 2}, rank 0's run"
    return {
        "flash_block": {"MoE ep=2 step": b.get("TENSOR_CORE_LAUNCHES")},
        "flash_block_f32": {**{f"small f32 {label} step": first(f"small {label}").get(
            "F32_LAUNCHES") for label in labels}, run_d: whole.get("F32_LAUNCHES")},
        "flash_block_tile_classes": {"MoE ep=2 first step": b.get("TILE_CLASS_LAUNCHES")},
        "flash_block_backward": {"MoE ep=2 step": b.get("BACKWARD_LAUNCHES")},
        "flash_block_backward_f32": {**{f"small f32 {label} step": f32_backward_by_variant(
            first(f"small {label}")) for label in labels}, run_d: f32_backward_by_variant(whole)},
        "grouped_matmul": {"MoE ep=2 step": b.get("GROUPED_LAUNCHES")},
        "grouped_matmul_dgrad": {"MoE ep=2 step": b.get("GROUPED_DGRAD_LAUNCHES")},
        "grouped_matmul_wgrad": {"MoE ep=2 step": b.get("GROUPED_WGRAD_LAUNCHES")},
        **{name: {**{f"small f32 {label} step": first(f"small {label}").get(counter)
                     for label in dropless}, run_d: whole.get(counter)}
           for name, counter in (("grouped_matmul_f32", "GROUPED_F32_LAUNCHES"),
                                 ("grouped_matmul_dgrad_f32", "GROUPED_DGRAD_F32_LAUNCHES"),
                                 ("grouped_matmul_wgrad_f32", "GROUPED_WGRAD_F32_LAUNCHES"))},
    }


def ep_rank_times(results) -> dict:
    """(a)'s times by kernel entry: each product at an ep rank's shapes
    beside ep = 1."""
    times = ((results.get("ep") or {}).get("kernels") or {}).get("times") or {}
    names = {("forward", "bf16"): "grouped_matmul", ("forward", "f32"): "grouped_matmul_f32",
             ("dgrad", "bf16"): "grouped_matmul_dgrad", ("dgrad", "f32"): "grouped_matmul_dgrad_f32",
             ("wgrad", "bf16"): "grouped_matmul_wgrad", ("wgrad", "f32"): "grouped_matmul_wgrad_f32"}
    out: dict = {}
    for key, t in times.items():
        which, tag, product = key.split()
        out.setdefault(names[(which, tag)], {})[product] = t
    return out


def phase_ep_apart(results):
    """Phase 18 in a process of its own (`--ep-only`), this process's cached
    blocks handed back to the card first."""
    import tempfile

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ep.json")
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--ep-only",
                              "--out", path], capture_output=True, text=True, timeout=600)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 18 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return
        with open(path) as f:
            results["ep"] = json.load(f).get("ep")


# ---------------------------------------------------------------------------
# Phase 19: serving over a mesh
# ---------------------------------------------------------------------------

# (b) the dense flagship at tp = 2, all 8 layers; (c) the MoE flagship at
# dp 2 x tp 2, 2 of its 8 layers (full width, cut in depth); (d) the dense
# flagship's forward at pp = 2, 4 of its 8 layers in 4 microbatches.
MS_TP, MS_MOE_LAYERS, MS_PP_LAYERS, MS_PP_MICRO = 2, 2, 4, 4
MS_TEMPERATURE, MS_TOP_K = 0.9, 4
MS_TTFT_REPEATS = 3
# (a): a tp = 2 rank's int8 decode products, name -> (rows, K, the widths
# that share x, the split of the whole weight over tp, experts (0: a 2-D
# weight), x shared by the experts). The dense flagship serves B = 8 rows
# at dp = 1, the MoE flagship B / dp = 4 a rank.
MS_INT8 = {
    "wqkv": (BATCH, 1024, (512, 512, 512), "column", 0, False),
    "wo": (BATCH, 512, (1024,), "row", 0, False),
    "w1": (BATCH, 1024, (2048,), "column", 0, False),
    "w2": (BATCH, 2048, (1024,), "row", 0, False),
    "unembed": (BATCH, 1024, (16000,), "column", 0, False),
    "we1": (BATCH // 2, 1024, (MOE_D_FF // MS_TP,), "column", MOE_EXPERTS, True),
    "we2": (BATCH // 2, MOE_D_FF // MS_TP, (1024,), "row", MOE_EXPERTS, False),
}
# A row-parallel product's tp partial sums, each rounded to bf16, added in
# f32, against the whole weight's product (one bf16 rounding): per element
# |p0 + p1 - full| <= 2^-7 (|p0| + |p1| + |full|) + 1e-4 max|full| (three
# roundings of at most half a bf16 ulp, an ulp at most 2^-7 of the value,
# and f32 sums in another order).
MS_ROW_REL, MS_ROW_ABS = 2.0 ** -7, 1e-4
# (e) and (d)'s small f32 configs: phase 15's small GQA config (TF32 off),
# B=4, prompt 40, 6 new tokens; its forward at B=4, T=64.
MS_SMALL_BATCH, MS_SMALL_PROMPT, MS_SMALL_NEW, MS_SMALL_SEQ = 4, 40, 6, 64
# The f32 forward at sp 2 and ep 2 against one process on the card: the
# f32 kernels' tolerance (phase 3), max|d| <= 1e-4 max|ref|.
MS_F32_REL = 1e-4
# The range that marks a rank's traced TTFT call.
MS_CALL_RANGE = "mesh generate call"


def ms_shard(qt, split, rank):
    """A tp rank's contiguous shard of an int8 weight quantized whole: its
    rows ("row", the scales whole) or its columns ("column")."""
    from jobset_tpu_torch.models import quant

    if split == "row":
        k = qt.q.shape[-2] // MS_TP
        return quant.QuantizedTensor(qt.q[..., rank * k:(rank + 1) * k, :].contiguous(),
                                     qt.scale.contiguous())
    n = qt.q.shape[-1] // MS_TP
    return quant.QuantizedTensor(qt.q[..., rank * n:(rank + 1) * n].contiguous(),
                                 qt.scale[..., rank * n:(rank + 1) * n].contiguous())


def ms_int8_case(name, dtype=torch.bfloat16) -> dict:
    """(a): one product of MS_INT8 at both tp = 2 ranks, each weight the
    rank's shard of a weight quantized whole, against the plain version
    (the int8 tolerance, one launch a rank); a row-parallel product's two
    partial sums against the whole weight's product (MS_ROW_REL). Returns
    the worst errors."""
    from jobset_tpu_torch.models import quant
    from jobset_tpu_torch.ops import int8_matmul as i8

    rows, k, ns, split, experts, shared = MS_INT8[name]
    gen = torch.Generator(device="cuda").manual_seed(1900 + k + sum(ns))
    lead = (experts,) if experts else ()
    whole_k = k * MS_TP if split == "row" else k
    whole_ns = ns if split == "row" else [n * MS_TP for n in ns]
    wholes = [quant.quantize_int8(torch.randn((*lead, whole_k, n), generator=gen, device="cuda")
                                  / whole_k ** 0.5) for n in whole_ns]
    x_lead = ((1 if shared else experts),) if experts else ()
    x = torch.randn((*x_lead, rows, whole_k), generator=gen, device="cuda").to(dtype)
    worst, parts = 0.0, []
    for rank in range(MS_TP):
        local = [ms_shard(qt, split, rank) for qt in wholes]
        xr = x[..., rank * k:(rank + 1) * k].contiguous() if split == "row" else x
        before = i8.INT8_LAUNCHES
        if experts:
            got = [i8.int8_matmul_experts(xr, local[0], dtype)]
        else:
            got = i8.int8_matmul_group(xr, local, dtype)
        launched = i8.INT8_LAUNCHES - before
        torch.cuda.synchronize()
        with f32_accumulating_plain():
            wants = ([i8.int8_matmul_experts_plain(xr, local[0], dtype)] if experts
                     else i8.int8_matmul_group_plain(xr, local, dtype))
        within = True
        for y, want in zip(got, wants):
            err = (y.float() - want.float()).abs()
            limit = INT8_REL_BF16 * want.float().abs() + INT8_ABS[dtype] * want.float().abs().max()
            within = within and bool((err <= limit).all())
            worst = max(worst, err.max().item())
        check(launched == 1 and all(bool(torch.isfinite(y.float()).all()) for y in got),
              f"mesh (a) int8 {name} tp rank {rank}: one launch, finite")
        check(within, f"mesh (a) int8 {name} tp rank {rank} ({list(xr.shape)} x "
                      f"{list(local[0].shape)}): within the int8 tolerance of the plain version "
                      f"(max|d| {worst:.3e})")
        parts.append(got[0].float())
    out = {"max_abs_err": worst}
    if split == "row":
        whole = (i8.int8_matmul_experts(x, wholes[0], dtype) if experts
                 else i8.int8_matmul(x, wholes[0], dtype)).float()
        d = (parts[0] + parts[1] - whole).abs()
        limit = MS_ROW_REL * (parts[0].abs() + parts[1].abs() + whole.abs()) + \
            MS_ROW_ABS * whole.abs().max()
        out["row_sum_err"] = d.max().item()
        check(bool((d <= limit).all()),
              f"mesh (a) int8 {name}: the tp ranks' row-parallel products summed equal the "
              f"whole weight's within 2^-7 (|p0| + |p1| + |full|) + 1e-4 max|full| "
              f"(max|d| {out['row_sum_err']:.3e})")
    return out


def ms_int8_times(name, dtype=torch.bfloat16) -> dict:
    """(a)'s L2-cold times of one product of MS_INT8 at a tp = 2 rank's
    shape and at tp = 1's (the whole weight), with the rank's bound
    (bytes) and its plain version's and library call's times."""
    rows, k, ns, split, experts, shared = MS_INT8[name]
    whole = (k * MS_TP, ns) if split == "row" else (k, tuple(n * MS_TP for n in ns))
    if experts:
        rank = time_int8_experts(dtype, k, ns[0], shared, rows)
        one = time_int8_experts(dtype, whole[0], whole[1][0], shared, rows)
    else:
        rank, one = time_int8(rows, k, ns, dtype), time_int8(rows, *whole, dtype)
    return {"rows": rows, "k": k, "ns": list(ns), "experts": experts, "ms": rank["ms"],
            "plain_ms": rank["plain_ms"], "library_ms": rank["library_ms"],
            "bound_ms": rank["bound_ms"], "bound_by": "bytes", "tp1_ms": one["ms"],
            "tp1_bound_ms": one["bound_ms"]}


def ms_kernel_checks(card) -> dict:
    """(a): every product of MS_INT8 checked, then timed beside tp = 1."""
    errs, times = {}, {}
    for name in MS_INT8:
        errs[name] = ms_int8_case(name)
    for name in MS_INT8:
        times[name] = t = ms_int8_times(name)
        rows, k, ns, _, experts, _ = MS_INT8[name]
        shape = f"[{experts}, {k}, {sum(ns)}]" if experts else f"[{k}, {sum(ns)}]"
        print(f"  mesh (a) int8 {name} at a tp=2 rank, x [{rows}, {k}] x int8 {shape}: "
              f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes, "
              f"{t['bound_ms'] / t['ms']:.1%}), plain {t['plain_ms']:.4f}, torch.matmul on the "
              f"bf16 weight {t['library_ms']:.4f}; the same call at tp = 1 {t['tp1_ms']:.4f} ms "
              f"(bound {t['tp1_bound_ms']:.4f}) ({card})", flush=True)
    return {"errors": errs, "times": times}


def ms_margins(logits) -> torch.Tensor:
    """Each row's top-2 margin of logits [B, V] (f32, CPU)."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu()


def ms_reference(cfg, params, prompt, new, quantized=False, quantized_kv=False,
                 device="cuda") -> dict:
    """One process's `generate` on the card, greedy, and what the gangs are
    held to: its tokens, the prefill's last-position logits, and each new
    position's top-2 margin and largest |logit| (the same steps again on
    its own tokens: `_prefill_logits`, then `_token_logits`)."""
    from jobset_tpu_torch.models import build_generate, decode

    tokens = build_generate(cfg, new, device, quantized=quantized, quantized_kv=quantized_kv)(
        params, prompt)
    cast = decode.cast_params(params, cfg.dtype)
    t = prompt.shape[1]
    cache = decode.init_kv_cache(cfg, prompt.shape[0], t + new, device, quantized_kv=quantized_kv)
    logits = decode._prefill_logits(cast, prompt, cache, cfg)
    prefill = logits.cpu()
    margins, peaks = [ms_margins(logits)], [logits.abs().amax(dim=-1).cpu()]
    for pos in range(t, t + new - 1):
        logits = decode._token_logits(cast, tokens[:, pos], cache, pos, cfg)
        margins.append(ms_margins(logits))
        peaks.append(logits.abs().amax(dim=-1).cpu())
    return {"tokens": tokens.cpu(), "prefill": prefill, "margins": torch.stack(margins, 1),
            "peaks": torch.stack(peaks, 1)}


def ms_serve_job(job, mesh, device) -> dict:
    """One serving job of a phase 19 rank: `build_generate` over the mesh
    from the parameters of job["seed"] (drawn whole, int8 quantized whole,
    then cut to the rank's shards), the rank's dp rows of the prompt. For
    each variant (name, quantized, quantized_kv, temperature, top_k): its
    tokens, and its launches of one call (counts set to 0 just before,
    read just after; the mask cache emptied first); for greedy variants
    with job["prefill"], the prefill's last-position logits gathered over
    tp (tp rank 0 keeps them). With job["timed"]: TTFT and generate medians
    and a generate call of the first variant, and one of its TTFT calls
    traced."""
    from jobset_tpu_torch.convert import shard_params
    from jobset_tpu_torch.models import build_generate, decode, init_params
    from jobset_tpu_torch.models import quantize_params_for_serving
    from jobset_tpu_torch.parallel.collectives import gather
    from jobset_tpu_torch.runtime.runner import batch_rows

    cfg = job["cfg"]
    t0 = time.perf_counter()
    draw = "cpu" if job.get("draw_on_cpu") else device
    full = init_params(cfg, torch.Generator(device=draw).manual_seed(job["seed"]), device)
    trees = {False: shard_params(full, cfg, mesh)}
    if any(v[1] for v in job["variants"]):
        trees[True] = shard_params(quantize_params_for_serving(full), cfg, mesh)
    del full
    prompt = token_prompt(cfg.vocab_size, job["batch"], job["prompt"], job["prompt_seed"])
    rows = batch_rows(job["batch"], mesh.size("dp"), mesh.index("dp"))
    mine = prompt[rows].to(device)
    sync(device)
    out = {"rank": mesh.rank, "coords": mesh.coords, "variants": {},
           "seconds": {"parameters": time.perf_counter() - t0}}
    for name, quantized, quantized_kv, temperature, top_k in job["variants"]:
        t0 = time.perf_counter()
        flags = dict(quantized=quantized, quantized_kv=quantized_kv, mesh=mesh)
        generate = build_generate(cfg, job["new"], device, temperature=temperature,
                                  top_k=top_k, **flags)
        params = trees[quantized]
        empty_mask_cache()
        sync(device)
        reset_moe_launches()
        generator = torch.Generator(device=device).manual_seed(7) if temperature else None
        tokens = generate(params, mine, generator)
        sync(device)
        got = {"tokens": tokens.cpu(), "launches": moe_launches_now()}
        if job.get("prefill") and not temperature:
            cast = decode.cast_params(params, cfg.dtype)
            cache = decode.init_kv_cache(cfg, len(rows), job["prompt"] + 1, device,
                                         quantized_kv=quantized_kv, mesh=mesh)
            logits = gather(decode._prefill_logits(cast, mine, cache, cfg, mesh), -1,
                            mesh.group("tp"))
            if mesh.index("tp") == 0:
                got["prefill"] = logits.cpu()
            del cast, cache, logits
        sync(device)
        out["variants"][name] = got
        out["seconds"][name] = time.perf_counter() - t0
    if job.get("timed"):
        t0 = time.perf_counter()
        name, quantized, quantized_kv, _, _ = job["variants"][0]
        flags = dict(quantized=quantized, quantized_kv=quantized_kv, mesh=mesh)
        generate = build_generate(cfg, job["new"], device, **flags)
        first = build_generate(cfg, 1, device, **flags)
        params = trees[quantized]

        def wall(fn):
            sync(device)
            t0 = time.perf_counter()
            fn(params, mine)
            sync(device)
            return time.perf_counter() - t0

        ttft = sorted(wall(first) for _ in range(MS_TTFT_REPEATS))
        gen_s = wall(generate)  # the counted calls above warmed the path
        out["timed"] = {"variant": name, "ttft_s": ttft[len(ttft) // 2], "ttft_s_runs": ttft,
                        "generate_s": gen_s, "tokens_per_s": len(rows) * job["new"] / gen_s}
        from torch.profiler import ProfilerActivity, profile, record_function

        sync(device)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        # Two TTFT calls under the profiler, the second kept: the first
        # takes the profiler's start-up, the ranks' included.
        kept = []
        with profile(activities=activities,
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.append(list(p.events()))) as prof:
            for _ in range(2):
                with record_function(MS_CALL_RANGE):
                    first(params, mine)
                    sync(device)
                prof.step()
        out["timed"].update(collective_trace(kept[0], MS_CALL_RANGE))
        out["seconds"]["timed"] = time.perf_counter() - t0
    return out


def ms_forward_job(job, mesh, device) -> dict:
    """One forward job of a phase 19 rank: `build_forward` over the mesh
    from the parameters of job["seed"] (stacked for the mesh's pp, cut to
    the rank's shards) on its dp rows and sp chunk of job["batch"] x
    job["seq"] tokens; its launches (counts set to 0 just before, read just
    after), and its block against one process's logits (job["reference"]:
    a file, or the array), as max|d| and mean|d| beside max|ref| and
    mean|ref| over the block."""
    from jobset_tpu_torch.convert import shard_params
    from jobset_tpu_torch.models import build_forward, init_params
    from jobset_tpu_torch.runtime.data import sequence_shard
    from jobset_tpu_torch.runtime.runner import batch_rows

    cfg = job["cfg"]
    draw = "cpu" if job.get("draw_on_cpu") else device
    full = init_params(cfg, torch.Generator(device=draw).manual_seed(job["seed"]), device,
                       mesh.config)
    local = shard_params(full, cfg, mesh)
    del full
    tokens = token_prompt(cfg.vocab_size, job["batch"], job["seq"], job["prompt_seed"])
    rows = batch_rows(job["batch"], mesh.size("dp"), mesh.index("dp"))
    cols = sequence_shard(job["seq"], mesh.size("sp"), mesh.index("sp"))
    forward = build_forward(cfg, device, mesh)
    empty_mask_cache()
    sync(device)
    reset_moe_launches()
    logits = forward(local, tokens[rows][:, cols].to(device))
    sync(device)
    out = {"rank": mesh.rank, "coords": mesh.coords, "launches": moe_launches_now(),
           "shape": list(logits.shape)}
    ref = job["reference"]
    if isinstance(ref, str):
        ref = torch.load(ref, map_location="cpu", mmap=True, weights_only=True)
    v = logits.shape[-1]
    want = torch.as_tensor(ref)[rows][:, cols][..., mesh.index("tp") * v:(mesh.index("tp") + 1) * v]
    want = want.to(device).float()
    d = (logits.float() - want).abs()
    out.update(finite=bool(torch.isfinite(logits.float()).all()), max_d=d.max().item(),
               mean_d=d.mean().item(), ref_max=want.abs().max().item(),
               ref_mean=want.abs().mean().item())
    return out


def ms_rank(jobs: list, device=None) -> dict:
    """One rank of phase 19, in a process of its own (`gang.spawn`): each
    job ("serve" or "forward") over its mesh, laid over the gang's first
    ranks (a rank past a job's mesh returns None for it; jobs with one mesh
    shape share it), in turn, the card's cached blocks handed back between
    them; `device` the card unless it names the CPU (the CPU gang).
    Returns {"jobs": the results, "started": the wall clock when the body
    started, "job_s": each job's seconds}."""
    from jobset_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    started = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device or f"cuda:{torch.cuda.current_device()}")
    meshes, out, seconds = {}, [], []
    for job in jobs:
        t0 = time.perf_counter()
        key = tuple(sorted(job["mesh"].items()))
        if key not in meshes:
            meshes[key] = build_mesh(MeshConfig(**job["mesh"]), device, allow_submesh=True)
        run = ms_serve_job if job["kind"] == "serve" else ms_forward_job
        out.append(run(job, meshes[key], device) if meshes[key] is not None else None)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        seconds.append(time.perf_counter() - t0)
    return {"jobs": out, "started": started, "job_s": seconds}


def token_prompt(vocab, batch, seq, seed) -> torch.Tensor:
    """[batch, seq] int32 token ids from a CPU generator of `seed`, alike in
    every process."""
    return torch.randint(0, vocab, (batch, seq), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


def ms_hold_tokens(label, ranks, ref, variant, dp) -> dict:
    """A greedy variant of a gang against one process: the prefill's
    last-position logits (gathered over tp) within phase 4's bf16 bounds,
    the tokens equal on every tp rank of a dp row and equal to one
    process's up to, in each row, the first new position where one
    process's top-2 margin is under that bound (LOGITS_MAX_REL of its
    largest |logit| there). Returns that position and the first where the
    tokens part, by row."""
    rows_of = {}
    for r in ranks:
        got = r["variants"][variant]
        rows_of.setdefault(r["coords"]["dp"], []).append(got)
    check(all(torch.equal(g["tokens"], gs[0]["tokens"]) for gs in rows_of.values() for g in gs),
          f"{label}: every tp rank of a dp row returns the same tokens")
    tokens = torch.cat([rows_of[i][0]["tokens"] for i in range(dp)])
    prefill = torch.cat([next(g["prefill"] for g in rows_of[i] if "prefill" in g)
                         for i in range(dp)])
    d = (prefill.float() - ref["prefill"].float()).abs()
    want = ref["prefill"].float().abs()
    peak, mean = want.max().item(), want.mean().item()
    max_d = d.max().item()
    check(bool(torch.isfinite(prefill).all()) and max_d <= LOGITS_MAX_REL * peak
          and d.mean().item() <= LOGITS_MEAN_REL * mean,
          f"{label}: prefill last-position logits gathered over tp against one process's: "
          f"max|d| {max_d:.4g}, mean|d| {d.mean().item():.4g} (bounds {LOGITS_MAX_REL} of max|ref| "
          f"{peak:.4g}, {LOGITS_MEAN_REL} of mean|ref| {mean:.4g})")
    t = ref["tokens"].shape[1] - ref["margins"].shape[1]
    low = ref["margins"] < LOGITS_MAX_REL * ref["peaks"]
    new = ref["margins"].shape[1]
    first_low = [int(row.nonzero()[0]) if row.any() else new for row in low]
    parted = (tokens[:, t:] != ref["tokens"][:, t:])
    first_part = [int(row.nonzero()[0]) if row.any() else new for row in parted]
    check(tokens.shape == ref["tokens"].shape and torch.equal(tokens[:, :t], ref["tokens"][:, :t])
          and all(p >= q for p, q in zip(first_part, first_low)),
          f"{label}: tokens equal one process's in each row up to its first new position whose "
          f"top-2 margin is under {LOGITS_MAX_REL} of its largest |logit| (rows' such "
          f"positions {first_low}; rows part at {first_part}, {new} = never)")
    print(f"  {label}: prefill max|d| {max_d:.4g}; first new position with a top-2 margin under "
          f"the bound, by row: {first_low}; first position where the tokens part: {first_part}",
          flush=True)
    return {"prefill_max_abs_diff": max_d, "first_low_margin": first_low,
            "first_parted": first_part}


def ms_plain(tree):
    """A rank's result without its tensors (tokens, logits), for the JSON
    results."""
    if isinstance(tree, dict):
        return {k: ms_plain(v) for k, v in tree.items() if not torch.is_tensor(v)}
    if isinstance(tree, list):
        return [ms_plain(v) for v in tree]
    return tree


def ms_print_rank(label, r, card, dp_rows) -> None:
    print(f"  {label} rank {r['rank']}: seconds by part "
          f"{ {k: round(v, 1) for k, v in r['seconds'].items()} }", flush=True)
    t = r.get("timed")
    counts = next(iter(r["variants"].values()))["launches"]
    line = (f"  {label} rank {r['rank']} {r['coords']}: one generate call launches flash bf16 "
            f"{counts['TENSOR_CORE_LAUNCHES']}, f32 {counts['F32_LAUNCHES']}, tile-class "
            f"{counts['TILE_CLASS_LAUNCHES']}, int8 {counts['INT8_LAUNCHES']}, grouped "
            f"{counts['GROUPED_LAUNCHES']} (TMA {counts['GROUPED_TMA_LAUNCHES']})")
    if t:
        busy = ("not measured" if t["device_busy_share"] is None
                else f"{t['device_busy_share']:.1%}")
        line += (f"; {t['variant']}: TTFT median {t['ttft_s'] * 1e3:.1f} ms "
                 f"({t['ttft_s_runs'][0] * 1e3:.1f}-{t['ttft_s_runs'][-1] * 1e3:.1f}), a generate "
                 f"call {t['generate_s']:.3f} s, {t['tokens_per_s']:.1f} new tokens/s for its "
                 f"{dp_rows} rows; a traced TTFT call {t['traced_step_ms']:.1f} ms: collectives' host "
                 f"spans {t['collective_share']:.1%} ({t['collective_calls']} calls), card busy "
                 f"{busy} (ranks sharing one card on gloo: no scaling figure; {card})")
    print(line, flush=True)


def ms_check_launches(label, counts, flash, tile, int8, grouped=0, f32=False) -> None:
    key = "F32_LAUNCHES" if f32 else "TENSOR_CORE_LAUNCHES"
    want = {key: flash, "TILE_CLASS_LAUNCHES": tile, "INT8_LAUNCHES": int8,
            "GROUPED_LAUNCHES": grouped}
    if not f32:
        want["GROUPED_TMA_LAUNCHES"] = grouped
    got = {k: counts[k] for k in want}
    check(got == want, f"{label}: one call's launches {got} (expected {want})")


def phase_mesh_serving(results):
    """Phase 19: serving and the forward over a mesh. (a) the int8 kernel
    at a tp = 2 rank's products; (b) the dense flagship at tp = 2, 8
    layers, bf16 and int8 (weights and cache), against one process; (c)
    the MoE flagship at dp 2 x tp 2, 2 layers, int8 weights, against one
    process; (d) the dense flagship's forward at pp = 2 (4 layers, 4
    microbatches) against one process, and a small f32 config's at sp = 2
    (ring) and ep = 2 (dropless); (e) small f32 configs' tokens at tp 2
    and dp 2 x tp 2 against the port's CPU gang. The CPU gang runs while
    this process takes the references on the card; then one gang of 4 on
    the card runs every job (those over 2 ranks on ranks 0 and 1)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from dataclasses import replace

    from jobset_tpu_torch.models import build_forward, init_params, quantize_params_for_serving
    from jobset_tpu_torch.runtime import gang

    card = results["card"]
    t_phase = time.perf_counter()
    out: dict = {}
    t0 = time.perf_counter()
    out["kernels"] = ms_kernel_checks(card)
    out["kernels_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    dense = flagship_config()
    moe = replace(moe_config(), n_layers=MS_MOE_LAYERS)
    pp_cfg = replace(flagship_config(), n_layers=MS_PP_LAYERS, n_microbatches=MS_PP_MICRO)
    small = gang_small_config()
    small_moe = replace(small, n_experts=4, d_ff_expert=64, moe_top_k=2, moe_dispatch="dropless")
    greedy = ("bf16", False, False, 0.0, 0)
    int8_both = ("int8 weights + int8 cache", True, True, 0.0, 0)
    dense_job = {"kind": "serve", "cfg": dense, "mesh": {"tp": MS_TP}, "seed": 0,
                 "batch": BATCH, "prompt": PROMPT, "new": NEW_TOKENS, "prompt_seed": 19,
                 "prefill": True, "timed": True,
                 "variants": [greedy, int8_both, ("top_k 1", False, False, MS_TEMPERATURE, 1),
                              ("sampled", False, False, MS_TEMPERATURE, MS_TOP_K)]}
    moe_job = {"kind": "serve", "cfg": moe, "mesh": {"dp": 2, "tp": MS_TP}, "seed": 0,
               "batch": BATCH, "prompt": PROMPT, "new": NEW_TOKENS, "prompt_seed": 20,
               "prefill": True, "timed": True,
               "variants": [("int8 weights", True, False, 0.0, 0),
                            ("int8 sampled", True, False, MS_TEMPERATURE, MS_TOP_K)]}
    small_variants = [greedy, int8_both]

    def small_job(mesh):
        return {"kind": "serve", "cfg": small, "mesh": mesh, "seed": 0, "draw_on_cpu": True,
                "batch": MS_SMALL_BATCH, "prompt": MS_SMALL_PROMPT, "new": MS_SMALL_NEW,
                "prompt_seed": 21, "variants": small_variants}

    small_jobs = [small_job({"tp": MS_TP}), small_job({"dp": 2, "tp": MS_TP})]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(4) as pool:
        t0 = time.perf_counter()
        cpu = pool.submit(gang.spawn, ms_rank, 4, (small_jobs, "cpu"), backend="gloo",
                          device="cpu", timeout_s=GANG_TIMEOUT_S, threads=0)
        # The references, one process on the card (this one).
        refs = {}
        params = init_params(dense, torch.Generator(device="cuda").manual_seed(0))
        prompt = token_prompt(dense.vocab_size, BATCH, PROMPT, 19).cuda()
        refs["dense bf16"] = ms_reference(dense, params, prompt, NEW_TOKENS)
        refs["dense int8"] = ms_reference(dense, quantize_params_for_serving(params), prompt,
                                          NEW_TOKENS, quantized=True, quantized_kv=True)
        del params
        params = init_params(moe, torch.Generator(device="cuda").manual_seed(0))
        prompt = token_prompt(moe.vocab_size, BATCH, PROMPT, 20).cuda()
        refs["moe int8"] = ms_reference(moe, quantize_params_for_serving(params), prompt,
                                        NEW_TOKENS, quantized=True)
        del params
        params = init_params(pp_cfg, torch.Generator(device="cuda").manual_seed(0))
        pp_path = os.path.join(tmp, "pp_logits.pt")
        torch.save(build_forward(pp_cfg)(params, token_prompt(pp_cfg.vocab_size, BATCH, PROMPT,
                                                               22).cuda()).cpu(), pp_path)
        del params
        small_refs = {}
        for label, cfg in (("sp", small), ("ep", small_moe)):
            p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
            small_refs[label] = build_forward(cfg)(p, token_prompt(
                cfg.vocab_size, MS_SMALL_BATCH, MS_SMALL_SEQ, 23).cuda()).cpu()
        torch.cuda.empty_cache()
        cpu = [r["jobs"] for r in cpu.result()]
        out["references_s"] = time.perf_counter() - t0

        # One gang of 4 on the card: the jobs over 2 ranks run on ranks 0
        # and 1 while ranks 2 and 3 wait (a spawn costs more than the jobs).
        t0 = time.perf_counter()
        forward_jobs = [
            {"kind": "forward", "cfg": pp_cfg, "mesh": {"pp": 2}, "seed": 0, "batch": BATCH,
             "seq": PROMPT, "prompt_seed": 22, "reference": pp_path},
            {"kind": "forward", "cfg": small, "mesh": {"sp": 2}, "seed": 0, "draw_on_cpu": True,
             "batch": MS_SMALL_BATCH, "seq": MS_SMALL_SEQ, "prompt_seed": 23,
             "reference": small_refs["sp"]},
            {"kind": "forward", "cfg": small_moe, "mesh": {"ep": 2}, "seed": 0,
             "draw_on_cpu": True, "batch": MS_SMALL_BATCH, "seq": MS_SMALL_SEQ,
             "prompt_seed": 23, "reference": small_refs["ep"]}]
        ranks = gang.spawn(ms_rank, 4, ([dense_job] + forward_jobs + [moe_job] + small_jobs,),
                           backend="gloo", device="cuda", timeout_s=GANG_TIMEOUT_S, threads=0)
        out["gang_s"] = time.perf_counter() - t0
        out["gang_start_s"] = min(r["started"] for r in ranks) - (time.time() - out["gang_s"])
        out["job_s"] = ranks[0]["job_s"]
        print(f"  mesh gang of 4: its first rank's body began {out['gang_start_s']:.1f} s "
              f"after the spawn; rank 0's jobs took {[round(t, 1) for t in out['job_s']]} s "
              "(dense tp 2, forward pp 2, sp 2, ep 2, MoE dp 2 x tp 2, small tp 2, small "
              "dp 2 x tp 2)", flush=True)
    jobs = [r["jobs"] for r in ranks]
    two = [r[:4] + [r[5]] for r in jobs[:2]]  # dense tp 2, the forwards, small tp 2
    four = [[r[4], r[6]] for r in jobs]  # MoE and small at dp 2 x tp 2

    # (b) the dense flagship at tp 2.
    dense_ranks = [r[0] for r in two]
    label = (f"mesh (b) dense flagship tp=2 (8 heads of 64 a rank), {LAYERS} layers, B={BATCH} "
             f"prompt {PROMPT} new {NEW_TOKENS}")
    out["dense_tp2"] = {"bf16": ms_hold_tokens(f"{label} bf16", dense_ranks, refs["dense bf16"],
                                               "bf16", 1),
                        "int8": ms_hold_tokens(f"{label} int8 weights + int8 cache", dense_ranks,
                                               refs["dense int8"], "int8 weights + int8 cache", 1)}
    for r in dense_ranks:
        v = r["variants"]
        check(torch.equal(v["top_k 1"]["tokens"], v["bf16"]["tokens"]),
              f"{label} rank {r['rank']}: top_k 1 at temperature {MS_TEMPERATURE} equals greedy")
        s = v["sampled"]["tokens"]
        check(tuple(s.shape) == (BATCH, PROMPT + NEW_TOKENS)
              and torch.equal(s[:, :PROMPT], refs["dense bf16"]["tokens"][:, :PROMPT])
              and bool(((s >= 0) & (s < dense.vocab_size)).all())
              and torch.equal(s, dense_ranks[0]["variants"]["sampled"]["tokens"])
              and not torch.equal(s, v["bf16"]["tokens"]),
              f"{label} rank {r['rank']}: sampled (temperature {MS_TEMPERATURE}, top_k "
              f"{MS_TOP_K}) tokens in the vocab, the same on both tp ranks, off the greedy path")
        ms_check_launches(f"{label} bf16 rank {r['rank']}", v["bf16"]["launches"],
                          GENERATE_LAUNCHES, 2, 0)
        ms_check_launches(f"{label} int8 rank {r['rank']}",
                          v["int8 weights + int8 cache"]["launches"], GENERATE_LAUNCHES, 2,
                          INT8_GENERATE_LAUNCHES)
        ms_print_rank("mesh (b)", r, card, BATCH)
    out["dense_tp2"]["ranks"] = ms_plain(dense_ranks)

    # (c) the MoE flagship at dp 2 x tp 2.
    moe_ranks = [r[0] for r in four]
    label = (f"mesh (c) MoE flagship dp=2 x tp=2 (we1 [{MOE_EXPERTS}, 1024, "
             f"{MOE_D_FF // MS_TP}] a rank), {MS_MOE_LAYERS} layers, int8 weights, B={BATCH}")
    out["moe_dp2_tp2"] = {"int8": ms_hold_tokens(label, moe_ranks, refs["moe int8"],
                                                 "int8 weights", 2), "ranks": ms_plain(moe_ranks)}
    moe_int8 = 1 + (NEW_TOKENS - 1) * (4 * MS_MOE_LAYERS + 1)
    for r in moe_ranks:
        ms_check_launches(f"{label} rank {r['rank']}", r["variants"]["int8 weights"]["launches"],
                          3 * MS_MOE_LAYERS, 2, moe_int8, 2 * MS_MOE_LAYERS)
        s = r["variants"]["int8 sampled"]["tokens"]
        peers = [o for o in moe_ranks if o["coords"]["dp"] == r["coords"]["dp"]]
        check(bool(((s >= 0) & (s < moe.vocab_size)).all())
              and torch.equal(s, peers[0]["variants"]["int8 sampled"]["tokens"]),
              f"{label} rank {r['rank']}: sampled tokens in the vocab, the same on its tp peer")
        ms_print_rank("mesh (c)", r, card, BATCH // 2)

    # (d) the forward over pp, sp and ep.
    for i, (label, bound) in enumerate(((f"mesh (d) dense flagship forward pp=2, {MS_PP_LAYERS} "
                                         f"layers, {MS_PP_MICRO} microbatches, B={BATCH} "
                                         f"T={PROMPT} bf16", None),
                                        ("mesh (d) small f32 forward sp=2 (ring)", MS_F32_REL),
                                        ("mesh (d) small f32 MoE forward ep=2 (dropless)",
                                         MS_F32_REL)), start=1):
        for r in (x[i] for x in two):
            ok = (r["max_d"] <= LOGITS_MAX_REL * r["ref_max"]
                  and r["mean_d"] <= LOGITS_MEAN_REL * r["ref_mean"] if bound is None
                  else r["max_d"] <= bound * r["ref_max"])
            check(r["finite"] and ok, f"{label} rank {r['rank']} {r['coords']}: its block "
                  f"{r['shape']} against one process's: max|d| {r['max_d']:.4g} mean|d| "
                  f"{r['mean_d']:.4g} (ref max {r['ref_max']:.4g}, mean {r['ref_mean']:.4g})")
        out[label] = ms_plain([x[i] for x in two])
    for r in (x[1] for x in two):
        ms_check_launches(f"mesh (d) pp=2 rank {r['rank']}", r["launches"],
                          MS_PP_LAYERS // 2 * MS_PP_MICRO, 1, 0)
    counts = [[x[i]["launches"][key] for x in two] for i, key in (
        (1, "TENSOR_CORE_LAUNCHES"), (2, "F32_LAUNCHES"), (3, "GROUPED_F32_LAUNCHES"))]
    print(f"  mesh (d) launches a rank's forward: pp=2 {counts[0]} bf16 flash; sp=2 "
          f"{counts[1]} f32 flash; ep=2 {counts[2]} f32 grouped", flush=True)

    # (e) the small f32 configs, the card's gangs against the CPU's.
    for label, card_ranks, cpu_ranks in (("tp=2", [x[-1] for x in two], [x[0] for x in cpu[:2]]),
                                         ("dp=2 x tp=2", [x[-1] for x in four],
                                          [x[1] for x in cpu])):
        for variant in ("bf16", "int8 weights + int8 cache"):
            got = [r["variants"][variant]["tokens"] for r in card_ranks]
            want = [r["variants"][variant]["tokens"] for r in cpu_ranks]
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"mesh (e) small f32 {label} {'f32' if variant == 'bf16' else variant}: every "
                  "rank's tokens on the card equal the CPU gang's")
        out[f"small {label}"] = ms_plain({"card": card_ranks, "cpu": cpu_ranks})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['seconds']:.1f} s (kernel checks {out['kernels_s']:.1f}, references "
          f"and the CPU gang at once {out['references_s']:.1f}, the card's gang "
          f"{out['gang_s']:.1f})", flush=True)
    results["mesh_serving"] = out


def ms_launches(results) -> dict:
    """Phase 19's launches of each kernel entry: rank 0's one call of each
    path."""
    ms = results.get("mesh_serving") or {}

    def variant(key, name):
        ranks = (ms.get(key) or {}).get("ranks") or [{}]
        return ((ranks[0].get("variants") or {}).get(name) or {}).get("launches") or {}

    def forward(label):
        return ((ms.get(label) or [{}])[0]).get("launches") or {}

    def small(label, name):
        ranks = (ms.get(f"small {label}") or {}).get("card") or [{}]
        return ((ranks[0].get("variants") or {}).get(name) or {}).get("launches") or {}

    b, b8 = variant("dense_tp2", "bf16"), variant("dense_tp2", "int8 weights + int8 cache")
    c = variant("moe_dp2_tp2", "int8 weights")
    pp = forward(f"mesh (d) dense flagship forward pp=2, {MS_PP_LAYERS} layers, {MS_PP_MICRO} "
                 f"microbatches, B={BATCH} T={PROMPT} bf16")
    sp = forward("mesh (d) small f32 forward sp=2 (ring)")
    ep = forward("mesh (d) small f32 MoE forward ep=2 (dropless)")
    s2, s4 = (small(label, "int8 weights + int8 cache") for label in ("tp=2", "dp=2 x tp=2"))
    return {
        "flash_block": {"dense tp=2 generate": b.get("TENSOR_CORE_LAUNCHES"),
                        "MoE dp=2 x tp=2 int8 generate": c.get("TENSOR_CORE_LAUNCHES"),
                        "dense pp=2 forward": pp.get("TENSOR_CORE_LAUNCHES")},
        "flash_block_f32": {"small f32 tp=2 int8 generate": s2.get("F32_LAUNCHES"),
                            "small f32 dp=2 x tp=2 int8 generate": s4.get("F32_LAUNCHES"),
                            "small f32 sp=2 forward": sp.get("F32_LAUNCHES"),
                            "small f32 MoE ep=2 forward": ep.get("F32_LAUNCHES")},
        "flash_block_tile_classes": {"dense tp=2 generate, first at its shape":
                                     b.get("TILE_CLASS_LAUNCHES"),
                                     "dense pp=2 forward": pp.get("TILE_CLASS_LAUNCHES")},
        "int8_matmul": {"dense tp=2 int8 generate": b8.get("INT8_LAUNCHES"),
                        "MoE dp=2 x tp=2 int8 generate": c.get("INT8_LAUNCHES"),
                        "small f32 tp=2 int8 generate": s2.get("INT8_LAUNCHES"),
                        "small f32 dp=2 x tp=2 int8 generate": s4.get("INT8_LAUNCHES")},
        "grouped_matmul": {"MoE dp=2 x tp=2 int8 generate": c.get("GROUPED_LAUNCHES")},
        "grouped_matmul_f32": {"small f32 MoE ep=2 forward": ep.get("GROUPED_F32_LAUNCHES")},
    }


def phase_mesh_serving_apart(results):
    """Phase 19 in a process of its own (`--mesh-serving-only`), this
    process's cached blocks handed back to the card first."""
    import tempfile

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh_serving.json")
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--mesh-serving-only",
                              "--out", path], capture_output=True, text=True, timeout=600)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr, flush=True)
        check(run.returncode == 0 and os.path.exists(path),
              f"phase 19 in a process of its own exits {run.returncode}")
        if not os.path.exists(path):
            return
        with open(path) as f:
            results["mesh_serving"] = json.load(f).get("mesh_serving")


def timed(results, label, fn, *args):
    """fn(*args), its wall seconds kept in results["phase_seconds"] and
    printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds = results.setdefault("phase_seconds", {})[label] = time.perf_counter() - t0
    print(f"{label}: {seconds:.1f} s by the script's clock", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the results as JSON to this file")
    only = parser.add_mutually_exclusive_group()
    only.add_argument("--solver-only", action="store_true",
                      help="build the auction kernel and run phase 9 alone (no result line)")
    only.add_argument("--flash-only", action="store_true",
                      help="build the flash block kernels and run phases 2-3 alone "
                           "(no result line)")
    only.add_argument("--control-only", action="store_true",
                      help="run phase 10 (the control plane's device programs) alone; "
                           "builds no kernel (no result line)")
    only.add_argument("--serving-only", action="store_true",
                      help="build the flash block and int8 kernels and run phase 11 "
                           "(int8 serving and sampling) alone (no result line)")
    only.add_argument("--moe-only", action="store_true",
                      help="build the flash block, int8 and grouped kernels and run phase 12 "
                           "(mixture-of-experts serving and forward) alone (no result line)")
    only.add_argument("--moe-train-only", action="store_true",
                      help="build the flash block and grouped kernels and run phase 13 "
                           "(mixture-of-experts training) alone (no result line)")
    only.add_argument("--workloads-only", action="store_true",
                      help="build the flash block kernels and run phase 14 (the mlp and cnn "
                           "workload kinds, adafactor, WorkloadRunner) alone (no result line)")
    only.add_argument("--gang-only", action="store_true",
                      help="build the flash block and grouped kernels and run phase 15 (gangs "
                           "of processes on torch.distributed) alone (no result line)")
    only.add_argument("--sp-only", action="store_true",
                      help="build the flash block kernels and run phase 16 (sequence "
                           "parallelism and ZeRO-1) alone (no result line)")
    only.add_argument("--pp-only", action="store_true",
                      help="build the flash block and grouped kernels and run phase 17 "
                           "(pipeline parallelism) alone (no result line)")
    only.add_argument("--ep-only", action="store_true",
                      help="build the flash block and grouped kernels and run phase 18 "
                           "(expert parallelism) alone (no result line)")
    only.add_argument("--mesh-serving-only", action="store_true",
                      help="build the flash block, int8 and grouped kernels and run phase 19 "
                           "(serving and the forward over a mesh) alone (no result line)")
    only.add_argument("--gang-f32-moe-batch", type=int, metavar="B",
                      help="build the flash block and grouped kernels and run phase 15's f32 "
                           "MoE gang alone at batch B, for its memory (no result line)")
    parser.add_argument("--int8-baseline", metavar="DIR",
                        help="another checkout of this repo (the parent commit): phase 11 "
                             "also times its int8 kernel on the same inputs")
    parser.add_argument("--flash-bwd-baseline", metavar="DIR",
                        help="another checkout of this repo (the parent commit): phase 7 (or "
                             "--flash-only) also times its flash block backward kernel on the "
                             "same inputs and holds its dq, dk and dv to this one's")
    parser.add_argument("--grouped-baseline", metavar="DIR",
                        help="another checkout of this repo (the parent commit): phases 12 "
                             "and 13 also time its grouped kernels on the same inputs, and "
                             "phase 13 holds its backward kernels' outputs to this one's bit "
                             "for bit")
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
    if args.control_only:
        phase_control(results)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        print(f"chip_smoke --control-only: {len(FAILURES)} check(s) failed, "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        for what in FAILURES:
            print(f"  FAILED: {what}", flush=True)
        return 1 if FAILURES else 0

    t0 = time.perf_counter()
    flash = ["flash_block", "flash_block_bwd"]
    sources = (["auction"] if args.solver_only
               else flash if args.flash_only or args.workloads_only or args.sp_only
               else flash + ["int8_matmul"] if args.serving_only
               else flash + ["int8_matmul", "grouped_matmul"] if (args.moe_only
                                                                  or args.mesh_serving_only)
               else flash + ["grouped_matmul"] if (args.moe_train_only or args.gang_only
                                                   or args.gang_f32_moe_batch
                                                   or args.pp_only or args.ep_only)
               else flash + ["auction", "int8_matmul", "grouped_matmul"])
    libraries = cuda_build.build_all(sources)
    results["build_s"] = time.perf_counter() - t0
    print(f"build: {results['build_s']:.2f} s", flush=True)
    for name, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "error",
                                       "wgmma")):
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    if "int8_matmul" in cuda_build.BUILD_LOG:  # built by this process
        results["int8_ptxas"] = kernel_ptxas(cuda_build.BUILD_LOG["int8_matmul"],
                                              r"int8_matmul_(?:tc|f32)_kernel", "int8 kernel")
    if "flash_block_bwd" in cuda_build.BUILD_LOG:
        results["backward_ptxas"] = backward_ptxas(cuda_build.BUILD_LOG["flash_block_bwd"])
    if "grouped_matmul" in cuda_build.BUILD_LOG:
        results["grouped_ptxas"] = kernel_ptxas(
            cuda_build.BUILD_LOG["grouped_matmul"],
            r"grouped_(?:mm|wgrad)_(?:bf16|f32|tma|f32_tma)_kernel", "grouped kernel")
    if args.gang_f32_moe_batch:
        import tempfile

        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        with tempfile.TemporaryDirectory() as tmp:
            results["gang_moe_f32"] = gang_moe_f32(tmp, args.gang_f32_moe_batch, card)
    if args.gang_only:
        phase_gang(results)
    if args.sp_only:
        phase_sp(results)
    if args.pp_only:
        phase_pp(results)
    if args.ep_only:
        phase_ep(results)
    if args.mesh_serving_only:
        phase_mesh_serving(results)
    if (args.gang_only or args.gang_f32_moe_batch or args.sp_only or args.pp_only
            or args.ep_only or args.mesh_serving_only):
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        flag = ("--gang-only" if args.gang_only else "--sp-only" if args.sp_only
                else "--pp-only" if args.pp_only else "--ep-only" if args.ep_only
                else "--mesh-serving-only" if args.mesh_serving_only
                else "--gang-f32-moe-batch")
        print(f"chip_smoke {flag}: "
              f"{len(FAILURES)} check(s) failed, "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        for what in FAILURES:
            print(f"  FAILED: {what}", flush=True)
        return 1 if FAILURES else 0
    if args.workloads_only:
        phase_workloads(results)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        print(f"chip_smoke --workloads-only: {len(FAILURES)} check(s) failed, "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        for what in FAILURES:
            print(f"  FAILED: {what}", flush=True)
        return 1 if FAILURES else 0
    if args.moe_train_only:
        results["grouped_sass"] = grouped_sass(libraries["grouped_matmul"])
        results["moe_train_kernels"] = phase_moe_train(results, args.grouped_baseline)
        attach_grouped_ptxas(results["moe_train_kernels"], results.get("grouped_ptxas"),
                             results["grouped_sass"])
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        print(f"chip_smoke --moe-train-only: {len(FAILURES)} check(s) failed, "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        for what in FAILURES:
            print(f"  FAILED: {what}", flush=True)
        return 1 if FAILURES else 0
    if args.moe_only:
        results["grouped_sass"] = grouped_sass(libraries["grouped_matmul"])
        results["moe_kernels"] = phase_moe(results, args.grouped_baseline)
        attach_grouped_ptxas(results["moe_kernels"], results.get("grouped_ptxas"),
                             results["grouped_sass"])
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        print(f"chip_smoke --moe-only: {len(FAILURES)} check(s) failed, "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        for what in FAILURES:
            print(f"  FAILED: {what}", flush=True)
        return 1 if FAILURES else 0
    if args.serving_only:
        results["kernel"] = phase_serving(results, args.int8_baseline)
        results["kernel"]["ptxas"] = results.get("int8_ptxas")
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        print(f"chip_smoke --serving-only: {len(FAILURES)} check(s) failed, "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        for what in FAILURES:
            print(f"  FAILED: {what}", flush=True)
        return 1 if FAILURES else 0
    if args.solver_only:
        kernels = phase_solver(results)
        print(json.dumps({"kernels": kernels}))
        print(f"chip_smoke --solver-only: {len(FAILURES)} check(s) failed, "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 1 if FAILURES else 0
    if "flash_block" in cuda_build.BUILD_LOG:
        results["f32_ptxas"] = kernel_ptxas(cuda_build.BUILD_LOG["flash_block"],
                                           "flash_block_f32_kernel")
    results["sass"] = tensor_core_sass(libraries["flash_block"])
    results["backward_sass"] = backward_sass(libraries["flash_block_bwd"])

    kernels = timed(results, "phases 2-3", phase_kernels, results)
    if args.flash_only:
        results["block_backward"] = backward_blocks(card, args.flash_bwd_baseline)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
        print(json.dumps({"kernels": kernels}))
        print(f"chip_smoke --flash-only: {len(FAILURES)} check(s) failed, "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        for what in FAILURES:
            print(f"  FAILED: {what}", flush=True)
        return 1 if FAILURES else 0

    cfg = flagship_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for d in (params, params["layers"]) for t in d.values()
                   if torch.is_tensor(t))
    print(f"flagship params: {n_params / 1e6:.1f} M", flush=True)
    timed(results, "phase 4", phase_forward, params, results)
    timed(results, "phase 5", phase_generate, params, results)
    timed(results, "phase 6", phase_trace, params, results)
    del params
    torch.cuda.empty_cache()
    timed(results, "phase 7", phase_train, results, args.flash_bwd_baseline)
    timed(results, "phase 8", phase_worker, results)

    counters = {"flash_block": "TENSOR_CORE_LAUNCHES", "flash_block_f32": "F32_LAUNCHES",
                "flash_block_tile_classes": "TILE_CLASS_LAUNCHES",
                "flash_block_backward": "BACKWARD_LAUNCHES",
                "flash_block_backward_f32": "BACKWARD_F32_LAUNCHES"}
    worker_launches = (results["worker"]["straight"] or {}).get("kernel_launches", {})
    kernels += backward_entries(results)
    for kernel in kernels:
        counter = counters[kernel["name"]]
        # The f32 variants' main path is the worker's f32 LM run; the bf16
        # backward's is run_model_bench's training; the others' `generate`.
        kernel["launches"] = (
            (f32_backward_by_variant(worker_launches) or {}).get("tma", 0)
            if counter == "BACKWARD_F32_LAUNCHES"
            else worker_launches.get(counter, 0) if counter == "F32_LAUNCHES"
            else results["train_bench_launches"][counter] if counter == "BACKWARD_LAUNCHES"
            else results["launches"][counter])
        if counter == "BACKWARD_F32_LAUNCHES":
            kernel["launches_by_variant"] = f32_backward_by_variant(worker_launches)
        kernel["forward_launches"] = results["forward_launches"][counter]
        kernel["train_step_launches"] = results["train_step_launches"][counter]
        kernel["train_step_launches_by_remat"] = {
            policy: results[f"train_launches_remat_{policy}"][counter]
            for policy in ("off", "full", "dots")}
        kernel["eval_step_launches"] = results["eval_launches"][counter]
        if counter == "TILE_CLASS_LAUNCHES":
            resumed = (results["worker"]["resumed"] or {}).get("kernel_launches", {})
            kernel["launches_by_path"] = {
                "generate, first at its shape": results["launches"][counter],
                "generate, second": results["second_generate_launches"][counter],
                "forward": results["forward_launches"][counter],
                "run_model_bench, all steps": results["train_bench_launches"][counter],
                **{f"train step, remat {policy}": results[f"train_launches_remat_{policy}"][counter]
                   for policy in ("off", "full", "dots")},
                "eval step": results["eval_launches"][counter],
                "worker, uninterrupted run": worker_launches.get(counter),
                "worker, resumed run": resumed.get(counter),
            }
    kernels += timed(results, "phase 9", phase_solver, results)
    timed(results, "phase 10", phase_control_apart, results)
    int8_kernel = timed(results, "phase 11", phase_serving_apart, results, args.int8_baseline)
    grouped_kernels = timed(results, "phase 12", phase_moe_apart, results, args.grouped_baseline)
    grouped_kernels += timed(results, "phase 13", phase_moe_train_apart, results,
                             args.grouped_baseline)
    timed(results, "phase 14", phase_workloads_apart, results)
    timed(results, "phase 15", phase_gang_apart, results)
    timed(results, "phase 16", phase_sp_apart, results)
    timed(results, "phase 17", phase_pp_apart, results)
    timed(results, "phase 18", phase_ep_apart, results)
    timed(results, "phase 19", phase_mesh_serving_apart, results)
    adafactor_counts = ((results.get("adafactor_vs_adam") or {}).get("adafactor") or {}).get(
        "launches") or {}
    for kernel in kernels:
        if kernel["name"] in counters:
            # Phase 14's flagship steps under adafactor (23 steps).
            kernel["adafactor_train_launches"] = adafactor_counts.get(counters[kernel["name"]])
    if int8_kernel is not None:
        int8_kernel["ptxas"] = results.get("int8_ptxas")
        # The expert axis (phase 12): its checks and times, and the MoE
        # serving paths' launches.
        int8_kernel["expert_axis"] = results.get("int8_experts")
        int8_kernel["launches_by_path"].update(
            {f"MoE {k}": v["INT8_LAUNCHES"] for k, v in (results.get("moe_launches") or {}).items()})
        kernels.append(int8_kernel)
    attach_grouped_ptxas(grouped_kernels, results.get("grouped_ptxas"), results.get("grouped_sass"))
    kernels += grouped_kernels
    on_gang, on_sp, on_pp = gang_launches(results), sp_launches(results), pp_launches(results)
    on_ep, ep_times = ep_launches(results), ep_rank_times(results)
    on_mesh = ms_launches(results)
    tp_times = ((results.get("mesh_serving") or {}).get("kernels") or {}).get("times")
    for kernel in kernels:
        kernel["mesh_serving_launches"] = on_mesh.get(kernel["name"],
                                                      {"not on the mesh-serving paths": 0})
        if kernel["name"] == "int8_matmul":
            kernel["tp_rank_times"] = tp_times
        kernel["gang_launches"] = on_gang.get(kernel["name"], {"not on the gang's path": 0})
        kernel["sp_launches"] = on_sp.get(kernel["name"], {"not on the sp path": 0})
        kernel["pp_launches"] = on_pp.get(kernel["name"], {"not on the pp path": 0})
        kernel["ep_launches"] = on_ep.get(kernel["name"], {"not on the ep path": 0})
        if kernel["name"] in ep_times:
            kernel["ep_rank_times"] = ep_times[kernel["name"]]
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
