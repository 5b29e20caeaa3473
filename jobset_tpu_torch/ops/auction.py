"""Launcher of the auction kernel (`csrc/auction.cu`) on the card.

The plain PyTorch version of the same function is in
`jobset_tpu_torch/placement/solver.py` (`_auction_plain`,
`_auction_structured_plain`), which sends CPU tensors there and CUDA
tensors here. This module only launches: it raises on a tensor that is not
on the card and never falls back. One kernel serves the reference's four
variants; each launch adds one to `AUCTION_LAUNCHES` and to its variant's
counter.

The kernel also reports, per problem, its bids and the rows it scanned,
its phases and repair passes, how many bids its candidate lists answered,
and its own cycle counts by part of the round (`STATS`), from which
`chip_smoke.py` bounds its time by bytes and splits its round. The
launcher allocates the kernel's global scratch: a structured problem's
benefit, and the candidate lists where they do not fit in shared memory
(`auction_candidate_scratch_bytes` in the source says how much).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

# Launches counted where the kernel is launched: all of them, and each of
# the four variants (a single solve is a launch of one problem).
AUCTION_LAUNCHES = 0
DENSE_LAUNCHES = 0
STRUCTURED_LAUNCHES = 0
DENSE_BATCH_LAUNCHES = 0
STRUCTURED_BATCH_LAUNCHES = 0

# Per-problem counters of a launch, columns of the returned stats:
# - bid_rows: bids made (one per bidder per round); repair_rows: rows read
#   by the phase-start repairs; phases; repair_passes;
# - full_scan_rows: bids that read the bidder's whole row; cached_bids:
#   bids answered by the bidder's candidate list; candidate_bytes: bytes
#   of candidate lists read from global memory (0 where they fit in
#   shared memory);
# - cycles_*: thread 0's SM clock over the whole kernel, the repairs, and
#   the parts of the timed bidding rounds (bidder list, bids, conflict
#   resolution), and its wait inside their barriers (part of those);
# - warp0_*: warp 0's own bids in the timed rounds, split into full scans
#   and cached bids, with the cycles each took;
# - timed_rounds: the rounds timed, one in 16.
STATS = ("bid_rows", "repair_rows", "phases", "repair_passes",
         "full_scan_rows", "cached_bids", "candidate_bytes",
         "cycles_total", "cycles_repair", "cycles_list", "cycles_bid", "cycles_resolve",
         "cycles_barrier", "warp0_scans", "warp0_scan_cycles", "warp0_hits",
         "warp0_hit_cycles", "timed_rounds")
MAX_SHARED_BYTES = 232_448  # what one block may opt into on an H100


def shared_bytes(jobs: int, domains: int) -> int:
    """Shared memory of the solve's state: 16 B per object (bid key,
    price, owner) and 20 B per job, rounded up to 16 B. The kernel adds the
    bidders' candidate lists where they fit beside it and keeps them in a
    global scratch otherwise."""
    return (16 * domains + 20 * jobs + 15) // 16 * 16


@functools.cache
def _library():
    lib = cuda_build.load("auction")
    lib.auction_launch.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 14
    )
    lib.auction_launch.restype = ctypes.c_int
    lib.auction_candidate_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.auction_candidate_scratch_bytes.restype = ctypes.c_int
    return lib


def _check_shape(name, jobs: int, domains: int, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"auction {name}: tensors on {device}; the kernel takes CUDA tensors")
    if domains < 8 or domains & (domains - 1):
        raise ValueError(f"auction {name}: {domains} domains is not a power of two >= 8")
    if jobs < 1:
        raise ValueError(f"auction {name}: no jobs")
    if shared_bytes(jobs, domains) > MAX_SHARED_BYTES:
        raise ValueError(
            f"auction {name}: {jobs} x {domains} needs {shared_bytes(jobs, domains)} B of "
            f"shared memory, more than the {MAX_SHARED_BYTES} B a block can have"
        )


def _check(name, t, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"auction: {name} is {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous {t.is_contiguous()}); expected contiguous {tuple(shape)} {dtype} "
            f"on {device}"
        )


def _launch(batch, jobs, domains, max_iters, eps, device, benefit=None,
            structured=(None,) * 7):
    assignment = torch.empty((batch, jobs), dtype=torch.int32, device=device)
    prices = torch.empty((batch, domains), dtype=torch.float32, device=device)
    iterations = torch.empty((batch,), dtype=torch.int32, device=device)
    stats = torch.empty((batch, len(STATS)), dtype=torch.int64, device=device)
    # The kernel's scratch: a structured problem's benefit, which it writes
    # once, then the candidate lists that do not fit in shared memory.
    lib = _library()
    floats = batch * (jobs * domains * (benefit is None)
                      + lib.auction_candidate_scratch_bytes(jobs, domains) // 4)
    scratch = torch.empty((floats,), dtype=torch.float32, device=device) if floats else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        err = lib.auction_launch(
            batch, jobs, domains, domains.bit_length() - 1, max_iters, float(eps),
            ptr(benefit), ptr(scratch), *(ptr(t) for t in structured),
            assignment.data_ptr(), prices.data_ptr(), iterations.data_ptr(), stats.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"auction kernel launch failed: CUDA error {err}")
    return assignment, prices, iterations, stats


def dense(benefit, eps=1.0, max_iters: int = 20000, batched: bool = False):
    """Auction solves of a [B, J_p, D_p] f32 scaled benefit stack on the
    card. Returns (assignment [B, J_p] int32 with D_p for "took the sink",
    prices [B, D_p] f32, iterations [B] int32, stats [B, len(STATS)]
    int64)."""
    global AUCTION_LAUNCHES, DENSE_LAUNCHES, DENSE_BATCH_LAUNCHES
    if benefit.dim() != 3:
        raise ValueError(f"auction dense: benefit {tuple(benefit.shape)} is not [B, J, D]")
    batch, jobs, domains = benefit.shape
    _check_shape("dense", jobs, domains, benefit.device)
    _check("benefit", benefit, (batch, jobs, domains), torch.float32, benefit.device)
    out = _launch(batch, jobs, domains, max_iters, eps, benefit.device, benefit=benefit)
    AUCTION_LAUNCHES += 1
    if batched:
        DENSE_BATCH_LAUNCHES += 1
    else:
        DENSE_LAUNCHES += 1
    return out


def structured(load, free, pods_needed, sticky, occupied, own_domain, num_domains,
               max_iters: int = 20000, batched: bool = False):
    """Structured auction solves on the card: load/free [B, D_p] f32,
    pods_needed [B, J_p] f32, sticky/own_domain [B, J_p] int32, occupied
    [B, D_p] bool, num_domains [B] int32 (the real domain counts, 1..D_p).
    The kernel writes each problem's benefit into a [B, J_p, D_p] scratch
    once, then solves. Returns what `dense` returns."""
    global AUCTION_LAUNCHES, STRUCTURED_LAUNCHES, STRUCTURED_BATCH_LAUNCHES
    if load.dim() != 2 or pods_needed.dim() != 2:
        raise ValueError(
            f"auction structured: load {tuple(load.shape)}, pods_needed "
            f"{tuple(pods_needed.shape)} are not [B, D] and [B, J]"
        )
    batch, domains = load.shape
    jobs = pods_needed.shape[1]
    device = load.device
    _check_shape("structured", jobs, domains, device)
    for name, t, shape, dtype in (
        ("load", load, (batch, domains), torch.float32),
        ("free", free, (batch, domains), torch.float32),
        ("pods_needed", pods_needed, (batch, jobs), torch.float32),
        ("sticky", sticky, (batch, jobs), torch.int32),
        ("occupied", occupied, (batch, domains), torch.bool),
        ("own_domain", own_domain, (batch, jobs), torch.int32),
        ("num_domains", num_domains, (batch,), torch.int32),
    ):
        _check(name, t, shape, dtype, device)
    out = _launch(batch, jobs, domains, max_iters, 1.0, device,
                  structured=(load, free, pods_needed, sticky, occupied, own_domain,
                              num_domains))
    AUCTION_LAUNCHES += 1
    if batched:
        STRUCTURED_BATCH_LAUNCHES += 1
    else:
        STRUCTURED_LAUNCHES += 1
    return out
