"""Batched admission scoring: feasibility and weighted DRF shares over every
pending candidate in one call, as torch code on the card.

Counterpart of `jobset_tpu/queue/scorer.py`. The greedy path
(`_score_greedy`, numpy float32) is the plain version and the yardstick;
`score` runs the same float32 formulas on a device, padded to power-of-two
buckets exactly as the reference's jit backend pads them, so the admission
decisions downstream are bit-identical to the greedy path's.

Bit-identical needs the same float adds in the same order. Two sums in
the formulas depend on their order, and the greedy path fixes both:
- the column sums of `nominal`. numpy's `sum(axis=0)` of a C-contiguous
  [Q, R] float32 array adds row after row when R >= 2; when R == 1 the
  column is one contiguous run, and numpy sums it pairwise (blocks of
  128 over 8 running sums, in chunks of its 8192-element buffer), from 0.
  `column_sums` does the same adds in the same order;
- the cohort free capacity (`cohort_free[c] += free[q]` in queue order):
  one elementwise add per member slot of a [C, M] member table (built on
  the host from `cohort`, padded with a zero row).
No float scatter-add, library reduction or matmul does either sum: their
order is the library's. Every other operation (division, max,
comparisons, gathers) rounds once, identically on any device. The
snapshot's arrays are C-contiguous, as the queue manager builds them.

What one scoring call computes:

* ``feasible[p]``: candidate p's gang request fits its queue right now,
  within the queue's own nominal quota or, in a cohort, within the
  cohort's free capacity (and every requested resource is quota'd);
* ``queue_share[q]``: ``max_r(usage[q,r] / cluster_nominal[r]) / weight[q]``,
  the queue's weighted dominant share;
* ``candidate_share[p]``: its queue's share, gathered.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..obs import profile


def _round_up_pow2(n: int, minimum: int = 8) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


@dataclass
class Snapshot:
    """Dense arrays describing the admission state at one instant:
    `resources` fixes the column order, queue rows are sorted by name,
    candidate rows are the pending workloads in arrival order."""

    resources: list[str]       # R column names
    queue_names: list[str]     # Q row names (sorted)
    nominal: np.ndarray        # [Q, R] float32 nominal quota (0 = undeclared)
    declared: np.ndarray       # [Q, R] bool: resource explicitly quota'd
    usage: np.ndarray          # [Q, R] float32 admitted usage
    weight: np.ndarray         # [Q] float32 DRF weights
    cohort: np.ndarray         # [Q] int32 cohort index, -1 = no cohort
    num_cohorts: int
    request: np.ndarray        # [P, R] float32 gang requests
    queue_index: np.ndarray    # [P] int32 row into the queue arrays


@dataclass
class ScoreResult:
    feasible: np.ndarray        # [P] bool
    queue_share: np.ndarray     # [Q] float32 weighted dominant share
    candidate_share: np.ndarray  # [P] float32: its queue's share, gathered
    backend: str                # "greedy" | "torch"


def score(snapshot: Snapshot, device=None) -> ScoreResult:
    """Score one snapshot on `device` (the card unless the caller names
    another; with no CUDA device and none named it raises). A snapshot
    with no candidates gets the greedy result, as the reference's does:
    there is nothing to batch."""
    device = resolve_device(device)
    if snapshot.request.shape[0] == 0:
        return ScoreResult(
            feasible=np.zeros(0, bool),
            queue_share=_greedy_share(snapshot),
            candidate_share=np.zeros(0, np.float32),
            backend="greedy",
        )
    return _score_device(snapshot, device)


# ---------------------------------------------------------------------------
# The plain version: numpy float32, the same formulas.
# ---------------------------------------------------------------------------


def _greedy_share(snapshot: Snapshot) -> np.ndarray:
    denom = np.maximum(
        snapshot.nominal.sum(axis=0, dtype=np.float32), np.float32(1.0)
    )
    if snapshot.usage.shape[0] == 0:
        return np.zeros(0, np.float32)
    share = (snapshot.usage / denom).max(axis=1)
    return (share / snapshot.weight).astype(np.float32)


def _score_greedy(snapshot: Snapshot) -> ScoreResult:
    qi = snapshot.queue_index
    free = snapshot.nominal - snapshot.usage
    own_fit = np.all(snapshot.request <= free[qi], axis=1)
    covered = np.all(
        (snapshot.request <= 0) | snapshot.declared[qi], axis=1
    )

    # A cohort member's fit is judged against the COHORT free capacity
    # (own nominal fit is neither sufficient, a peer may have borrowed
    # this queue's headroom, nor necessary, borrowing).
    C = max(snapshot.num_cohorts, 1)
    cohort_free = np.zeros((C, snapshot.nominal.shape[1]), np.float32)
    for q, c in enumerate(snapshot.cohort):
        if c >= 0:
            cohort_free[c] += free[q]
    has_cohort = snapshot.cohort[qi] >= 0
    cohort_fit = np.all(
        snapshot.request <= cohort_free[np.maximum(snapshot.cohort[qi], 0)],
        axis=1,
    )

    share = _greedy_share(snapshot)
    return ScoreResult(
        feasible=covered & np.where(has_cohort, cohort_fit, own_fit),
        queue_share=share,
        candidate_share=share[qi],
        backend="greedy",
    )


# ---------------------------------------------------------------------------
# The device path: the same math on padded buckets.
# ---------------------------------------------------------------------------


# Monotone high-water candidate buckets, as in the reference: an admission
# run's candidate count shrinks pass over pass as gangs admit, and P pads
# to the largest bucket seen for its (Q, C, R) shape, so every later pass
# runs at the first pass's shape. Padded rows are sliced away and never
# influence real rows.
_P_HIGH_WATER: dict[tuple[int, int, int], int] = {}


def _p_bucket(P0: int, Q: int, C: int, R: int) -> int:
    key = (Q, C, R)
    bucket = max(_round_up_pow2(P0), _P_HIGH_WATER.get(key, 0))
    _P_HIGH_WATER[key] = bucket
    return bucket


def warm(num_queues: int, num_resources: int, num_cohorts: int,
         max_candidates: int, device=None) -> None:
    """Score one placeholder snapshot at a deployment's largest shape, so
    the high-water bucket is set and the device's allocator holds its
    buffers before the first admission pass."""
    if max_candidates <= 0:
        return
    Q0, R0 = max(num_queues, 1), max(num_resources, 1)
    score(Snapshot(
        resources=[f"r{i}" for i in range(R0)],
        queue_names=[f"q{i}" for i in range(Q0)],
        nominal=np.ones((Q0, R0), np.float32),
        declared=np.ones((Q0, R0), bool),
        usage=np.zeros((Q0, R0), np.float32),
        weight=np.ones(Q0, np.float32),
        cohort=np.full(Q0, -1, np.int32),
        num_cohorts=max(num_cohorts, 0),
        request=np.zeros((max_candidates, R0), np.float32),
        queue_index=np.zeros(max_candidates, np.int32),
    ), device=device)


def cohort_members(cohort: np.ndarray, num_cohorts: int) -> np.ndarray:
    """[C, M] int64 member table: row c lists the queue rows of cohort c in
    ascending order, padded with Q (a zero row the device path appends to
    `free`). C is `num_cohorts` (at least 1), M the largest cohort (at
    least 1); rows with cohort -1 belong to none."""
    Q = cohort.shape[0]
    C = max(num_cohorts, 1)
    members: list[list[int]] = [[] for _ in range(C)]
    for q, c in enumerate(cohort.tolist()):
        if 0 <= c < C:
            members[c].append(q)
    M = max(1, max(len(m) for m in members))
    table = np.full((C, M), Q, np.int64)
    for c, rows in enumerate(members):
        table[c, :len(rows)] = rows
    return table


# numpy's pairwise summation (`pairwise_sum` in its umath loops): below 8
# elements a plain loop, up to 128 eight running sums, above that halves
# split at a multiple of 8; a reduction feeds it chunks of its buffer.
_PW_UNROLL, _PW_BLOCK, _NP_BUFSIZE = 8, 128, 8192


def _pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """numpy's float32 `pairwise_sum` of the 1-D tensor `a`, add for add."""
    n = a.shape[0]
    if n < _PW_UNROLL:
        res = a.new_zeros(())
        for x in a.unbind(0):
            res = res + x
        return res
    if n <= _PW_BLOCK:
        whole = n - n % _PW_UNROLL
        r = a[:_PW_UNROLL].clone()
        for i in range(_PW_UNROLL, whole, _PW_UNROLL):
            r.add_(a[i:i + _PW_UNROLL])
        r = r[0::2] + r[1::2]          # (r0+r1), (r2+r3), (r4+r5), (r6+r7)
        r = r[0::2] + r[1::2]
        res = r[0] + r[1]
        for x in a[whole:].unbind(0):
            res = res + x
        return res
    half = n // 2
    half -= half % _PW_UNROLL
    return _pairwise_sum(a[:half]) + _pairwise_sum(a[half:])


def column_sums(nominal: torch.Tensor, queues: int, resources: int) -> torch.Tensor:
    """[R] column sums of the real [queues, resources] block of the padded
    `nominal`, with numpy's adds in numpy's order (module docstring);
    padded columns sum to 0."""
    total = torch.zeros_like(nominal[0])
    if resources == 1:
        acc = nominal.new_zeros(())
        for start in range(0, queues, _NP_BUFSIZE):
            acc = acc + _pairwise_sum(nominal[start:min(queues, start + _NP_BUFSIZE), 0])
        total[0] = acc
    else:
        for row in nominal[:queues].unbind(0):
            total.add_(row)
    return total


def score_tensors(nominal, declared, usage, weight, cohort, members, request, qi,
                  queues: int, resources: int):
    """The scorer's math on padded tensors of one device: nominal, usage
    [Q, R] f32, declared [Q, R] bool, weight [Q] f32, cohort [Q] int,
    members [C, M] int64 (`cohort_members`), request [P, R] f32, qi [P]
    int64; `queues` and `resources` are the real Q and R. Returns
    (feasible [P] bool, share [Q] f32, share[qi] [P] f32)."""
    denom = torch.clamp_min(column_sums(nominal, queues, resources), 1.0)
    share = (usage / denom).amax(dim=1) / weight

    free = nominal - usage
    own_fit = (request <= free[qi]).all(dim=1)
    covered = ((request <= 0) | declared[qi]).all(dim=1)

    # Cohort free capacity, member after member in queue order; padded
    # slots add the appended zero row.
    free_ext = torch.cat([free, torch.zeros_like(free[:1])])
    cohort_free = torch.zeros(
        (members.shape[0], free.shape[1]), dtype=free.dtype, device=free.device)
    for slot in members.unbind(1):
        cohort_free.add_(free_ext[slot])
    cq = cohort[qi]
    cohort_fit = (request <= cohort_free[cq.clamp_min(0)]).all(dim=1)

    feasible = covered & torch.where(cq >= 0, cohort_fit, own_fit)
    return feasible, share, share[qi]


def _pad(snapshot: Snapshot):
    """The reference jit backend's padding: Q and P to pow2 buckets (P at
    the monotone high-water), R to at least 4, C to at least 4. Padded
    queues have no quota and weight 1; padded candidates request 1.0 of
    every padded column, undeclared, so they come back infeasible."""
    P0, R0 = snapshot.request.shape
    Q0 = snapshot.nominal.shape[0]
    Q = _round_up_pow2(Q0)
    R = _round_up_pow2(max(R0, 1), minimum=4)
    C = _round_up_pow2(max(snapshot.num_cohorts, 1), minimum=4)
    P = _p_bucket(P0, Q, C, R)

    nominal = np.zeros((Q, R), np.float32)
    nominal[:Q0, :R0] = snapshot.nominal
    declared = np.zeros((Q, R), bool)
    declared[:Q0, :R0] = snapshot.declared
    usage = np.zeros((Q, R), np.float32)
    usage[:Q0, :R0] = snapshot.usage
    weight = np.ones(Q, np.float32)
    weight[:Q0] = snapshot.weight
    cohort = np.full(Q, -1, np.int64)
    cohort[:Q0] = snapshot.cohort
    request = np.full((P, R), np.float32(1.0))
    request[:P0, :R0] = snapshot.request
    request[:P0, R0:] = 0.0
    qi = np.zeros(P, np.int64)
    qi[:P0] = snapshot.queue_index
    members = cohort_members(cohort, C)
    return nominal, declared, usage, weight, cohort, members, request, qi


@functools.lru_cache(maxsize=8)
def _kernel(P: int, Q: int, C: int, R: int):
    """The device call of one padded (P, Q, C, R) bucket, as the
    reference's compile-once factory keys it: its first call is timed as
    the family's compile (obs/profile.py), and the cache's hits and misses
    are the `jobset_jit_cache_*` gauges' "queue_scorer" series."""
    return profile.timed_compile("queue_scorer", score_tensors)


profile.KERNEL_CACHES.register("queue_scorer", _kernel)


def _score_device(snapshot: Snapshot, device: torch.device) -> ScoreResult:
    """The padded snapshot through its bucket's device call. Transfers are
    counted at the copies this path makes: the padded arrays with the
    cohort member table (cohort, queue indexes and members as int64) to
    the device, one f32 vector of 2P + Q back."""
    P0 = snapshot.request.shape[0]
    Q0 = snapshot.nominal.shape[0]
    arrays = _pad(snapshot)
    nominal, members, request = arrays[0], arrays[5], arrays[6]
    P, R = request.shape
    profile.note_transfer("queue_scorer", "h2d", *arrays)
    feasible, share, candidate_share = _kernel(P, nominal.shape[0], members.shape[0], R)(
        *(torch.from_numpy(a).to(device) for a in arrays),
        queues=Q0, resources=snapshot.nominal.shape[1])
    # One readback: the feasibility bits ride as f32 0/1 beside the shares.
    out = torch.cat([feasible.float(), candidate_share, share]).cpu().numpy()
    profile.note_transfer("queue_scorer", "d2h", out)
    return ScoreResult(
        feasible=out[:P0] != 0,
        queue_share=out[2 * P:2 * P + Q0].copy(),
        candidate_share=out[P:P + P0].copy(),
        backend="torch",
    )
