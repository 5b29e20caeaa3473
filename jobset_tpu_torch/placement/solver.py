"""Batched linear-assignment placement solver: PyTorch, with a CUDA kernel
on the card.

Counterpart of `jobset_tpu/placement/solver.py`. The whole job ->
topology-domain assignment of a JobSet is one linear-assignment problem,
solved by Bertsekas' auction (Jacobi variant: every unassigned job bids at
once) with a rank-matched warm start, eps-scaling phases (theta = 8) whose
boundaries repair complementary slackness to a fixpoint, and one implicit
constant-benefit "sink" per job, so a perfect matching always exists and
jobs that end on their sink come back unassigned (-1). Integer costs
scaled by (J+1) with a final eps of 1 give the exact optimum; every scaled
value stays below 2^24, so f32 arithmetic is exact there. The structured
cost model (load, rotation, stickiness, capacity, exclusive ownership) is
continuous, and only rounding matched operation for operation keeps its
results identical to the reference's.

Two implementations of the same function, chosen by the tensor's device
and nothing else:
- the plain version (`_auction_plain`), PyTorch with host loops: the CPU
  path, and the yardstick the kernel is held to on the card;
- the hand-written kernel `ops/csrc/auction.cu` (one thread block per
  problem, the whole solve in one launch) for CUDA tensors. A CUDA tensor
  never reaches the plain version.

Both keep a batch dimension in which each member stops when it is done,
as under `vmap` of `while_loop`: a member's assignment, prices and
iteration count equal its single solve.

`AssignmentSolver` is the surface: padding to power-of-two buckets, the
cells-vs-round-trip routing between the card and the host, the host
portfolio (a capped auction, then scipy's Hungarian), asynchronous solves
(`PendingSolve.is_ready` polls a CUDA event) and one readback per storm.

Observability, site by site as in the reference and under its names: a
`solver.solve` span per dispatch with `solver.host_transfer` and
`solver.dispatch` (its `compile_cache` hit or miss) under it,
`solver.solve_loop` and `solver.readback` recorded at the first
`result()`, `solver.hungarian_fallback` around the portfolio's Hungarian
step; the `jobset_placement_solve_time_seconds` histogram, the batch
gauges, and the `jobset_jit_*` compile and transfer counts of the four
auction kernels (obs/profile.py). None of them waits on the device after
a shape's first call.
"""

from __future__ import annotations

import functools
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..core import metrics
from ..device import resolve_device
from ..obs import profile
from ..obs import trace as obs_trace
from ..ops import auction as auction_ops

# Cost scale: costs are small non-negative ints; benefit = (COST_CAP - cost).
COST_CAP = 1024.0
# Finite benefit of a job's dedicated sink: worse than any real domain, so
# a job takes its sink only when no real domain is obtainable.
SINK_BENEFIT = -4.0 * COST_CAP
# Forbidden-cell sentinel. IEEE-finite: dead and padded cells are found
# with `> NEG_INF / 2`, never with isfinite.
NEG_INF = -1.0e9

# eps-scaling factor: each phase divides eps by theta down to the caller's
# final eps, keeping the previous phase's prices.
_EPS_THETA = 8.0

_F32 = torch.float32
_CPU = torch.device("cpu")


def _round_up_pow2(n: int, minimum: int = 8) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


# ---------------------------------------------------------------------------
# The plain version: PyTorch, host loops, a batch dimension written out
# ---------------------------------------------------------------------------


def _first_argmax(values, best):
    """Index of the first maximum along the last axis (jnp.argmax's rule)."""
    width = values.shape[-1]
    idx = torch.arange(width, device=values.device)
    return torch.where(values == best[..., None], idx, width).amin(dim=-1)


def _warm_start(benefit):
    """Rank-matched warm start (the reference's closed-form equilibrium of
    the identical-jobs case): job i takes the i-th best column by column
    score, priced at its score margin over the first unseeded column. Only
    rows with any feasible cell take part. Returns (assignment [B,J],
    owner [B,D], prices [B,D]); assignment and owner are int64."""
    batch, jobs, objects = benefit.shape
    dev = benefit.device
    col_score = benefit.amax(dim=1)  # [B, D]
    order = torch.argsort(-col_score, dim=1, stable=True)
    row_finite = benefit.amax(dim=2) > NEG_INF / 2.0  # [B, J]
    seed_rank = torch.cumsum(row_finite.long(), dim=1) - 1
    num_finite = row_finite.long().sum(dim=1)  # [B]
    can_seed = row_finite & (seed_rank < min(jobs, objects))
    obj_for_job = torch.gather(order, 1, seed_rank.clamp(0, objects - 1))
    # Dead columns (no feasible job) are masked with the NEG_INF/2 test:
    # the sentinel is IEEE-finite.
    live_col = col_score > NEG_INF / 2.0
    num_live = live_col.long().sum(dim=1)
    min_live = torch.where(live_col, col_score, torch.inf).amin(dim=1)
    thresh_obj = torch.gather(order, 1, num_finite.clamp(0, objects - 1)[:, None])[:, 0]
    s_thresh = torch.where(
        num_finite < num_live,
        torch.gather(col_score, 1, thresh_obj[:, None])[:, 0],
        torch.where(torch.isfinite(min_live), min_live, 0.0),
    )
    gain = torch.gather(col_score, 1, obj_for_job) - s_thresh[:, None]
    gain = torch.where(torch.isfinite(gain), gain, 0.0).clamp_min(0.0)
    # Scatter into one spare column that takes the unseeded jobs.
    scatter_obj = torch.where(can_seed, obj_for_job, objects)
    prices = torch.zeros((batch, objects + 1), dtype=_F32, device=dev)
    prices.scatter_(1, scatter_obj, gain)
    owner = torch.full((batch, objects + 1), -1, dtype=torch.long, device=dev)
    owner.scatter_(1, scatter_obj, torch.arange(jobs, device=dev).expand(batch, jobs))
    assignment = torch.where(can_seed, obj_for_job, -1)
    return assignment, owner[:, :objects].contiguous(), prices[:, :objects].contiguous()


def _repair(benefit, assignment, owner, prices, eps_k, sink, active):
    """Phase-start CS repair, run to a fixpoint for each member in `active`:
    drop pairs that violate eps_k-CS and zero every unowned object's price
    (the "price > 0 => owned" invariant of the rectangular duality bound).
    Members not in `active` are left as they are."""
    jobs, objects = benefit.shape[1:]
    changed = active.clone()
    while bool(changed.any()):
        values = benefit - prices[:, None, :]
        vmax = values.amax(dim=2).clamp_min(sink)
        idx = assignment.clamp(0, objects - 1)
        v_assigned = torch.where(
            assignment >= objects,  # the sink sentinel
            sink,
            torch.gather(values, 2, idx[..., None])[..., 0],
        )
        violates = (assignment >= 0) & (v_assigned < vmax - eps_k[:, None])
        violates &= changed[:, None]
        assignment = torch.where(violates, -1, assignment)
        orphaned = (owner >= 0) & torch.gather(violates, 1, owner.clamp(0, jobs - 1))
        owner = torch.where(orphaned, -1, owner)
        prices = torch.where(changed[:, None] & (owner < 0), 0.0, prices)
        changed = changed & violates.any(dim=1)
    return assignment, owner, prices


def _bid_round(benefit, assignment, owner, prices, eps_k, sink, active):
    """One Jacobi bidding round for each member in `active`: every
    unassigned job bids for its best object (or takes its sink when that
    beats every real object); per object the highest bid wins, ties to the
    lowest job index; winners evict previous owners and set the price."""
    batch, jobs, objects = benefit.shape
    dev = benefit.device
    job_ids = torch.arange(jobs, device=dev).expand(batch, jobs)
    unassigned = (assignment < 0) & active[:, None]

    values = benefit - prices[:, None, :]
    best_val = values.amax(dim=2)
    best_obj = _first_argmax(values, best_val)
    # Second-best value: mask the best column; the sink floors it.
    masked = values.scatter(2, best_obj[..., None], -torch.inf)
    second_val = masked.amax(dim=2).clamp_min(sink)
    takes_sink = unassigned & (sink > best_val)
    bid = torch.gather(prices, 1, best_obj) + (best_val - second_val) + eps_k[:, None]

    bid_active = torch.where(unassigned & ~takes_sink, bid, -torch.inf)
    neg = torch.full((batch, objects), -torch.inf, dtype=_F32, device=dev)
    obj_best_bid = neg.scatter_reduce(1, best_obj, bid_active, "amax")
    is_winner = torch.isfinite(bid_active) & (
        bid_active >= torch.gather(obj_best_bid, 1, best_obj)
    )
    winner_job = torch.full((batch, objects), jobs, dtype=torch.long, device=dev)
    winner_job = winner_job.scatter_reduce(
        1, best_obj, torch.where(is_winner, job_ids, jobs), "amin"
    )
    won = winner_job < jobs

    # Evict the previous owners of won objects, then seat the winners; the
    # spare column takes the scatters that the reference drops.
    ext = torch.cat([assignment, torch.full((batch, 1), -1, dtype=torch.long, device=dev)], 1)
    evicted = torch.where(won, owner, -1)
    ext.scatter_(1, torch.where(evicted >= 0, evicted, jobs), -1)
    ext.scatter_(1, torch.where(won, winner_job, jobs),
                 torch.arange(objects, device=dev).expand(batch, objects))
    assignment = torch.where(takes_sink, objects, ext[:, :jobs])
    owner = torch.where(won, winner_job, owner)
    winner_bid = neg.scatter_reduce(1, best_obj, torch.where(is_winner, bid_active, -torch.inf),
                                    "amax")
    prices = torch.where(won, winner_bid, prices)
    return assignment, owner, prices


def _auction_plain(benefit, eps=1.0, max_iters: int = 20000):
    """The auction over a [B, J, D] f32 benefit stack (scaled values;
    NEG_INF forbids a cell), in plain PyTorch.

    Returns (assignment [B, J] int32 into D, with D itself as the "took the
    sink" sentinel; prices [B, D] f32; iterations [B] int32, the bidding
    rounds over all phases). Each member runs as its single solve would."""
    batch, jobs, objects = benefit.shape
    dev = benefit.device
    sink = SINK_BENEFIT * (jobs + 1)
    eps_final = torch.tensor(float(eps), dtype=_F32, device=dev)

    assignment, owner, prices = _warm_start(benefit)
    # Initial eps from the finite-benefit spread.
    finite = benefit > NEG_INF / 2.0
    bmax = torch.where(finite, benefit, -torch.inf).amax(dim=(1, 2))
    bmin = torch.where(finite, benefit, torch.inf).amin(dim=(1, 2))
    spread = torch.where(finite.any(dim=2).any(dim=1), bmax - bmin, 0.0)
    eps_k = torch.maximum(eps_final, spread / _EPS_THETA)
    it = torch.zeros(batch, dtype=torch.int32, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)

    while True:
        outer = ~done & (it < max_iters)
        if not bool(outer.any()):
            break
        assignment, owner, prices = _repair(
            benefit, assignment, owner, prices, eps_k, sink, outer
        )
        while True:
            inner = outer & (assignment < 0).any(dim=1) & (it < max_iters)
            if not bool(inner.any()):
                break
            assignment, owner, prices = _bid_round(
                benefit, assignment, owner, prices, eps_k, sink, inner
            )
            it = it + inner.int()
        done = torch.where(outer, eps_k <= eps_final, done)
        eps_k = torch.where(outer, torch.maximum(eps_final, eps_k / _EPS_THETA), eps_k)
    return assignment.int(), prices, it


def _structured_benefit(load, free, pods_needed, sticky, occupied, own_domain, num_domains):
    """The scaled [B, J_p, D_p] benefit of the structured cost model, built
    from its O(J + D) parametrization: cost[j, d] = 1 + load[d] +
    0.1 * ((d - j) mod nd) / nd, 0 at the sticky domain; feasible where the
    domain has room for the job's pods, is not owned by another key, and is
    a real (unpadded) domain. `%` is floor-mod, as in jnp: fmod, then + nd
    where the signs differ."""
    batch, objects = load.shape
    jobs = pods_needed.shape[1]
    dev = load.device
    nd = num_domains.to(_F32)[:, None, None]
    jj = torch.arange(jobs, dtype=_F32, device=dev)[None, :, None]
    dd = torch.arange(objects, dtype=_F32, device=dev)[None, None, :]
    rot = torch.fmod(dd - jj, nd)
    rot = torch.where((rot != 0) & ((rot < 0) != (nd < 0)), rot + nd, rot)
    tenth = torch.tensor(0.1, dtype=_F32, device=dev)
    cost = (1.0 + load[:, None, :]) + (tenth * rot) / nd
    dcol = torch.arange(objects, device=dev)[None, None, :]
    cost = torch.where(dcol == sticky[:, :, None], 0.0, cost)
    feasible = free[:, None, :] >= pods_needed[:, :, None]
    feasible &= (~occupied)[:, None, :] | (dcol == own_domain[:, :, None])
    feasible &= dcol < num_domains[:, None, None]
    benefit = torch.where(feasible, COST_CAP - cost.clamp(0.0, COST_CAP - 1.0), NEG_INF)
    return benefit * float(jobs + 1)


def _auction_structured_plain(load, free, pods_needed, sticky, occupied, own_domain,
                              num_domains, max_iters: int = 20000):
    """Structured solves over a [B] batch in plain PyTorch: (assignment
    [B, J_p] int32, iterations [B] int32)."""
    benefit = _structured_benefit(load, free, pods_needed, sticky, occupied, own_domain,
                                  num_domains)
    assignment, _, iters = _auction_plain(benefit, 1.0, max_iters)
    return assignment, iters


# ---------------------------------------------------------------------------
# The four variants of the reference, dispatched by device
# ---------------------------------------------------------------------------


def _dense(benefit, eps, max_iters, batched):
    if benefit.device.type == "cuda":
        return auction_ops.dense(benefit, eps, max_iters, batched=batched)[:3]
    if benefit.device.type == "cpu":
        return _auction_plain(benefit, eps, max_iters)
    raise ValueError(f"auction: no implementation on device {benefit.device}")


def _structured(*operands, max_iters, batched):
    """Structured solves of [B]-stacked operands, num_domains last."""
    device = operands[0].device
    if device.type == "cuda":
        assignment, _, iters, _ = auction_ops.structured(*operands, max_iters=max_iters,
                                                          batched=batched)
        return assignment, iters
    if device.type == "cpu":
        return _auction_structured_plain(*operands, max_iters=max_iters)
    raise ValueError(f"auction: no implementation on device {device}")


def _auction(benefit, eps=1.0, max_iters: int = 20000):
    """One dense solve: benefit [J, D] f32 (scaled) -> (assignment [J]
    int32, prices [D] f32, iterations int32), as the reference's _auction."""
    assignment, prices, iters = _dense(benefit[None], eps, max_iters, batched=False)
    return assignment[0], prices[0], iters[0]


def _auction_batch(benefit, eps=1.0, max_iters: int = 20000):
    """Dense solves over a [B, J, D] stack: (assignment [B, J], prices
    [B, D], iterations [B]). The reference's _auction_batch returns the
    assignments alone."""
    return _dense(benefit, eps, max_iters, batched=True)


def _auction_structured(load, free, pods_needed, sticky, occupied, own_domain, num_domains,
                        max_iters: int = 20000):
    """One structured solve: padded [D_p]/[J_p] parameters and the real
    domain count -> (assignment [J_p] int32, iterations int32)."""
    nd = torch.as_tensor([int(num_domains)], dtype=torch.int32, device=load.device)
    operands = [t[None] for t in (load, free, pods_needed, sticky, occupied, own_domain)]
    assignment, iters = _structured(*operands, nd, max_iters=max_iters, batched=False)
    return assignment[0], iters[0]


def _auction_structured_batch(load, free, pods_needed, sticky, occupied, own_domain,
                              num_domains, max_iters: int = 20000):
    """Structured solves over a batch: every argument has a leading [B]
    axis (num_domains is [B] int32). A storm touching B JobSets is one
    launch."""
    return _structured(load, free, pods_needed, sticky, occupied, own_domain, num_domains,
                       max_iters=max_iters, batched=True)


@functools.cache
def _scipy_available() -> bool:
    """scipy is an optional portfolio accelerant, not a dependency."""
    try:
        from scipy.optimize import linear_sum_assignment  # noqa: F401

        return True
    except ImportError:
        return False


def _structured_cost_np(load, free, pods_needed, sticky, occupied, own_domain):
    """Numpy mirror of the structured cost/feasibility construction
    (unpadded [J, D]) for the host Hungarian path; formula for formula the
    same as `_structured_benefit`."""
    num_jobs = pods_needed.shape[0]
    num_domains = load.shape[0]
    nd = float(num_domains)
    jj = np.arange(num_jobs, dtype=np.float32)[:, None]
    dd = np.arange(num_domains, dtype=np.float32)[None, :]
    cost = 1.0 + load[None, :] + 0.1 * ((dd - jj) % nd) / nd
    dcol = np.arange(num_domains, dtype=np.int32)[None, :]
    cost = np.where(dcol == sticky[:, None], 0.0, cost).astype(np.float32)
    feasible = free[None, :] >= pods_needed[:, None]
    feasible &= (~occupied)[None, :] | (dcol == own_domain[:, None])
    return cost, feasible


# Bounded logs of recent solves: iteration counts, and which algorithm
# ("auction" | "hungarian") served each (Hungarian solves log 0 iterations).
RECENT_ITERATIONS: "deque[int]" = deque(maxlen=256)
RECENT_ALGORITHMS: "deque[str]" = deque(maxlen=256)

class HostSolve:
    """Completed host-side solve with the PendingSolve surface (the
    portfolio's Hungarian path finishes synchronously)."""

    def __init__(self, assignment: np.ndarray, num_jobs: int, num_domains: int, t0: float):
        self._assignment = assignment
        self._num_jobs = num_jobs
        self._num_domains = num_domains
        self._t0 = t0
        self._done_at = time.perf_counter()
        self._observe = True
        self.solve_seconds: float | None = None

    def is_ready(self) -> bool:
        return True

    @property
    def age_seconds(self) -> float:
        return time.perf_counter() - self._t0

    def result(self) -> np.ndarray:
        if self._observe:
            self._observe = False
            self.solve_seconds = self._done_at - self._t0
            metrics.solver_solve_time_seconds.observe(self.solve_seconds)
            RECENT_ITERATIONS.append(0)
            RECENT_ALGORITHMS.append("hungarian")
            # Under the fetching caller's active span, else a root of its
            # own, as the reference records a host solve.
            obs_trace.TRACER.record_span(
                "solver.solve_loop",
                self.solve_seconds,
                {"algorithm": "hungarian", "jobs": self._num_jobs,
                 "domains": self._num_domains},
            )
        return self._assignment

    @property
    def iterations(self) -> int:
        return 0


class PendingSolve:
    """Handle to a dispatched auction solve.

    On the card the kernel runs while the caller's Python goes on:
    `is_ready()` polls a CUDA event without blocking, and `result()` waits
    on that event, then copies the assignment to the host. The first
    `result()` observes `jobset_placement_solve_time_seconds` (dispatch ->
    device finished, as seen by the first poll that found it ready, or by
    the wait; also kept as `solve_seconds`) and records the
    `solver.solve_loop` and `solver.readback` spans."""

    def __init__(self, assignment, iters, num_jobs: int, num_domains: int, t0: float,
                 observe: bool, span_parent):
        self._assignment = assignment
        self._iters = iters
        self._num_jobs = num_jobs
        self._num_domains = num_domains
        self._t0 = t0
        self._observe = observe
        self._ready_at: float | None = None
        self._span_parent = span_parent
        self.solve_seconds: float | None = None

    def is_ready(self) -> bool:
        """True once the device has finished the solve (non-blocking)."""
        ready = bool(self._assignment.is_ready())
        if ready and self._ready_at is None:
            self._ready_at = time.perf_counter()
        return ready

    @property
    def age_seconds(self) -> float:
        return time.perf_counter() - self._t0

    def result(self) -> np.ndarray:
        observe_this_fetch = self._observe
        parent = self._result_parent() if observe_this_fetch else None
        # Wait on the device before timing the fetch, so the readback span
        # measures only the host copy and not the rest of the solve.
        if self._ready_at is None and not self.is_ready():
            self._assignment.block_until_ready()
            self.is_ready()  # stamp _ready_at
        fetch_t0 = time.perf_counter()
        out = np.asarray(self._assignment)[: self._num_jobs].astype(np.int64)
        fetch_end = time.perf_counter()
        out[out >= self._num_domains] = -1  # sinks/padding -> unassigned
        if observe_this_fetch:
            self._observe = False  # observe once, however often fetched
            self.solve_seconds = self._ready_at - self._t0
            metrics.solver_solve_time_seconds.observe(self.solve_seconds)
            iterations = int(self._iters)
            RECENT_ITERATIONS.append(iterations)
            RECENT_ALGORITHMS.append("auction")
            # Phase spans at first fetch: the solve loop's device wall time
            # (the interval the histogram observes) and the host readback.
            common = {"jobs": self._num_jobs, "domains": self._num_domains,
                      "iterations": iterations}
            obs_trace.TRACER.record_span(
                "solver.solve_loop", self.solve_seconds,
                {"algorithm": "auction", **common}, parent=parent,
            )
            obs_trace.TRACER.record_span(
                "solver.readback", fetch_end - fetch_t0, common, parent=parent
            )
        return out

    def _result_parent(self):
        """Attribution for result-time phase spans: the fetching caller's
        active span when there is one (the caller that paid the wait),
        else the dispatch-time solver span (late asynchronous fetches)."""
        return None if obs_trace.current_span() else self._span_parent

    @property
    def iterations(self) -> int:
        return int(self._iters)


class _BatchFetch:
    """One host readback shared by every member of a solve (a single solve
    is a batch of one): the first materialization copies the whole [B, J]
    assignment and [B] iteration counts, and every member slices
    host-side. `event` is the CUDA event recorded after the launch, or
    None for a solve that ran on the CPU."""

    def __init__(self, assignment, iters, event=None):
        self._assignment = assignment
        self._iters = iters
        self._event = event
        self._host: "tuple[np.ndarray, np.ndarray] | None" = None

    def is_ready(self) -> bool:
        return self._host is not None or self._event is None or self._event.query()

    def block(self) -> None:
        if self._host is None and self._event is not None:
            self._event.synchronize()

    def values(self) -> "tuple[np.ndarray, np.ndarray]":
        if self._host is None:
            self.block()
            self._host = (self._assignment.cpu().numpy(), self._iters.cpu().numpy())
        return self._host


class _BatchMemberView:
    """The device-array stand-in that PendingSolve polls and reads for one
    member of a shared _BatchFetch (is_ready/block_until_ready/np.asarray)."""

    def __init__(self, fetch: _BatchFetch, index: int):
        self._fetch = fetch
        self._index = index

    def is_ready(self) -> bool:
        return self._fetch.is_ready()

    def block_until_ready(self) -> None:
        self._fetch.block()

    def __array__(self, dtype=None, copy=None):
        row = self._fetch.values()[0][self._index]
        return row.astype(dtype) if dtype is not None else row


class _BatchIterView:
    """Lazy per-member iteration count off the shared fetch."""

    def __init__(self, fetch: _BatchFetch, index: int):
        self._fetch = fetch
        self._index = index

    def __int__(self) -> int:
        return int(self._fetch.values()[1][self._index])


def _pending(assignment, iters, device, members, span_parent):
    """PendingSolves over one launch's outputs ([B, J_p] and [B]), with
    one CUDA event and one shared readback. `members` lists (num_jobs,
    num_domains, t0, observe) per member; `span_parent` is the dispatching
    `solver.solve` span's context."""
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
    fetch = _BatchFetch(assignment, iters, event)
    return [PendingSolve(_BatchMemberView(fetch, b), _BatchIterView(fetch, b), *m,
                         span_parent=span_parent)
            for b, m in enumerate(members)]


def _pad(a, n, fill, dtype):
    out = np.full(n, fill, dtype)
    a = np.asarray(a, dtype)
    out[: a.shape[0]] = a
    return out


def _dense_benefit(costs, feasibles, jobs_p: int, domains_p: int, device):
    """[B, J, D] costs and feasibility (numpy) -> the scaled [B, J_p, D_p]
    f32 benefit on `device`. Costs are clipped to [0, COST_CAP - 1] and
    scaled to integers spaced J_p + 1 apart, so a final eps of 1 yields the
    exact optimum; padded and infeasible cells are NEG_INF. Built on the
    device from the copied costs, so the host does no O(J*D) work."""
    batch, num_jobs, num_domains = costs.shape
    cost = torch.from_numpy(np.ascontiguousarray(costs, np.float32)).to(device)
    feasible = torch.from_numpy(np.ascontiguousarray(feasibles, bool)).to(device)
    benefit = torch.full((batch, jobs_p, domains_p), NEG_INF, dtype=_F32, device=device)
    benefit[:, :num_jobs, :num_domains] = torch.where(
        feasible, COST_CAP - cost.clamp(0.0, COST_CAP - 1.0), NEG_INF
    )
    return benefit.mul_(float(jobs_p + 1))


_STRUCTURED = ("load", "free", "pods_needed", "sticky", "occupied", "own_domain")


def _stack_structured(problems, jobs_p: int, domains_p: int) -> "dict[str, np.ndarray]":
    """Structured problems padded to one bucket and stacked, by operand
    name, with `num_domains` last: padded domain columns are masked by
    `dcol < num_domains`; padded job rows get pods_needed=inf, so they land
    on their sinks."""
    fills = {"load": (domains_p, 0.0, np.float32), "free": (domains_p, -1.0, np.float32),
             "pods_needed": (jobs_p, np.inf, np.float32), "sticky": (jobs_p, -1, np.int32),
             "occupied": (domains_p, True, bool), "own_domain": (jobs_p, -1, np.int32)}
    stacked = {name: np.stack([_pad(p[name], *fills[name]) for p in problems])
               for name in _STRUCTURED}
    stacked["num_domains"] = np.asarray([len(p["load"]) for p in problems], np.int32)
    return stacked


class AssignmentSolver:
    """Padded auction solves, routed between the card and the host.

    `device`: where solves run by default, the card unless the caller asks
    for the CPU (`device="cpu"` or `backend="cpu"`); with no CUDA device
    and no such request the constructor raises. `backend`:
    - "auto" (default): each single solve is routed by the reference's
      cells-vs-round-trip model: a measured host -> card -> host ping
      (cached) against the cells' compute time on either side; small
      problems run on the host (the plain version, then the Hungarian
      portfolio), large ones and every batch on the card;
    - "default": every solve on `device`, auction only (no Hungarian);
    - "cpu": every solve on the host, with the portfolio.
    `routes` counts the solves dispatched to each device type. A ping
    that raises raises: a card that cannot move 32 bytes is a fault to
    report, not a reason to solve elsewhere.
    """

    # Sustained auction throughputs (cells/second over a whole solve) used
    # only to pick a side: the reference's constants.
    _CPU_CELLS_PER_S = 2.5e7
    _ACCEL_CELLS_PER_S = 5e9
    # Host portfolio: the auction under this iteration budget first, scipy's
    # Hungarian (exactly optimal, O(n^3)) when the budget trips, for
    # problems up to this many padded cells.
    _HUNGARIAN_MAX_CELLS = 1_200_000
    _HOST_AUCTION_ITER_CAP = 128
    # Residency cache: recent storm shapes only.
    _RESIDENT_SHAPES = 4

    def __init__(self, max_iters: int = 20000, backend: str = "auto", device=None):
        if backend not in ("auto", "default", "cpu"):
            raise ValueError(
                f"unknown solver backend {backend!r} (expected 'auto', 'default' or 'cpu')"
            )
        self.max_iters = max_iters
        self.backend = backend
        self.device = _CPU if backend == "cpu" else resolve_device(device)
        self._accel_rtt_s: float | None = None
        # Device-resident batch operands per (batch shape, device): the
        # previous round's host arrays and their device tensors. A storm
        # round whose operand is byte-equal to the cached one reuses the
        # device tensor; only changed operands are copied. Sound because
        # the kernel never writes its inputs. {key: {name: (host, device)}}
        self._batch_operands: dict[tuple, dict[str, tuple]] = {}
        self.batch_operand_transfers = 0  # host -> device copies (misses)
        self.batch_operand_reuses = 0     # residency hits
        self.routes = {"cuda": 0, "cpu": 0}
        self.last_iterations = 0

    def _ping_default_device(self) -> float:
        """Measured host -> card -> host round trip of 32 bytes, cached:
        the median of three copies."""
        if self._accel_rtt_s is None:
            torch.zeros(8).to(self.device).cpu()
            samples = []
            for _ in range(3):
                t0 = time.perf_counter()
                torch.ones(8).to(self.device).cpu()
                samples.append(time.perf_counter() - t0)
            self._accel_rtt_s = sorted(samples)[1]
        return self._accel_rtt_s

    def _solve_device(self, cells: int, is_batched: bool = False) -> torch.device:
        """The device a solve of `cells` padded cells runs on."""
        if self.backend == "default" or self.device.type == "cpu" or is_batched:
            return self.device
        rtt = self._ping_default_device()
        # 3x: a solve is several link crossings (operands in, launch,
        # result out); a co-located card pings in microseconds.
        accel_est = 3.0 * rtt + cells / self._ACCEL_CELLS_PER_S
        cpu_est = cells / self._CPU_CELLS_PER_S
        return _CPU if cpu_est < accel_est else self.device

    def _route(self, cells: int, is_batched: bool = False) -> torch.device:
        device = self._solve_device(cells, is_batched)
        self.routes[device.type] = self.routes.get(device.type, 0) + 1
        return device

    def _host_hungarian(self, cells: int) -> bool:
        """True when a single solve runs on the host and is small enough
        for the Hungarian fallback. backend='default' opts out: it pins the
        auction."""
        if self.backend == "default" or cells > self._HUNGARIAN_MAX_CELLS:
            return False
        if not _scipy_available():
            return False
        return self._solve_device(cells).type == "cpu"

    def prefers_host_singles(self, problems: "list[dict]") -> bool:
        """True when a storm of structured problems is cheaper as routed
        single solves than as one batched launch on the card: only in auto
        mode with the card as the device, and only when every problem
        routes to the host on its own."""
        if self.backend != "auto" or not problems or self.device.type == "cpu":
            return False
        for p in problems:
            jobs_p = _round_up_pow2(len(p["pods_needed"]))
            domains_p = _round_up_pow2(len(p["load"]))
            if self._solve_device(jobs_p * domains_p).type != "cpu":
                return False
        return True

    def _capped_or_hungarian(self, pending: PendingSolve, fallback):
        """Keep the host auction's result when it converged inside the
        iteration budget; otherwise run the Hungarian fallback."""
        if pending.iterations < self._HOST_AUCTION_ITER_CAP:
            return pending
        return fallback()

    @staticmethod
    def _hungarian_solve(cost, feasible, num_jobs: int, num_domains: int,
                         t0: float) -> HostSolve:
        from scipy.optimize import linear_sum_assignment  # gated upstream

        # 5*COST_CAP reproduces the auction's sink tradeoff: a job is
        # stranded when its best option is worse than the sink benefit
        # -4*COST_CAP, an effective cost of 5*COST_CAP.
        with obs_trace.span(
            "solver.hungarian_fallback",
            {"jobs": num_jobs, "domains": num_domains},
        ):
            big_m = 5.0 * COST_CAP
            dense = np.where(feasible, np.clip(cost, 0.0, COST_CAP - 1.0), big_m)
            assignment = np.full(num_jobs, -1, np.int64)
            rows, cols = linear_sum_assignment(dense)
            ok = dense[rows, cols] < big_m
            assignment[rows[ok]] = cols[ok]
        return HostSolve(assignment, num_jobs, num_domains, t0)

    def solve_async(self, cost: np.ndarray, feasible: Optional[np.ndarray] = None):
        """Dispatch one assignment solve without waiting for the result.

        cost: [J, D] non-negative costs (smaller = better), float or int.
        feasible: [J, D] bool mask (default: all feasible).

        The reference builds the [J_p, D_p] benefit on the host and copies
        it; this path copies the [J, D] costs and mask and builds the
        benefit on the device, so `jobset_jit_transfer_bytes_total` counts
        5 bytes a cell (f32 cost, bool mask) where the reference counts 4
        a padded cell. `matrix_mb` keeps the reference's formula.
        """
        t0 = time.perf_counter()
        cost = np.asarray(cost, np.float32)
        num_jobs, num_domains = cost.shape
        if feasible is None:
            feasible = np.ones_like(cost, dtype=bool)
        jobs_p = _round_up_pow2(num_jobs)
        domains_p = _round_up_pow2(num_domains)
        host_small = self._host_hungarian(jobs_p * domains_p)
        max_iters = self._HOST_AUCTION_ITER_CAP if host_small else self.max_iters

        with obs_trace.span(
            "solver.solve",
            {"kind": "dense", "jobs": num_jobs, "domains": num_domains},
            activate=True,
        ) as solve_span:
            metrics.solver_batch_occupancy.set(
                (num_jobs * num_domains) / (jobs_p * domains_p)
            )
            metrics.solver_batch_problems.set(1)
            device = self._route(jobs_p * domains_p)
            with obs_trace.span(
                "solver.host_transfer",
                {"matrix_mb": round(jobs_p * domains_p * 4 / 1e6, 3)},
            ):
                cost_h, feasible_h = cost[None], np.asarray(feasible, bool)[None]
                benefit = _dense_benefit(cost_h, feasible_h, jobs_p, domains_p, device)
                profile.note_transfer("solver_auction", "h2d", cost_h, feasible_h)
            with obs_trace.span("solver.dispatch") as dispatch:
                (assignment, _, iters), first = profile.jit_shape_call(
                    "solver_auction", _dense, benefit, 1.0, max_iters=max_iters,
                    batched=False,
                )
                dispatch.set_attribute("compile_cache", "miss" if first else "hit")
            (pending,) = _pending(assignment, iters, device,
                                  [(num_jobs, num_domains, t0, True)], solve_span.context)
            if host_small:
                return self._capped_or_hungarian(
                    pending,
                    lambda: self._hungarian_solve(cost, feasible, num_jobs, num_domains, t0),
                )
            return pending

    def solve(self, cost: np.ndarray, feasible: Optional[np.ndarray] = None) -> np.ndarray:
        """Solve one assignment problem, waiting for the result.

        Returns [J] int64 domain indexes, -1 where unassignable."""
        pending = self.solve_async(cost, feasible)
        out = pending.result()
        self.last_iterations = pending.iterations
        return out

    def solve_structured_async(self, load, free, pods_needed, sticky, occupied, own_domain):
        """Dispatch a solve from the O(J + D) cost parametrization; the
        dense benefit is built on the device, so only kilobytes cross to
        the card. The six padded operands are counted as transferred, as
        in the reference; the real domain count, a 4-byte scalar copied
        with them, is counted in neither."""
        t0 = time.perf_counter()
        num_jobs = int(pods_needed.shape[0])
        num_domains = int(load.shape[0])
        jobs_p = _round_up_pow2(num_jobs)
        domains_p = _round_up_pow2(num_domains)
        host_small = self._host_hungarian(jobs_p * domains_p)
        max_iters = self._HOST_AUCTION_ITER_CAP if host_small else self.max_iters

        with obs_trace.span(
            "solver.solve",
            {"kind": "structured", "jobs": num_jobs, "domains": num_domains},
        ) as solve_span:
            metrics.solver_batch_occupancy.set(
                (num_jobs * num_domains) / (jobs_p * domains_p)
            )
            metrics.solver_batch_problems.set(1)
            device = self._route(jobs_p * domains_p)
            with obs_trace.span("solver.host_transfer", {
                "params_kb": round((3 * jobs_p * 4 + 3 * domains_p * 4) / 1024.0, 3),
            }):
                problem = dict(load=load, free=free, pods_needed=pods_needed, sticky=sticky,
                               occupied=occupied, own_domain=own_domain)
                stacked = _stack_structured([problem], jobs_p, domains_p)
                operands = [torch.from_numpy(a).to(device) for a in stacked.values()]
                profile.note_transfer("solver_auction_structured", "h2d",
                                      *(stacked[name] for name in _STRUCTURED))
            with obs_trace.span("solver.dispatch") as dispatch:
                (assignment, iters), first = profile.jit_shape_call(
                    "solver_auction_structured", _structured, *operands,
                    max_iters=max_iters, batched=False,
                )
                dispatch.set_attribute("compile_cache", "miss" if first else "hit")
            (pending,) = _pending(assignment, iters, device,
                                  [(num_jobs, num_domains, t0, True)], solve_span.context)
            if host_small:
                # The Hungarian fallback builds the same cost model on the host.
                def fallback():
                    cost, feasible = _structured_cost_np(
                        np.asarray(load, np.float32), np.asarray(free, np.float32),
                        np.asarray(pods_needed, np.float32), np.asarray(sticky, np.int32),
                        np.asarray(occupied, bool), np.asarray(own_domain, np.int32),
                    )
                    return self._hungarian_solve(cost, feasible, num_jobs, num_domains, t0)

                return self._capped_or_hungarian(pending, fallback)
            return pending

    def solve_structured_batch_async(self, problems: "list[dict]") -> "list[PendingSolve]":
        """Dispatch many structured solves as one launch.

        problems: kwargs dicts as accepted by solve_structured_async, padded
        to the batch's common power-of-two bucket. Returns one PendingSolve
        per problem, sharing one event and one readback; solve time and
        iterations are observed once for the batch (member 0). The
        `resident_hits` attribute says how many operands stayed on the
        device; `jobset_jit_transfer_bytes_total` counts the operands that
        were copied, where the reference counts none on this path."""
        t0 = time.perf_counter()
        jobs_p = _round_up_pow2(max(int(p["pods_needed"].shape[0]) for p in problems))
        domains_p = _round_up_pow2(max(int(p["load"].shape[0]) for p in problems))
        # Batch occupancy: real problem cells over the padded batch's cells.
        real_cells = sum(int(p["pods_needed"].shape[0]) * int(p["load"].shape[0])
                         for p in problems)
        padded_cells = len(problems) * jobs_p * domains_p
        metrics.solver_batch_occupancy.set(real_cells / max(padded_cells, 1))
        metrics.solver_batch_problems.set(len(problems))

        with obs_trace.span(
            "solver.solve",
            {"kind": "structured_batch", "problems": len(problems),
             "jobs_padded": jobs_p, "domains_padded": domains_p,
             "batch_occupancy": round(real_cells / max(padded_cells, 1), 4)},
        ) as solve_span:
            device = self._route(len(problems) * jobs_p * domains_p, is_batched=True)
            with obs_trace.span("solver.host_transfer", {
                "params_kb": round(
                    len(problems) * (3 * jobs_p + 3 * domains_p) * 4 / 1024.0, 3
                ),
            }) as transfer_span:
                stacked = _stack_structured(problems, jobs_p, domains_p)
                operands, hits = self._resident_operands(
                    (len(problems), jobs_p, domains_p), stacked, device)
                transfer_span.set_attribute("resident_hits", hits)
            with obs_trace.span("solver.dispatch") as dispatch:
                (assignment, iters), first = profile.jit_shape_call(
                    "solver_auction_structured_batch", _auction_structured_batch,
                    *operands.values(), max_iters=self.max_iters,
                )
                dispatch.set_attribute("compile_cache", "miss" if first else "hit")
            return _pending(assignment, iters, device, [
                (int(p["pods_needed"].shape[0]), int(p["load"].shape[0]), t0, b == 0)
                for b, p in enumerate(problems)
            ], solve_span.context)

    def _resident_operands(self, shape_key: tuple, stacked: "dict[str, np.ndarray]", device):
        """Host arrays -> device tensors through the residency cache: an
        operand byte-equal to the previous round's stays on the device and
        only changed operands are copied, and their bytes are counted as
        the storm kernel's h2d transfer. Returns (tensors by name,
        residency hit count)."""
        key = shape_key + (str(device),)
        cached = self._batch_operands.get(key)
        if cached is None:
            while len(self._batch_operands) >= self._RESIDENT_SHAPES:
                self._batch_operands.pop(next(iter(self._batch_operands)))
            cached = self._batch_operands[key] = {}
        out = {}
        copied = []
        for name, host in stacked.items():
            entry = cached.get(name)
            if entry is not None and np.array_equal(entry[0], host):
                out[name] = entry[1]
                self.batch_operand_reuses += 1
            else:
                tensor = torch.from_numpy(host).to(device)
                cached[name] = (host, tensor)
                out[name] = tensor
                copied.append(host)
                self.batch_operand_transfers += 1
        profile.note_transfer("solver_auction_structured_batch", "h2d", *copied)
        return out, len(stacked) - len(copied)

    def solve_batch(self, costs: np.ndarray, feasibles: Optional[np.ndarray] = None) -> np.ndarray:
        """Dense solves of a [B, J, D] stack in one launch -> [B, J]. As on
        the dense single path, the [B, J, D] costs and masks are what is
        copied and counted."""
        t0 = time.perf_counter()
        costs = np.asarray(costs, np.float32)
        batch, num_jobs, num_domains = costs.shape
        if feasibles is None:
            feasibles = np.ones_like(costs, dtype=bool)
        jobs_p = _round_up_pow2(num_jobs)
        domains_p = _round_up_pow2(num_domains)

        metrics.solver_batch_occupancy.set(
            (batch * num_jobs * num_domains) / (batch * jobs_p * domains_p)
        )
        metrics.solver_batch_problems.set(batch)
        with obs_trace.span(
            "solver.solve",
            {"kind": "dense_batch", "problems": batch, "jobs": num_jobs,
             "domains": num_domains},
        ):
            device = self._route(batch * jobs_p * domains_p, is_batched=True)
            with obs_trace.span("solver.host_transfer", {
                "matrix_mb": round(batch * jobs_p * domains_p * 4 / 1e6, 3),
            }):
                feasibles = np.asarray(feasibles, bool)
                benefit = _dense_benefit(costs, feasibles, jobs_p, domains_p, device)
                profile.note_transfer("solver_auction_batch", "h2d", costs, feasibles)
            with obs_trace.span("solver.dispatch") as dispatch:
                (assignment, _, _), first = profile.jit_shape_call(
                    "solver_auction_batch", _auction_batch, benefit, 1.0,
                    max_iters=self.max_iters,
                )
                dispatch.set_attribute("compile_cache", "miss" if first else "hit")
                assignments = assignment.cpu().numpy()
        out = assignments[:, :num_jobs].astype(np.int64)
        out[out >= num_domains] = -1
        metrics.solver_solve_time_seconds.observe(time.perf_counter() - t0)
        return out
