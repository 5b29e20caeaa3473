"""Pipeline parallelism over the `pp` axis: the port's counterpart of
`jobset_tpu/parallel/pipeline.py`, with its three schedules.

The reference runs each schedule as one `lax.scan` of a branch-free
program: every rank runs its stage at every step and masks the inactive
ones, and its backward is autodiff's transpose of the scan (or, for 1F1B,
a masked VJP in every iteration). Eager PyTorch needs no static program,
so the port runs one loop (`drive`) over host-built timetables
(`timetable`): for each phase, each rank's event, if it has one, then,
where some rank hands a result on, one `collectives.shift` over pp that
every pp rank calls.

- F(b, c): the forward of chunk c of this rank's layers on microbatch b,
  recorded by autograd from an input that is a detached leaf; the input,
  the output and the chunk's extra outputs (the MoE balancing statistics)
  are kept until the event's B.
- B(b, c): the backward of that saved graph, seeded with the output's
  cotangent (and the extras'); the input's cotangent goes upstream.
  Parameter gradients accumulate in the leaves the stage reads.

Activations move +1 after an F phase, cotangents -1 after a B phase:
non-cyclic under "gpipe" and "1f1b" (rank pp-1 sends nothing, rank 0
receives zeros), cyclic under "interleaved" (the wrap from rank pp-1 to
rank 0 carries a microbatch into its next chunk). The pp transfers stay
outside autograd, so every pp collective is an explicit call on every pp
rank, in the one order of the timetable; the collectives inside a stage
(tp, sp) run among ranks that share the pp index, and so the same events.
A rank with no event in a phase only takes part in the shift, so the
bubble costs no stage work; the numbers are the reference's, whose masked
steps add zeros.

- "gpipe": F(b) at step b + r; then every B, in the reverse order.
- "interleaved": rank r holds `n_virtual` chunks (global stages c*pp + r,
  `interleave_stage_params`); F on the reference's closed-form timetable
  t(b, c, r) = (b // pp) * pp * v + c * pp + b % pp + r, then B on its
  reverse.
- "1f1b": F and B on the reference's host tables (`schedule_1f1b`): each
  iteration an F phase, then a B phase; rank r never keeps more than
  2 * (pp - r) - 1 saved graphs. The last rank runs no F: its B runs the
  stage and the loss head forward and backward at once.

Under "gpipe" and "interleaved" the loss needs every microbatch's output
(and the MoE statistics of every unit), so all F events run first, then
`finish` forms each rank's objective from them and differentiates it,
then the B events run. Under "1f1b" the head runs inside the last rank's
B events (`head`).

The tables are numpy, the port's own copies of the reference's
`schedule_steps`, `interleave_stage_params` and `_schedule_1f1b`; the
tests hold them equal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .collectives import shift

SCHEDULES = ("gpipe", "interleaved", "1f1b")


def schedule_steps(n_micro: int, pp: int, n_virtual: int = 1) -> int:
    """The reference's ring steps of a schedule, in chunk steps: n_micro +
    pp - 1 for GPipe (n_virtual = 1), n_micro * n_virtual + pp - 1 for the
    interleave when pp divides n_micro (a trailing partial group drains a
    few steps later)."""
    last = n_micro - 1
    return (last // pp) * pp * n_virtual + (n_virtual - 1) * pp + last % pp + pp


def interleave_stage_params(layers, pp: int, n_virtual: int):
    """A GPipe-placed stacked layer tree ([pp, lps, ...] leaves, global
    layer L = rank * lps + slot) in the interleaved placement: rank r,
    slot c * lpc + i holds global chunk c * pp + r's layer i (lpc = lps /
    n_virtual). The model is the same; only which rank holds which layer
    changes."""
    from .. import tree

    v = n_virtual

    def conv(a):
        pp_, lps = a.shape[0], a.shape[1]
        if lps % v:
            raise ValueError(f"layers_per_stage {lps} not divisible by {v}")
        lpc = lps // v
        chunks = a.reshape(v, pp_, lpc, *a.shape[2:])  # [c, r, i, ...], global order
        return chunks.movedim(1, 0).reshape(pp_, lps, *a.shape[2:]).contiguous()

    return tree.tree_map(conv, layers)


def schedule_1f1b(n_micro: int, pp: int):
    """The reference's `_schedule_1f1b`: (f_mb, b_mb, rxf_mb, rxb_mb,
    buf_size), [T, pp] int32 tables of the microbatch each rank runs
    forward and backward in each iteration (-1: none) and the microbatch
    whose activation (cotangent) arrives, and the ring buffers' width.
    Greedy under the dependencies and the cap of 2 * (pp - r) - 1
    microbatches in flight on rank r; the last rank runs no forward."""
    m = int(n_micro)
    if m <= 0:
        raise ValueError(f"n_micro must be positive, got {m}")
    if pp == 1:
        f_mb = np.full((m, 1), -1, np.int32)
        b_mb = np.arange(m, dtype=np.int32).reshape(m, 1)
        rxf = np.full((m, 1), -1, np.int32)
        rxb = np.full((m, 1), -1, np.int32)
        return f_mb, b_mb, rxf, rxb, 1

    neg = -1
    f_done = np.full((pp, m), neg, np.int64)  # iteration of F(b, r)
    b_done = np.full((pp, m), neg, np.int64)  # iteration of B(b, r)
    f_next, b_next = [0] * pp, [0] * pp
    cap = [max(1, 2 * (pp - r) - 1) for r in range(pp)]
    rows_f, rows_b = [], []
    k = 0
    while any(b_next[r] < m for r in range(pp)):
        rowf = [neg] * pp
        for r in range(pp - 1):
            bf = f_next[r]
            if bf < m and (bf - b_next[r]) < cap[r]:
                if r == 0 or 0 <= f_done[r - 1][bf] <= k - 1:
                    rowf[r] = bf
                    f_done[r][bf] = k
                    f_next[r] += 1
        rowb = [neg] * pp
        for r in range(pp):
            b = b_next[r]
            if b < m:
                if r == pp - 1:
                    ready = 0 <= f_done[pp - 2][b] <= k
                else:
                    ready = 0 <= b_done[r + 1][b] <= k - 1 and 0 <= f_done[r][b] <= k
                if ready:
                    rowb[r] = b
                    b_done[r][b] = k
                    b_next[r] += 1
        rows_f.append(rowf)
        rows_b.append(rowb)
        k += 1
        if k > 4 * (m + pp) + 8:
            raise AssertionError(f"1f1b schedule did not converge (m={m}, pp={pp})")

    f_mb = np.array(rows_f, np.int32)
    b_mb = np.array(rows_b, np.int32)
    rxf = np.full((k, pp), neg, np.int32)
    rxb = np.full((k, pp), neg, np.int32)
    rxf[:, 1:] = f_mb[:, :-1]
    rxb[1:, :-1] = b_mb[:-1, 1:]

    buf = 1

    def widest(starts, ends):
        """The most live intervals at once (both edges nondecreasing)."""
        nonlocal buf
        lo = 0
        for hi in range(m):
            while ends[lo] < starts[hi]:
                lo += 1
            buf = max(buf, hi - lo + 1)

    for r in range(1, pp):
        widest(f_done[r - 1], b_done[r])
    for r in range(pp - 1):
        widest(b_done[r + 1] + 1, b_done[r])
    if buf > 2 * pp:
        raise AssertionError(f"1f1b buffer bound violated: width {buf} > 2*pp (m={m}, pp={pp})")
    return f_mb, b_mb, rxf, rxb, buf


# ---------------------------------------------------------------------------
# Timetables
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Phase:
    """One phase of a timetable: `kind` "F" or "B", and for each pp rank its
    event (microbatch, chunk) or None."""

    kind: str
    events: tuple


@dataclass(frozen=True)
class Timetable:
    """A schedule's phases for every pp rank, and how the shift runs:
    `cyclic` (the interleave's wrap), `fused` (1F1B: the last rank's B runs
    its stage and the head forward and backward at once)."""

    schedule: str
    n_micro: int
    pp: int
    n_virtual: int
    phases: tuple
    cyclic: bool
    fused: bool

    def forward(self) -> "Timetable":
        """The F phases alone (an eval step's), with no fused event: 1F1B's
        forward is GPipe's wavefront, as the reference's eval runs it."""
        if self.fused:
            return timetable("gpipe", self.n_micro, self.pp).forward()
        return Timetable(self.schedule, self.n_micro, self.pp, self.n_virtual,
                         tuple(p for p in self.phases if p.kind == "F"), self.cyclic, False)


def _interleaved_events(t: int, n_micro: int, pp: int, v: int) -> tuple:
    """Each rank's (microbatch, chunk) at step t of the reference's
    interleaved timetable, inverted."""
    out = []
    for r in range(pp):
        local = t - r
        rem = local % (pp * v)
        b = (local // (pp * v)) * pp + rem % pp
        out.append((b, rem // pp) if local >= 0 and b < n_micro else None)
    return tuple(out)


def timetable(schedule: str, n_micro: int, pp: int, n_virtual: int = 1) -> Timetable:
    """The phases of `schedule` ("gpipe", "interleaved", "1f1b") for
    n_micro microbatches over pp ranks (n_virtual chunks a rank under
    "interleaved"). A phase where no rank has an event is left out."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline_schedule {schedule!r}")
    if n_micro < 1:
        raise ValueError(f"n_micro must be positive, got {n_micro}")
    v = n_virtual if schedule == "interleaved" else 1
    if schedule == "1f1b":
        f_mb, b_mb, _, _, _ = schedule_1f1b(n_micro, pp)
        phases = []
        for f_row, b_row in zip(f_mb, b_mb):
            for kind, row in (("F", f_row), ("B", b_row)):
                events = tuple((int(b), 0) if b >= 0 else None for b in row)
                if any(e is not None for e in events):
                    phases.append(Phase(kind, events))
        return Timetable(schedule, n_micro, pp, 1, tuple(phases), False, True)
    if schedule == "gpipe":
        forward = [tuple((t - r, 0) if 0 <= t - r < n_micro else None for r in range(pp))
                   for t in range(n_micro + pp - 1)]
    else:
        forward = [_interleaved_events(t, n_micro, pp, v)
                   for t in range(schedule_steps(n_micro, pp, v))]
    forward = [events for events in forward if any(e is not None for e in events)]
    phases = [Phase("F", e) for e in forward] + [Phase("B", e) for e in reversed(forward)]
    return Timetable(schedule, n_micro, pp, v, tuple(phases), schedule == "interleaved", False)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def _sends(table: Timetable, rank: int, kind: str, event) -> bool:
    """Whether `rank`'s event of a phase hands its result to a neighbour:
    an F unless it is the last stage (its output goes to the head), a B
    unless it is the first (its input's cotangent goes to the feed)."""
    if event is None:
        return False
    _, c = event
    if kind == "F":
        return not (rank == table.pp - 1 and c == table.n_virtual - 1)
    return not (rank == 0 and c == 0)


@dataclass
class PipelineRun:
    """What `drive` leaves on this rank: the last stage's outputs by
    microbatch (an eval's; detached), the feed's cotangents by microbatch
    (rank 0's, for the embedding's backward), the fused heads' values (the
    last rank's under 1F1B), and the most saved graphs it held at once."""

    outputs: dict
    feed_grads: dict
    head_values: list
    peak_saved: int


def drive(table: Timetable, rank: int, group, stage: Callable, feed: Callable, like,
          finish: Optional[Callable] = None, head: Optional[Callable] = None,
          train: bool = True) -> PipelineRun:
    """Run `table` on pp rank `rank` of `group` (None: pp = 1).

    stage(b, c, x) -> (y, extra): chunk c of this rank's layers on
    microbatch b's input x, y shaped as x; `extra` a tensor that may need a
    cotangent (the balancing statistics), or None.
    feed(b) -> the first stage's input for microbatch b (rank 0, chunk 0).
    like: a tensor of the activation's shape, dtype and device (what an
    idle rank sends).
    finish(outputs, extras) -> objective or None (gpipe, interleaved; train):
    outputs {b: y} of the last stage and extras {(b, c): extra} of this
    rank's events, each a detached leaf that requires grad; `drive`
    differentiates the objective (every rank calls finish, in one order,
    between the F and the B events) and seeds each B with the leaves'
    gradients.
    head(b, y) -> objective (1f1b): the last stage's loss head for
    microbatch b, differentiated inside the last rank's B(b).
    train=False runs the F phases under no_grad and keeps the last stage's
    outputs."""
    pp = table.pp
    if table.fused and head is None and train:
        raise ValueError("a 1f1b timetable needs the loss head (head=)")
    inbox_x: dict = {}   # activations received, by the event that consumes them
    inbox_dy: dict = {}  # cotangents received, likewise
    saved: dict = {}     # (b, c) -> (input leaf, output, extra)
    outputs: dict = {}
    feed_grads: dict = {}
    head_values: list = []
    peak = 0
    zeros = torch.zeros_like(like)
    phases = table.phases if train else table.forward().phases
    # Under gpipe and interleaved, `finish` runs after the last F phase.
    last_f = (max(i for i, p in enumerate(phases) if p.kind == "F")
              if train and not table.fused else None)

    def take_input(b, c):
        x = feed(b) if rank == 0 and c == 0 else inbox_x.pop((b, c))
        return x.detach().requires_grad_(train)

    for i, phase in enumerate(phases):
        event = phase.events[rank]
        sent = None
        if event is not None:
            b, c = event
            if phase.kind == "F":
                x = take_input(b, c)
                with torch.set_grad_enabled(train):
                    y, extra = stage(b, c, x)
                if train:
                    saved[(b, c)] = (x, y, extra)
                    peak = max(peak, len(saved))
                if _sends(table, rank, "F", event):
                    sent = y.detach()
                elif not train:
                    outputs[b] = y.detach()
            else:
                if table.fused and (b, c) not in saved:  # 1F1B's last stage
                    x = take_input(b, c)
                    y, _ = stage(b, c, x)
                    objective = head(b, y)
                    head_values.append(objective.detach())
                    objective.backward()
                else:
                    x, y, extra = saved.pop((b, c))
                    dy = inbox_dy.pop((b, c))
                    outs, grads = [y], [dy]
                    if extra is not None and ("extra", b, c) in inbox_dy:
                        outs.append(extra)
                        grads.append(inbox_dy.pop(("extra", b, c)))
                    torch.autograd.backward(outs, [g.to(o.dtype) for g, o in zip(grads, outs)])
                dx = x.grad if x.grad is not None else torch.zeros_like(x)
                if _sends(table, rank, "B", event):
                    sent = dx
                else:
                    feed_grads[b] = dx
        if any(_sends(table, r, phase.kind, e) for r, e in enumerate(phase.events)):
            step = 1 if phase.kind == "F" else -1
            got = shift(sent if sent is not None else zeros, group, step, table.cyclic)
            src = rank - step
            if table.cyclic:
                src %= pp
            if 0 <= src < pp and _sends(table, src, phase.kind, phase.events[src]):
                b, c = phase.events[src]
                if phase.kind == "F":
                    inbox_x[(b, c + 1 if src == pp - 1 else c)] = got
                else:
                    inbox_dy[(b, c - 1 if src == 0 else c)] = got
        if i == last_f:
            _finish(finish, saved, inbox_dy, table, rank)
    if inbox_x or inbox_dy or (train and saved):
        raise AssertionError(f"pipeline rank {rank}: left over after the schedule: "
                             f"{sorted(inbox_x)}, {sorted(inbox_dy)}, {sorted(saved)}")
    return PipelineRun(outputs, feed_grads, head_values, peak)


def _finish(finish, saved, inbox_dy, table: Timetable, rank: int) -> None:
    """Between the F and the B phases: the last stage's outputs and every
    event's extras as fresh leaves, `finish`'s objective differentiated,
    and the B events' seeds filed (the last stage's output cotangents, the
    extras' where the objective reaches them)."""
    last = table.n_virtual - 1
    outputs = {b: y.detach().requires_grad_() for (b, c), (_, y, _) in saved.items()
               if rank == table.pp - 1 and c == last}
    extras = {key: e.detach().requires_grad_() for key, (_, _, e) in saved.items()
              if e is not None and e.grad_fn is not None}
    objective = finish(outputs, extras) if finish is not None else None
    if objective is not None and objective.requires_grad:
        objective.backward()
    for b, leaf in outputs.items():
        inbox_dy[(b, last)] = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
    for (b, c), leaf in extras.items():
        inbox_dy[("extra", b, c)] = (leaf.grad if leaf.grad is not None
                                     else torch.zeros_like(leaf))
