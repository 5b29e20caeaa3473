"""In-process span tracer with W3C traceparent propagation.

Counterpart of `jobset_tpu/obs/trace.py`, framework-free and kept as its
own copy: the same span records, header rules, ring bounds and ids, so
whatever reads the reference's traces reads the port's.

Design constraints, in order:

1. **Hot-path cheap.** Spans are started/ended inside timed reconcile
   passes (the very latencies they attribute), so the per-span cost is a
   clock pair, two ids, one short lock at each end, and one contextvar
   set/reset; a finished span becomes a dict only when it is read.
2. **Bounded memory.** Finished traces land in a ring buffer
   (``maxlen`` traces); open traces that never finish (a crashed request)
   are capped too, evicted FIFO. A long-running controller's trace memory
   is flat regardless of churn.
3. **Cross-process by header only.** Propagation is the W3C
   ``traceparent`` header (``00-<32hex trace>-<16hex span>-<2hex flags>``),
   injected by the HTTP client and extracted by the server — the exact
   contract real OpenTelemetry stacks interoperate on, so swapping this
   tracer for an OTLP exporter later changes no call sites.

Context propagation uses ``contextvars``: each server handler thread and
the background pump thread get independent active-span state for free,
while nested ``with span(...)`` blocks inside one request chain correctly.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Optional

_TRACEPARENT_VERSION = "00"
_SAMPLED_FLAGS = "01"


@dataclass(frozen=True)
class SpanContext:
    """Immutable identity of a span: what crosses process boundaries and
    what children parent onto. ``trace_id`` is 32 lowercase hex chars,
    ``span_id`` 16 — W3C trace-context sizes."""

    trace_id: str
    span_id: str

    def to_traceparent(self) -> str:
        return (
            f"{_TRACEPARENT_VERSION}-{self.trace_id}-{self.span_id}"
            f"-{_SAMPLED_FLAGS}"
        )


def extract_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C traceparent header into a SpanContext, or None when the
    header is absent/malformed (a bad header must never fail a request —
    the trace just starts fresh server-side)."""
    if not header:
        return None
    parts = header.strip().split("-")
    # Version 00 is exactly 4 fields (W3C trace-context §traceparent);
    # extra fields or a non-2-hex flags byte mean a malformed header and
    # the trace restarts here.
    if len(parts) != 4 or parts[0] != _TRACEPARENT_VERSION:
        return None
    trace_id, span_id, flags = parts[1].lower(), parts[2].lower(), parts[3]
    if len(trace_id) != 32 or len(span_id) != 16 or len(flags) != 2:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # all-zero ids are invalid per the spec
    return SpanContext(trace_id=trace_id, span_id=span_id)


class Span:
    """One timed operation. Mutable while open; a finished span is kept in
    its trace record and read out as a plain dict (``to_dict``) — off the
    hot path, with the same values as a dict made at its end."""

    __slots__ = (
        "name",
        "context",
        "parent_id",
        "attributes",
        "start_wall",
        "_start_perf",
        "duration_s",
        "status",
        "_tracer",
        "_token",
        "_is_local_root",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        context: SpanContext,
        parent_id: Optional[str],
        attributes: Optional[dict] = None,
    ):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.attributes: dict = dict(attributes or {})
        # Wall stamps are display metadata; durations use perf_counter.
        self.start_wall = time.time()
        self._start_perf = time.perf_counter()
        self.duration_s: Optional[float] = None
        self.status = "ok"
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None
        self._is_local_root = False

    # -- enrichment -------------------------------------------------------

    def set_attribute(self, key: str, value) -> "Span":
        self.attributes[key] = value
        return self

    def record_error(self, exc: BaseException) -> None:
        self.status = "error"
        self.attributes["error"] = f"{type(exc).__name__}: {exc}"[:200]

    # -- lifecycle --------------------------------------------------------

    def end(self) -> None:
        if self.duration_s is not None:
            return  # idempotent: double-end keeps the first duration
        self.duration_s = time.perf_counter() - self._start_perf
        self._tracer._on_span_end(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.record_error(exc)
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        self.end()
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.context.trace_id,
            "span_id": self.context.span_id,
            "parent_span_id": self.parent_id,
            "start_unix_s": round(self.start_wall, 6),
            "duration_ms": round((self.duration_s or 0.0) * 1000.0, 4),
            "status": self.status,
            "attributes": self.attributes,
        }


_current_span: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "jobset_tpu_torch_current_span", default=None
)


class Tracer:
    """Span factory + bounded store of finished traces.

    A *trace record* accumulates the finished spans of one trace id. The
    record moves to the finished ring when its **root** span (the one with
    no parent inside this process) ends; spans that finish later — e.g. a
    solver readback fetched ticks after the reconcile that dispatched it —
    are appended to the record wherever it lives, so async tails still
    attribute to the right trace.
    """

    def __init__(self, max_traces: int = 256, max_spans_per_trace: int = 512):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self._lock = threading.Lock()
        # trace_id -> record; record: {"trace_id", "spans": [Span], "roots": int}
        self._open: "OrderedDict[str, dict]" = OrderedDict()
        self._finished: "deque[dict]" = deque(maxlen=max_traces)
        self._by_id: dict[str, dict] = {}  # finished records still in the ring
        self.dropped_spans = 0
        # Optional complete duration log (enable_duration_log): every ended
        # span's duration by name, independent of ring eviction — the bench
        # needs whole-run phase percentiles, and a 512-pod recovery roots
        # far more than max_traces traces. Unbounded while enabled, so not
        # for long-running servers (the Histogram.enable_raw pattern).
        self._duration_log: Optional[dict[str, list[float]]] = None

    # -- id generation ----------------------------------------------------

    # Mersenne-Twister ids, not os.urandom: span creation sits inside timed
    # reconcile passes (some reconciles are ~30 us) and getrandbits avoids a
    # syscall per id. Uniqueness, not unpredictability, is the requirement.
    # Deliberately the process-global stream: random.seed() makes a seeded
    # run draw the same ids.
    @staticmethod
    def _new_trace_id() -> str:
        return f"{random.getrandbits(128):032x}"

    @staticmethod
    def _new_span_id() -> str:
        return f"{random.getrandbits(64):016x}"

    # -- span lifecycle ---------------------------------------------------

    def start_span(
        self,
        name: str,
        attributes: Optional[dict] = None,
        parent: Optional[SpanContext] = None,
        activate: bool = True,
    ) -> Span:
        """Open a span. Parent resolution: explicit ``parent`` (e.g. an
        extracted traceparent) wins, else the context-active span, else a
        fresh root trace. ``activate=False`` opens a span without making it
        the context parent (for spans whose children intentionally attach
        elsewhere, like a fire-and-forget dispatch)."""
        is_root = False
        if parent is None:
            active = _current_span.get()
            if active is not None:
                parent = active.context
        if parent is None:
            trace_id = self._new_trace_id()
            parent_id = None
            is_root = True
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        span = Span(
            self,
            name,
            SpanContext(trace_id=trace_id, span_id=self._new_span_id()),
            parent_id,
            attributes,
        )
        with self._lock:
            record = self._record_for_locked(trace_id)
            if record is None:
                # New local trace — either a genuine root or the first span
                # under a remote parent (extracted traceparent): either way
                # this span is the LOCAL root whose end finishes the record.
                record = self._open_record_locked(trace_id)
                is_root = True
            if is_root and trace_id in self._open:
                record["roots"] += 1
        if is_root:
            span._is_local_root = True  # type: ignore[attr-defined]
        if activate:
            span._token = _current_span.set(span)
        return span

    def record_span(
        self,
        name: str,
        duration_s: float,
        attributes: Optional[dict] = None,
        parent: Optional[SpanContext] = None,
    ) -> Span:
        """Synthesize an already-finished span from externally-measured
        timestamps — e.g. the solver's device-side solve loop, whose wall
        time is known only at readback. Parents like start_span (explicit
        parent, else active span, else fresh root)."""
        s = self.start_span(name, attributes=attributes, parent=parent,
                            activate=False)
        s.start_wall -= duration_s  # it ENDED now; it started duration ago
        s.duration_s = max(0.0, duration_s)
        self._on_span_end(s)
        return s

    def _open_record_locked(self, trace_id: str) -> dict:
        record = {"trace_id": trace_id, "spans": [], "roots": 0}
        self._open[trace_id] = record
        while len(self._open) > self.max_traces:
            self._open.popitem(last=False)  # FIFO-evict never-finished traces
        return record

    def _record_for_locked(self, trace_id: str) -> Optional[dict]:
        record = self._open.get(trace_id)
        if record is None:
            record = self._by_id.get(trace_id)
        return record

    def enable_duration_log(self) -> None:
        """Record EVERY ended span's duration by name (bench use —
        unbounded memory, so not for long-running servers). Survives
        reset(); contents clear with it."""
        with self._lock:
            self._duration_log = {}

    def _on_span_end(self, span: Span) -> None:
        trace_id = span.context.trace_id
        with self._lock:
            if self._duration_log is not None:
                self._duration_log.setdefault(span.name, []).append(
                    span.duration_s or 0.0
                )
            record = self._record_for_locked(trace_id)
            if record is None:
                # Trace evicted before this late span finished: count, drop.
                self.dropped_spans += 1
                return
            if len(record["spans"]) < self.max_spans_per_trace:
                record["spans"].append(span)
            else:
                self.dropped_spans += 1
            if getattr(span, "_is_local_root", False) and trace_id in self._open:
                record["roots"] -= 1
                if record["roots"] <= 0:
                    self._open.pop(trace_id, None)
                    self._finish_record_locked(record)

    def _finish_record_locked(self, record: dict) -> None:
        if len(self._finished) == self._finished.maxlen:
            evicted = self._finished[0]
            self._by_id.pop(evicted["trace_id"], None)
        self._finished.append(record)
        self._by_id[record["trace_id"]] = record

    # -- read side --------------------------------------------------------

    def finished_traces(self, limit: int = 0) -> list[dict]:
        """Most-recent-last snapshot of finished traces (deep enough copies
        that callers can serialize without racing span appends)."""
        with self._lock:
            records = list(self._finished)
            if limit:
                records = records[-limit:]
            return [
                {
                    "trace_id": r["trace_id"],
                    "spans": [s.to_dict() for s in r["spans"]],
                }
                for r in records
            ]

    def span_durations_s(self, include_open: bool = True) -> dict[str, list[float]]:
        """All recorded span durations grouped by span name, in seconds —
        the bench's per-phase percentile source. With the duration log
        enabled this covers EVERY ended span of the run; otherwise it falls
        back to the bounded ring (most recent ``max_traces`` traces only).
        ``include_open`` also reads spans already finished inside
        still-open traces (ring fallback path)."""
        with self._lock:
            if self._duration_log is not None:
                return {k: list(v) for k, v in self._duration_log.items()}
            out: dict[str, list[float]] = {}
            records = list(self._finished)
            if include_open:
                records += list(self._open.values())
            for record in records:
                for s in record["spans"]:
                    out.setdefault(s.name, []).append(
                        round((s.duration_s or 0.0) * 1000.0, 4) / 1000.0
                    )
            return out

    def reset(self) -> None:
        """Test/bench helper: drop all trace state (the duration log stays
        enabled if it was, but empties)."""
        with self._lock:
            self._open.clear()
            self._finished.clear()
            self._by_id.clear()
            self.dropped_spans = 0
            if self._duration_log is not None:
                self._duration_log = {}


# Process-global tracer (one per process, like the metrics registry).
TRACER = Tracer()


def duration_log_enabled() -> bool:
    """True while the global tracer's duration log is recording (bench
    runs): a caller that synthesizes one fresh-root span per phase gates
    that on this, since an always-on feed would flood the finished-trace
    ring in a live server."""
    with TRACER._lock:
        return TRACER._duration_log is not None


def span(
    name: str,
    attributes: Optional[dict] = None,
    parent: Optional[SpanContext] = None,
    activate: bool = True,
) -> Span:
    """`with span("reconcile", {...}):` — the one-call hot-path API."""
    return TRACER.start_span(
        name, attributes=attributes, parent=parent, activate=activate
    )


def current_span() -> Optional[Span]:
    return _current_span.get()


def current_trace_id() -> Optional[str]:
    active = _current_span.get()
    return active.context.trace_id if active is not None else None


def current_traceparent() -> Optional[str]:
    """The header value to inject on outbound requests, or None when no
    span is active (callers simply omit the header)."""
    active = _current_span.get()
    return active.context.to_traceparent() if active is not None else None
