"""Metrics registry: the solver's and the device programs' families.

Counterpart of the pieces of `jobset_tpu/core/metrics.py` that the port's
hooks touch, framework-free and kept as its own copy: the metric classes
(`Counter`, `Gauge`, `CallbackGauge`, `Histogram` with exemplars and
`enable_raw`, `LabeledHistogram`), eight families under the reference's
names, help texts and labels, the text exposition and `reset`. The
controller's other families (reconcile, store, HA, shard, flow and the
rest) belong to the control plane and stay with the reference.

Histogram exemplars: each bucket remembers the most recent observation
made under an active trace, rendered in OpenMetrics exemplar syntax
(`... # {trace_id="..."} value timestamp`), so a scrape can jump from a
latency bucket to the trace that landed there.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from collections import defaultdict

from ..obs.trace import current_trace_id


class Counter:
    def __init__(self, name: str, help_text: str = "", label_names: tuple = ("jobset",)):
        self.name = name
        self.help = help_text
        self.label_names = label_names
        self._values: dict[tuple, float] = defaultdict(float)  # guarded-by: _lock
        self._lock = threading.Lock()

    def inc(self, *labels, amount: float = 1.0) -> None:
        with self._lock:
            self._values[labels] += amount

    def value(self, *labels) -> float:
        # Locked like render_prometheus: a reader may run concurrently
        # with inc() on the same dict.
        with self._lock:
            return self._values.get(labels, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())


class Gauge:
    """Point-in-time value (can go up and down) with optional labels —
    the Prometheus Gauge. Same locked-read discipline as Counter:
    set()/add() race a concurrent scrape."""

    def __init__(self, name: str, help_text: str = "", label_names: tuple = ()):
        self.name = name
        self.help = help_text
        self.label_names = label_names
        self._values: dict[tuple, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def set(self, value: float, *labels) -> None:
        with self._lock:
            self._values[labels] = float(value)

    def add(self, amount: float, *labels) -> None:
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount

    def value(self, *labels) -> float:
        with self._lock:
            return self._values.get(labels, 0.0)

    def collect(self) -> list[tuple[tuple, float]]:
        """Sorted (labels, value) snapshot — the one seam both the text
        exposition and the telemetry sampler read through, so a subclass
        that pulls its value at collect time changes every consumer at
        once."""
        with self._lock:
            return sorted(self._values.items())


class CallbackGauge(Gauge):
    """Gauge whose value is pulled from its owner at collect time (scrape
    or TSDB sample) instead of pushed at every mutation site.

    Push-site gauges go stale between pushes and force the owning
    subsystem to remember every code path that changes the value (the WAL
    gauge had four push sites; a forgotten one is a silent staleness
    window). ``bind(owner, provider)`` registers ``provider(owner)`` as
    the authoritative source; the owner is held by weakref so a dead
    subsystem silently unbinds instead of keeping itself alive through
    the process-global registry. The provider may return a scalar (for
    unlabeled gauges) or an iterable of ``(labels_tuple, value)`` pairs.
    Pushed values remain the fallback while unbound."""

    def __init__(self, name: str, help_text: str = "", label_names: tuple = ()):
        super().__init__(name, help_text, label_names)
        self._owner = None  # guarded-by: _lock (slot swap only)
        self._provider = None  # guarded-by: _lock (slot swap only)

    def bind(self, owner, provider) -> None:
        ref = weakref.ref(owner)
        with self._lock:
            self._owner = ref
            self._provider = provider

    def unbind(self, owner=None) -> None:
        """Drop the binding (only if still owned by ``owner`` when given)."""
        with self._lock:
            if owner is not None and self._owner is not None:
                if self._owner() is not owner:
                    return
            self._owner = None
            self._provider = None

    def collect(self) -> list[tuple[tuple, float]]:
        # Snapshot the binding under the lock but invoke the provider
        # OUTSIDE it: providers read live subsystem state and must not
        # couple this gauge's lock into subsystem lock orders.
        with self._lock:
            ref, provider = self._owner, self._provider
            pushed = sorted(self._values.items())
        owner = ref() if ref is not None else None
        if provider is None or owner is None:
            return pushed
        try:
            pulled = provider(owner)
        except Exception:
            # A mid-teardown owner must degrade the scrape, not 500 it.
            return pushed
        if pulled is None:
            return pushed
        if isinstance(pulled, (int, float)):
            return [((), float(pulled))]
        return sorted((tuple(labels), float(v)) for labels, v in pulled)

    def value(self, *labels) -> float:
        for got, v in self.collect():
            if got == labels:
                return v
        return 0.0


class Histogram:
    """Fixed-bucket latency histogram (seconds), exp buckets 1ms..~64s with
    half-power-of-two (~1.41x) spacing so percentile quantization error stays
    under ~41% (a full power-of-two ladder doubles at each edge, which made
    p99 comparisons between placement modes flip on sub-ms noise)."""

    def __init__(self, name: str, help_text: str = "", num_buckets: int = 33):
        self.name = name
        self.help = help_text
        self.buckets = [0.001 * (2 ** (i / 2)) for i in range(num_buckets)]
        self.counts = [0] * (num_buckets + 1)  # guarded-by: _lock
        self.sum = 0.0  # guarded-by: _lock
        self.n = 0  # guarded-by: _lock
        # Optional raw-sample recording (enable_raw): the bucket ladder's
        # ~41% quantization hides differences below it; benchmarks need
        # exact percentiles.
        self.raw: list[float] | None = None  # guarded-by: _lock
        # Per-bucket exemplars: bucket index -> (trace_id, value, unix_ts).
        # Only observations made under an active trace are recorded, so the
        # exposition can link a latency bucket to the trace that landed
        # there (OpenMetrics exemplar semantics).
        self.exemplars: dict[int, tuple[str, float, float]] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def enable_raw(self) -> None:
        """Record every sample for exact percentiles (bench use — unbounded
        memory, so not for long-running servers)."""
        with self._lock:
            self.raw = []

    def observe(self, seconds: float, trace_id: str | None = None) -> None:
        if trace_id is None:
            trace_id = current_trace_id()
        with self._lock:
            self.sum += seconds
            self.n += 1
            if self.raw is not None:
                self.raw.append(seconds)
            for i, b in enumerate(self.buckets):
                if seconds <= b:
                    self.counts[i] += 1
                    if trace_id is not None:
                        # Exemplar timestamps are wall-clock by the OpenMetrics spec.
                        self.exemplars[i] = (trace_id, seconds, time.time())
                    return
            self.counts[-1] += 1
            if trace_id is not None:
                self.exemplars[len(self.buckets)] = (
                    trace_id, seconds, time.time()
                )

    def percentile(self, q: float) -> float:
        """Approximate percentile from bucket counts (upper bucket bound),
        the way Prometheus histogram_quantile works — bounded memory.
        Snapshots under the lock: a reader may run while another thread
        is mid-observe(), and a torn (counts, n) read would walk the CDF
        against the wrong total."""
        with self._lock:
            counts = list(self.counts)
            n = self.n
        if n == 0:
            return math.nan
        target = q * n
        cumulative = 0
        for i, count in enumerate(counts):
            cumulative += count
            if cumulative >= target:
                return self.buckets[i] if i < len(self.buckets) else math.inf
        return math.inf

    def exact_percentile(self, q: float) -> float:
        """Exact nearest-rank percentile from raw samples; requires
        enable_raw() before the observations. Falls back to the bucket
        approximation when raw recording is off."""
        with self._lock:
            raw = sorted(self.raw) if self.raw else None
        if not raw:
            return self.percentile(q)
        rank = max(0, min(len(raw) - 1, math.ceil(q * len(raw)) - 1))
        return raw[rank]


class LabeledHistogram:
    """A labeled vector of :class:`Histogram` children, keyed by label
    tuple — the histogram analog of a labeled Counter/Gauge family
    (`jobset_jit_compile_seconds{kernel=...}`). Children are created on
    first observe and live for the process (label cardinality is bounded
    by construction: kernel names, never user input). The child map swap is guarded; each child then
    guards its own bucket state, so two labelsets never contend on one
    lock the way a shared-dict design would."""

    def __init__(self, name: str, help_text: str = "",
                 label_names: tuple = ("name",), num_buckets: int = 33):
        self.name = name
        self.help = help_text
        self.label_names = label_names
        self.num_buckets = num_buckets
        self._children: dict[tuple, Histogram] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def child(self, *labels) -> Histogram:
        with self._lock:
            h = self._children.get(labels)
            if h is None:
                h = self._children[labels] = Histogram(
                    self.name, self.help, num_buckets=self.num_buckets
                )
            return h

    def observe(self, seconds: float, *labels,
                trace_id: str | None = None) -> None:
        self.child(*labels).observe(seconds, trace_id=trace_id)

    def children(self) -> list[tuple[tuple, Histogram]]:
        with self._lock:
            return sorted(self._children.items())

    def count(self, *labels) -> int:
        with self._lock:
            h = self._children.get(labels)
        if h is None:
            return 0
        with h._lock:
            return h.n

    def total(self, *labels) -> float:
        with self._lock:
            h = self._children.get(labels)
        if h is None:
            return 0.0
        with h._lock:
            return h.sum

    def percentile(self, q: float, *labels) -> float:
        with self._lock:
            h = self._children.get(labels)
        return h.percentile(q) if h is not None else math.nan


# Registry (one per process). The solver's latency and batch gauges:
solver_solve_time_seconds = Histogram(
    "jobset_placement_solve_time_seconds", "Placement solver latency"
)
solver_batch_occupancy = Gauge(
    "jobset_placement_solver_batch_occupancy",
    "Real-problem fraction of the last solver dispatch's padded batch "
    "(real cells / padded cells; 1.0 = no padding waste)",
)
solver_batch_problems = Gauge(
    "jobset_placement_solver_batch_problems",
    "Problem count in the last batched solver dispatch",
)
# Compile and transfer accounting of the kernel families (obs/profile.py):
jit_compiles_total = Counter(
    "jobset_jit_compiles_total",
    "First-call JIT compilations per kernel family (solver, queue "
    "scorer, columnar aggregates, policy MLP) — each cache-miss "
    "specialization traced+lowered exactly once",
    label_names=("kernel",),
)
jit_compile_seconds = LabeledHistogram(
    "jobset_jit_compile_seconds",
    "Wall time of each kernel's first (compiling) invocation per "
    "kernel family — the trace+lower+compile cost the bucket caches "
    "amortize",
    label_names=("kernel",),
)
jit_cache_hits = CallbackGauge(
    "jobset_jit_cache_hits",
    "lru_cache hits on each compile-once kernel factory (collect-time "
    "callback into functools cache_info)",
    label_names=("kernel",),
)
jit_cache_misses = CallbackGauge(
    "jobset_jit_cache_misses",
    "lru_cache misses on each compile-once kernel factory — each miss "
    "is a new bucket specialization paying a compile",
    label_names=("kernel",),
)
jit_transfer_bytes_total = Counter(
    "jobset_jit_transfer_bytes_total",
    "Host<->device bytes moved at instrumented kernel boundaries per "
    "kernel family and direction (h2d/d2h), estimated from array "
    "shapes/dtypes at the call site",
    label_names=("kernel", "direction"),
)

# In the reference registry's order, so the exposition lists these
# families in the order the reference's does.
ALL_COUNTERS = (jit_compiles_total, jit_transfer_bytes_total)
ALL_HISTOGRAMS = (solver_solve_time_seconds,)
ALL_GAUGES = (solver_batch_occupancy, solver_batch_problems, jit_cache_hits,
              jit_cache_misses)
ALL_LABELED_HISTOGRAMS = (jit_compile_seconds,)


def _render_exemplar(exemplar: tuple[str, float, float] | None) -> str:
    """OpenMetrics exemplar suffix: ` # {trace_id="..."} value timestamp`
    (openmetrics spec §exemplars); empty when the bucket has none."""
    if exemplar is None:
        return ""
    trace_id, value, ts = exemplar
    return f' # {{trace_id="{trace_id}"}} {value:.6g} {ts:.3f}'


def render_prometheus(openmetrics: bool = False) -> str:
    """Text exposition of the whole registry, line for line as the
    reference renders these families. Snapshots are taken under each
    metric's lock: a scrape may run while solves observe.

    ``openmetrics=False`` (default) renders the classic Prometheus text
    format — NO exemplars, because the legacy parser errors on the ``#``
    token where it expects an optional timestamp. ``openmetrics=True``
    (for a scraper whose Accept header negotiates
    ``application/openmetrics-text``) adds per-bucket exemplars and the
    ``# EOF`` terminator the OpenMetrics spec requires."""
    lines: list[str] = []
    for c in ALL_COUNTERS:
        # OpenMetrics: a counter's MetricFamily name must NOT end in
        # _total (the suffix belongs to the sample), so the HELP/TYPE
        # lines drop it there; sample lines keep the full _total name in
        # both formats. Classic text keeps the full name everywhere.
        family = (
            c.name[: -len("_total")]
            if openmetrics and c.name.endswith("_total")
            else c.name
        )
        lines.append(f"# HELP {family} {c.help}")
        lines.append(f"# TYPE {family} counter")
        with c._lock:
            values = sorted(c._values.items())
        if not values:
            lines.append(f"{c.name} 0")
        for labels, value in values:
            pairs = ",".join(
                f'{n}="{v}"' for n, v in zip(c.label_names, labels)
            )
            suffix = f"{{{pairs}}}" if pairs else ""
            lines.append(f"{c.name}{suffix} {value}")
    for g in ALL_GAUGES:
        lines.append(f"# HELP {g.name} {g.help}")
        lines.append(f"# TYPE {g.name} gauge")
        values = g.collect()
        if not values:
            lines.append(f"{g.name} 0")
        for labels, value in values:
            pairs = ",".join(
                f'{n}="{v}"' for n, v in zip(g.label_names, labels)
            )
            suffix = f"{{{pairs}}}" if pairs else ""
            lines.append(f"{g.name}{suffix} {value}")
    for h in ALL_HISTOGRAMS:
        lines.append(f"# HELP {h.name} {h.help}")
        lines.append(f"# TYPE {h.name} histogram")
        with h._lock:
            counts, total, n = list(h.counts), h.sum, h.n
            exemplars = dict(h.exemplars)
        cumulative = 0
        for i, (bound, count) in enumerate(zip(h.buckets, counts)):
            cumulative += count
            lines.append(
                f'{h.name}_bucket{{le="{bound:g}"}} {cumulative}'
                + (_render_exemplar(exemplars.get(i)) if openmetrics else "")
            )
        cumulative += counts[-1]
        lines.append(
            f'{h.name}_bucket{{le="+Inf"}} {cumulative}'
            + (_render_exemplar(exemplars.get(len(h.buckets)))
               if openmetrics else "")
        )
        lines.append(f"{h.name}_sum {total}")
        lines.append(f"{h.name}_count {n}")
    for lh in ALL_LABELED_HISTOGRAMS:
        lines.append(f"# HELP {lh.name} {lh.help}")
        lines.append(f"# TYPE {lh.name} histogram")
        for labels, h in lh.children():
            pairs = ",".join(
                f'{n_}="{v}"' for n_, v in zip(lh.label_names, labels)
            )
            with h._lock:
                counts, total, n = list(h.counts), h.sum, h.n
            cumulative = 0
            for bound, count in zip(h.buckets, counts):
                cumulative += count
                lines.append(
                    f'{lh.name}_bucket{{{pairs},le="{bound:g}"}} '
                    f"{cumulative}"
                )
            cumulative += counts[-1]
            lines.append(
                f'{lh.name}_bucket{{{pairs},le="+Inf"}} {cumulative}'
            )
            lines.append(f"{lh.name}_sum{{{pairs}}} {total}")
            lines.append(f"{lh.name}_count{{{pairs}}} {n}")
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


def reset() -> None:
    """Test helper: clear all metric state. Takes each metric's lock —
    suites reset between cases while a previous case's threads may
    still be draining an inc()/observe()."""
    for counter in ALL_COUNTERS:
        with counter._lock:
            counter._values.clear()
    for gauge in ALL_GAUGES:
        with gauge._lock:
            gauge._values.clear()
            if isinstance(gauge, CallbackGauge):
                # Drop bindings too: a provider left behind by a previous
                # case's (dead but uncollected) subsystem would leak its
                # values into the next case's scrape. The kernel-cache
                # registry re-binds on its next registration.
                gauge._owner = None
                gauge._provider = None
    for hist in ALL_HISTOGRAMS:
        with hist._lock:
            hist.counts = [0] * len(hist.counts)
            hist.sum = 0.0
            hist.n = 0
            hist.exemplars.clear()
            if hist.raw is not None:
                hist.raw = []
    for lh in ALL_LABELED_HISTOGRAMS:
        with lh._lock:
            # Drop children outright (not just zero them): label sets
            # are per-case state (lock names, kernel shapes) and a
            # leftover child would surface phantom series next case.
            lh._children.clear()
