"""The port's span tracer (`jobset_tpu_torch/obs/trace.py`) against the JAX
package's (`jobset_tpu/obs/trace.py`), on the CPU.

Both are framework-free; the port keeps its own copy. The same traceparent
headers give the same parse; the same call sequences, run under
`random.seed(k)` (both draw ids from the process-global stream), give the
same finished-trace records, ids included, apart from the timings
(`start_unix_s`, `duration_ms`). The ring's eviction at `max_traces`, the
open-trace cap, the per-trace span cap and the duration log agree too.
Tolerance: none, every compared field is exact.
"""

import random

import pytest

from jobset_tpu.obs import trace as jtrace
from jobset_tpu_torch.obs import trace as ttrace

MODULES = (jtrace, ttrace)
TIMINGS = ("start_unix_s", "duration_ms")

HEADERS = [
    None,
    "",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",   # upper-case hex
    "  00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-00\n",  # padded, unsampled
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",   # all-zero trace id
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",   # all-zero span id
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01-ff",  # extra field
    "01-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",   # unknown version
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",    # short trace id
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b-01",    # short span id
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-1",    # one-digit flags
    "00-4bf92f3577b34da6a3ce929d0e0e473g-00f067aa0ba902b7-01",   # non-hex trace id
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-zz",   # non-hex flags
    "00-4bf92f3577b34da6a3ce929d0e0e4736",                       # too few fields
    "garbage",
]


def _ctx(ctx):
    return None if ctx is None else (ctx.trace_id, ctx.span_id, ctx.to_traceparent())


@pytest.mark.parametrize("header", HEADERS, ids=lambda h: repr(h)[:40])
def test_extract_traceparent_matches(header):
    got, want = (_ctx(m.extract_traceparent(header)) for m in (ttrace, jtrace))
    assert got == want


def _strip(records):
    return [{"trace_id": r["trace_id"],
             "spans": [{k: v for k, v in s.items() if k not in TIMINGS} for s in r["spans"]]}
            for r in records]


def _sequence(m, tracer, remote_header):
    """Nested spans, a non-activating span, spans timed after the fact, a
    remote parent, an error, a late span after its root ended and a double
    end, through `tracer`; returns what the module-level readers saw."""
    seen = []
    with tracer.start_span("reconcile", {"jobset": "ns/a"}) as root:
        seen.append(m.current_span() is root)
        with tracer.start_span("solver.solve", {"kind": "dense", "jobs": 4}) as solve:
            seen.append(m.current_trace_id() == solve.context.trace_id)
            seen.append(m.current_traceparent() == solve.context.to_traceparent())
            quiet = tracer.start_span("dispatch", {"compile_cache": "miss"}, activate=False)
            with tracer.start_span("child"):  # parents onto solve, not quiet
                pass
            quiet.end()
            quiet.end()  # idempotent
            tracer.record_span("solver.solve_loop", 0.25, {"iterations": 7})
        tracer.record_span("solver.readback", 0.001, {"jobs": 4}, parent=solve.context)
        try:
            with tracer.start_span("failing", {"n": 1}):
                raise ValueError("x" * 300)
        except ValueError:
            pass
    seen.append(m.current_span() is None)
    # A late span for a finished trace lands in its record.
    tracer.record_span("late", 0.5, parent=root.context)
    remote = m.extract_traceparent(remote_header)
    with tracer.start_span("server.handle", {"path": "/solve"}, parent=remote):
        tracer.record_span("inner", 0.01)
    # A root timed after the fact finishes its own trace at once.
    tracer.record_span("standalone", 0.125, {"k": "v"})
    return seen


@pytest.mark.parametrize("seed", range(4))
def test_span_sequences_give_equal_records(seed):
    header = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
    out = []
    for m in MODULES:
        random.seed(seed)
        tracer = m.Tracer()
        seen = _sequence(m, tracer, header)
        out.append((seen, _strip(tracer.finished_traces()), tracer.dropped_spans,
                    sorted((k, len(v)) for k, v in tracer.span_durations_s().items())))
    (jseen, jrec, jdrop, jdur), (tseen, trec, tdrop, tdur) = out
    assert tseen == jseen and all(tseen)
    assert trec == jrec and tdrop == jdrop and tdur == jdur
    # The sequence left what it should: three traces, the error recorded.
    assert len(trec) == 3
    failing = next(s for s in trec[0]["spans"] if s["name"] == "failing")
    assert failing["status"] == "error" and len(failing["attributes"]["error"]) == 200
    handle = next(s for s in trec[1]["spans"] if s["name"] == "server.handle")
    assert handle["parent_span_id"] == "00f067aa0ba902b7"


@pytest.mark.parametrize("seed", range(2))
def test_global_tracer_and_span_helper_agree(seed):
    out = []
    for m in MODULES:
        m.TRACER.reset()
        random.seed(seed)
        with m.span("outer", {"a": 1}):
            with m.span("inner", activate=False):
                pass
            m.TRACER.record_span("synthesized", 0.002)
        out.append(_strip(m.TRACER.finished_traces(limit=1)))
        m.TRACER.reset()
    assert out[0] == out[1]


@pytest.mark.parametrize("max_traces", [1, 3])
def test_ring_eviction_and_open_cap_agree(max_traces):
    out = []
    for m in MODULES:
        random.seed(11)
        tracer = m.Tracer(max_traces=max_traces, max_spans_per_trace=2)
        roots = []
        for i in range(5):
            with tracer.start_span(f"root{i}") as r:
                for j in range(3):  # the third span overflows the per-trace cap
                    tracer.record_span(f"leaf{j}", 0.001)
            roots.append(r)
        tracer.record_span("late-evicted", 0.001, parent=roots[0].context)
        tracer.record_span("late-kept", 0.001, parent=roots[-1].context)
        # Open traces that never finish are capped too, FIFO.
        opened = [tracer.start_span(f"open{i}", activate=False) for i in range(max_traces + 2)]
        for s in opened:
            s.end()
        out.append((_strip(tracer.finished_traces()), _strip(tracer.finished_traces(limit=1)),
                    tracer.dropped_spans,
                    sorted((k, len(v)) for k, v in tracer.span_durations_s().items()),
                    sorted((k, len(v)) for k, v in
                           tracer.span_durations_s(include_open=False).items())))
    assert out[0] == out[1]
    assert len(out[1][0]) == max_traces


def test_duration_log_agrees():
    out = []
    for m in MODULES:
        random.seed(3)
        tracer = m.Tracer(max_traces=2)
        tracer.enable_duration_log()
        for i in range(6):  # more roots than the ring holds: the log keeps all
            with tracer.start_span("phase"):
                tracer.record_span("solver.readback", 0.5 * i)
        logged = tracer.span_durations_s()
        tracer.reset()
        after_reset = tracer.span_durations_s()
        tracer.record_span("after", 1.0)
        out.append((len(logged["phase"]), logged["solver.readback"], after_reset,
                    tracer.span_durations_s()))
    assert out[0] == out[1]
    assert out[1][0] == 6 and out[1][1] == [0.5 * i for i in range(6)]
    assert out[1][2] == {} and out[1][3] == {"after": [1.0]}


def test_duration_log_enabled_follows_the_global_tracer(monkeypatch):
    for m in MODULES:
        monkeypatch.setattr(m.TRACER, "_duration_log", None)
        assert not m.duration_log_enabled()
        m.TRACER.enable_duration_log()
        assert m.duration_log_enabled()
        m.TRACER.reset()
        assert m.duration_log_enabled()  # reset empties, keeps it on


def test_port_tracer_is_its_own():
    """Each package keeps its own active-span state and global tracer."""
    assert ttrace.TRACER is not jtrace.TRACER
    with ttrace.span("port-only"):
        assert jtrace.current_span() is None and ttrace.current_span() is not None
    ttrace.TRACER.reset()
