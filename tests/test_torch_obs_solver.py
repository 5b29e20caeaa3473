"""The port solver's observability hooks against the JAX package's, on the
CPU.

The same small problems go through both `AssignmentSolver`s (backend
"cpu", so both run the host portfolio's capped auction): a dense 8x12
solve, a dense solve dispatched and fetched under callers' spans, a
structured 16x24 solve, a 3-problem structured storm twice (the second
round finds every operand resident), a dense batch and the Hungarian
route (the auction's budget cut to 1 round). Each path runs twice, so the
second dispatch is a compile-cache hit. Compared exactly:
- every finished trace's spans: names, parent names and every attribute
  (sizes, `kind`, `compile_cache`, `iterations`, `resident_hits`, ...);
  the durations are not compared;
- the solve-time histogram's count, the two batch gauges, and per kernel
  `jobset_jit_compiles_total` and the count of `jobset_jit_compile_seconds`;
- transfer bytes per kernel and direction: equal on the structured single
  path; on the dense paths each side's own copies (the reference copies
  the padded f32 benefit, 4 bytes a padded cell; the port copies the f32
  costs and the bool mask, 5 bytes a real cell, and builds the benefit on
  the device); on the storm the port's own copies, the operands that
  missed the residency cache (the reference counts none there).
Fixtures reset both registries and both tracers and give the reference
fresh `_COMPILED_KEYS` and both packages fresh `_SEEN_SHAPES` for each
test (the port's dispatch spans read their hit or miss from
`jit_shape_call`).
"""

import random

import numpy as np
import pytest
import torch

from jobset_tpu.core import metrics as jmetrics
from jobset_tpu.obs import profile as jprofile
from jobset_tpu.obs import trace as jtrace
from jobset_tpu.placement import solver as jsolver
from jobset_tpu_torch.core import metrics as tmetrics
from jobset_tpu_torch.obs import profile as tprofile
from jobset_tpu_torch.obs import trace as ttrace
from jobset_tpu_torch.placement import solver as tsolver

REF = (jsolver, jmetrics, jtrace, jprofile)
PORT = (tsolver, tmetrics, ttrace, tprofile)
KERNELS = ("solver_auction", "solver_auction_structured", "solver_auction_structured_batch",
           "solver_auction_batch")


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(jsolver, "_COMPILED_KEYS", set())
    for solver, metrics, trace, profile in (REF, PORT):
        monkeypatch.setattr(profile, "_SEEN_SHAPES", {})
        metrics.reset()
        trace.TRACER.reset()
    yield
    for _, metrics, trace, profile in (REF, PORT):
        metrics.reset()
        trace.TRACER.reset()
        metrics.jit_cache_hits.bind(profile.KERNEL_CACHES, profile.KernelCacheRegistry._hits)
        metrics.jit_cache_misses.bind(profile.KERNEL_CACHES,
                                      profile.KernelCacheRegistry._misses)
    torch.set_num_threads(prev)


def _dense(seed, jobs=8, domains=12):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 64, size=(jobs, domains)).astype(np.float32)
    feasible = rng.random((jobs, domains)) > 0.2
    return cost, feasible


def _structured(seed, jobs=16, domains=24):
    rng = np.random.default_rng(seed)
    own = np.full(jobs, -1, np.int32)
    occupied = rng.random(domains) < 0.15
    owned = np.flatnonzero(occupied)[: jobs // 4]
    own[: len(owned)] = owned
    return dict(
        load=rng.random(domains).astype(np.float32),
        free=rng.integers(0, 24, domains).astype(np.float32),
        pods_needed=rng.integers(1, 12, jobs).astype(np.float32),
        sticky=np.where(rng.random(jobs) < 0.3, rng.integers(0, domains, jobs),
                        -1).astype(np.int32),
        occupied=occupied,
        own_domain=own,
    )


STORM = [_structured(20), _structured(21, jobs=10, domains=30), _structured(22, jobs=5, domains=9)]


def _path_dense(S, trace):
    cost, feasible = _dense(1)
    return [S.solve(cost, feasible) for _ in range(2)]


def _path_dense_caller_spans(S, trace):
    """Dispatched under one caller span and fetched under another (the
    phase spans join the fetching caller's trace), then a late fetch
    outside any span (they join the dispatch's trace)."""
    cost, feasible = _dense(2)
    with trace.span("reconcile", {"pass": 1}):
        pending = S.solve_async(cost, feasible)
    with trace.span("fetch"):
        first = pending.result()
    late = S.solve_async(cost, feasible)
    return [first, late.result(), late.result()]  # the second fetch records nothing


def _path_structured(S, trace):
    return [S.solve_structured_async(**_structured(3)).result() for _ in range(2)]


def _path_storm(S, trace):
    return [p.result() for _ in range(2) for p in S.solve_structured_batch_async(STORM)]


def _path_dense_batch(S, trace):
    costs, feasibles = zip(*(_dense(10 + b) for b in range(3)))
    return [S.solve_batch(np.stack(costs), np.stack(feasibles)) for _ in range(2)]


def _path_hungarian(S, trace):
    S._HOST_AUCTION_ITER_CAP = 1
    cost, feasible = _dense(4, jobs=32, domains=50)
    return [S.solve(cost, feasible) for _ in range(2)]


def _path_hungarian_structured(S, trace):
    S._HOST_AUCTION_ITER_CAP = 1
    out = []
    for _ in range(2):
        pending = S.solve_structured_async(**_structured(5))
        assert pending.iterations == 0  # a HostSolve
        out.append(pending.result())
    return out


PATHS = {"dense": _path_dense, "dense_caller_spans": _path_dense_caller_spans,
         "structured": _path_structured, "structured_batch": _path_storm,
         "dense_batch": _path_dense_batch, "hungarian": _path_hungarian,
         "hungarian_structured": _path_hungarian_structured}


def _tree(records):
    """Each trace as (name, parent name, attributes) per span, in the order
    the spans ended; a parent outside the trace reads "<remote>"."""
    out = []
    for record in records:
        names = {s["span_id"]: s["name"] for s in record["spans"]}
        out.append([(s["name"],
                     None if s["parent_span_id"] is None
                     else names.get(s["parent_span_id"], "<remote>"),
                     s["attributes"]) for s in record["spans"]])
    return out


def _run(package, path):
    solver_mod, metrics, trace, _ = package
    random.seed(0)
    results = PATHS[path](solver_mod.AssignmentSolver(backend="cpu"), trace)
    return {
        "results": [np.asarray(r) for r in results],
        "traces": _tree(trace.TRACER.finished_traces()),
        "solves": metrics.solver_solve_time_seconds.n,
        "gauges": (metrics.solver_batch_occupancy.value(),
                   metrics.solver_batch_problems.value()),
        "compiles": {k: (metrics.jit_compiles_total.value(k),
                         metrics.jit_compile_seconds.count(k)) for k in KERNELS},
        "bytes": {(k, d): metrics.jit_transfer_bytes_total.value(k, d)
                  for k in KERNELS for d in ("h2d", "d2h")},
    }


# Solves the histogram observes per path (one per fetched single solve,
# one per storm round, one per dense batch call) and the kernel it runs.
EXPECTED = {"dense": (2, "solver_auction"), "dense_caller_spans": (2, "solver_auction"),
            "structured": (2, "solver_auction_structured"),
            "structured_batch": (2, "solver_auction_structured_batch"),
            "dense_batch": (2, "solver_auction_batch"), "hungarian": (2, "solver_auction"),
            "hungarian_structured": (2, "solver_auction_structured")}


def _storm_bytes():
    """The port's h2d bytes over the storm's two rounds: every stacked
    operand once, in the first round; the second finds them resident."""
    jobs_p = tsolver._round_up_pow2(max(p["pods_needed"].shape[0] for p in STORM))
    domains_p = tsolver._round_up_pow2(max(p["load"].shape[0] for p in STORM))
    return sum(a.nbytes for a in tsolver._stack_structured(STORM, jobs_p, domains_p).values())


def _dense_bytes(path):
    """(reference, port) h2d bytes a dispatch of `path`'s dense kernel."""
    if path == "dense_batch":
        batch, (jobs, domains) = 3, _dense(0)[0].shape
    else:
        batch, (jobs, domains) = 1, (_dense(4, 32, 50) if path == "hungarian"
                                     else _dense(0))[0].shape
    padded = tsolver._round_up_pow2(jobs) * tsolver._round_up_pow2(domains)
    return batch * padded * 4, batch * jobs * domains * 5


@pytest.mark.parametrize("path", list(PATHS))
def test_solver_hooks_match_the_reference(path):
    ref, port = _run(REF, path), _run(PORT, path)
    for a, b in zip(ref["results"], port["results"]):
        np.testing.assert_array_equal(a, b)
    assert port["traces"] == ref["traces"]
    solves, kernel = EXPECTED[path]
    assert port["solves"] == ref["solves"] == solves
    assert port["gauges"] == ref["gauges"]
    assert port["compiles"] == ref["compiles"]
    assert port["compiles"][kernel] == (1.0, 1)
    dispatches = [s[2]["compile_cache"] for t in port["traces"] for s in t
                  if s[0] == "solver.dispatch"]
    assert dispatches == ["miss"] + ["hit"] * (len(dispatches) - 1)
    for (k, d), value in port["bytes"].items():
        if k == kernel and d == "h2d" and kernel in ("solver_auction", "solver_auction_batch"):
            want_ref, want_port = _dense_bytes(path)
            assert (ref["bytes"][k, d], value) == (2 * want_ref, 2 * want_port)
        elif k == kernel == "solver_auction_structured_batch" and d == "h2d":
            assert (ref["bytes"][k, d], value) == (0, _storm_bytes())
        else:
            assert value == ref["bytes"][k, d]
    if kernel == "solver_auction_structured":
        assert port["bytes"][kernel, "h2d"] > 0


def test_storm_second_round_is_resident():
    port = _run(PORT, "structured_batch")
    transfers = [s[2] for t in port["traces"] for s in t if s[0] == "solver.host_transfer"]
    assert [t["resident_hits"] for t in transfers] == [0, 7]


def test_span_names_are_the_reference_set():
    names = {s[0] for path in PATHS for t in _run(PORT, path)["traces"] for s in t}
    assert names == {"solver.solve", "solver.host_transfer", "solver.dispatch",
                     "solver.solve_loop", "solver.readback", "solver.hungarian_fallback",
                     "reconcile", "fetch"}


class _Arg:
    """A stand-in tensor: what `jit_shape_call` reads of an argument."""

    def __init__(self, shape, device, dtype="float32"):
        self.shape, self.device, self.dtype = shape, device, dtype


def test_jit_shape_call_reports_the_first_call_per_signature_and_device():
    """The port's dispatch spans read hit or miss from `jit_shape_call`; a
    first call on another device is a first call (a compile) of its own."""
    calls = []

    def fn(*args, **kwargs):
        calls.append((args, kwargs))
        return "out"

    seen = [tprofile.jit_shape_call("solver_auction", fn, _Arg((1, 8, 16), device), 1.0,
                                    max_iters=9, batched=False)
            for device in ("cpu", "cpu", "cuda:0", "cuda:0")]
    seen.append(tprofile.jit_shape_call("solver_auction", fn, _Arg((1, 8, 32), "cpu"), 1.0,
                                        max_iters=9, batched=False))
    assert seen == [("out", True), ("out", False), ("out", True), ("out", False),
                    ("out", True)]
    assert len(calls) == 5
    assert tmetrics.jit_compiles_total.value("solver_auction") == 3.0
    assert tmetrics.jit_compile_seconds.count("solver_auction") == 3
