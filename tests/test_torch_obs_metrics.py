"""The port's metrics registry (`jobset_tpu_torch/core/metrics.py`) against
the JAX package's (`jobset_tpu/core/metrics.py`), on the CPU.

The port keeps its own copy of the metric classes and of the eight
families its hooks feed. The same observations into both give the same
values, percentiles, exemplar trace ids and the same text exposition for
those families, classic and OpenMetrics: the reference's whole rendering,
cut to the eight families, equals the port's line for line, once the
exemplars' wall-clock timestamps are stripped. Tolerance: none.
"""

import random
import re

import numpy as np
import pytest

from jobset_tpu.core import metrics as jmetrics
from jobset_tpu.obs import profile as jprofile
from jobset_tpu.obs import trace as jtrace
from jobset_tpu_torch.core import metrics as tmetrics
from jobset_tpu_torch.obs import profile as tprofile
from jobset_tpu_torch.obs import trace as ttrace

PACKAGES = ((jmetrics, jtrace, jprofile), (tmetrics, ttrace, tprofile))
FAMILIES = ("solver_solve_time_seconds", "solver_batch_occupancy", "solver_batch_problems",
            "jit_compiles_total", "jit_compile_seconds", "jit_cache_hits", "jit_cache_misses",
            "jit_transfer_bytes_total")
KERNELS = ("solver_auction", "solver_auction_structured", "queue_scorer", "policy_mlp")
_STAMP = re.compile(r"( # \{trace_id=\"[0-9a-f]{32}\"\} \S+) \d+\.\d{3}$")


def _rebind(metrics, profile):
    metrics.jit_cache_hits.bind(profile.KERNEL_CACHES, profile.KernelCacheRegistry._hits)
    metrics.jit_cache_misses.bind(profile.KERNEL_CACHES, profile.KernelCacheRegistry._misses)


@pytest.fixture(autouse=True)
def _fresh_registries():
    for metrics, trace, _ in PACKAGES:
        metrics.reset()  # also unbinds the cache gauges
        trace.TRACER.reset()
    yield
    for metrics, trace, profile in PACKAGES:
        metrics.reset()
        trace.TRACER.reset()
        _rebind(metrics, profile)


def test_port_registers_the_reference_families():
    for name in FAMILIES:
        want, got = getattr(jmetrics, name), getattr(tmetrics, name)
        assert type(got).__name__ == type(want).__name__
        assert (got.name, got.help) == (want.name, want.help)
        assert getattr(got, "label_names", None) == getattr(want, "label_names", None)
    assert len(tmetrics.ALL_COUNTERS + tmetrics.ALL_GAUGES + tmetrics.ALL_HISTOGRAMS
               + tmetrics.ALL_LABELED_HISTOGRAMS) == len(FAMILIES)


def _observe(metrics, trace, seed):
    """One seeded sequence of observations into the eight families: solve
    times in and out of a trace (exemplars) and past the last bucket,
    gauges set and added, counters by label, compile seconds by kernel."""
    rng = np.random.default_rng(seed)
    random.seed(seed)
    metrics.solver_solve_time_seconds.enable_raw()
    for i, seconds in enumerate(np.exp(rng.normal(-6.0, 2.5, 40)).tolist() + [1e3]):
        if i % 3 == 0:
            with trace.span("solver.solve", {"i": i}):
                metrics.solver_solve_time_seconds.observe(seconds)
        else:
            metrics.solver_solve_time_seconds.observe(seconds)
    metrics.solver_batch_occupancy.set(float(rng.random()))
    metrics.solver_batch_problems.set(int(rng.integers(1, 9)))
    metrics.solver_batch_problems.add(2.0)
    for kernel in KERNELS:
        for _ in range(int(rng.integers(1, 4))):
            metrics.jit_compiles_total.inc(kernel)
            metrics.jit_compile_seconds.observe(float(rng.random()) * 3.0, kernel)
        for direction in ("h2d", "d2h"):
            metrics.jit_transfer_bytes_total.inc(kernel, direction,
                                                 amount=float(rng.integers(0, 1 << 24)))
    metrics.jit_cache_hits.set(5.0, "queue_scorer")
    metrics.jit_cache_misses.set(2.0, "queue_scorer")


def _family_lines(text, metrics):
    """The lines of an exposition that belong to the eight families, in
    order, exemplar timestamps stripped."""
    names = set()
    for name in FAMILIES:
        family = getattr(metrics, name).name
        names |= {family, family.removesuffix("_total"), f"{family}_bucket", f"{family}_sum",
                  f"{family}_count"}
    out = []
    for line in text.splitlines():
        token = line.split()[2] if line.startswith("# HELP") or line.startswith("# TYPE") \
            else re.split(r"[{ ]", line, maxsplit=1)[0]
        if token in names or line == "# EOF":
            out.append(_STAMP.sub(r"\1", line))
    return out


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_same_observations_render_the_same(seed, openmetrics):
    for metrics, trace, _ in PACKAGES:
        _observe(metrics, trace, seed)
    want = _family_lines(jmetrics.render_prometheus(openmetrics=openmetrics), jmetrics)
    got_text = tmetrics.render_prometheus(openmetrics=openmetrics)
    got = [_STAMP.sub(r"\1", line) for line in got_text.splitlines()]
    assert got == want
    assert _family_lines(got_text, tmetrics) == got  # the port renders nothing else
    assert any(" # {trace_id=" in line for line in got) == openmetrics


@pytest.mark.parametrize("seed", range(3))
def test_same_observations_read_the_same(seed):
    reads = []
    for metrics, trace, _ in PACKAGES:
        _observe(metrics, trace, seed)
        h = metrics.solver_solve_time_seconds
        lh = metrics.jit_compile_seconds
        reads.append((
            h.n, h.sum, list(h.counts), list(h.raw),
            sorted((i, e[0], e[1]) for i, e in h.exemplars.items()),
            [h.percentile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            [h.exact_percentile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            [(k, lh.count(k), lh.total(k), lh.percentile(0.5, k)) for k in KERNELS + ("none",)],
            metrics.solver_batch_occupancy.value(), metrics.solver_batch_problems.value(),
            [metrics.jit_compiles_total.value(k) for k in KERNELS],
            metrics.jit_compiles_total.total(), metrics.jit_transfer_bytes_total.total(),
            metrics.jit_cache_hits.value("queue_scorer"), metrics.jit_cache_misses.collect(),
        ))
    assert reads[0][1:] == pytest.approx(reads[1][1:]) and reads[0] == reads[1]


def test_empty_registry_renders_the_same():
    for openmetrics in (False, True):
        want = _family_lines(jmetrics.render_prometheus(openmetrics), jmetrics)
        assert tmetrics.render_prometheus(openmetrics).splitlines() == want


class _Owner:
    def __init__(self, values):
        self.values = values

    def provide(self):
        if self.values == "raise":
            raise RuntimeError("mid-teardown")
        return self.values


@pytest.mark.parametrize("values", [[(("b",), 2.0), (("a",), 1.0)], 7, None, "raise"])
def test_callback_gauge_pull_and_fallback_agree(values):
    reads = []
    for metrics, _, _ in PACKAGES:
        gauge = metrics.CallbackGauge("g", "help", label_names=("kernel",))
        gauge.set(3.0, "pushed")
        before = gauge.collect()
        owner = _Owner(values)
        gauge.bind(owner, _Owner.provide)
        bound = (gauge.collect(), gauge.value("a"), gauge.value())
        gauge.unbind(object())  # another owner: no effect
        still = gauge.collect()
        gauge.unbind(owner)
        reads.append((before, bound, still, gauge.collect()))
    assert reads[0] == reads[1]


def test_callback_gauge_unbinds_a_dead_owner():
    for metrics, _, _ in PACKAGES:
        gauge = metrics.CallbackGauge("g", label_names=("kernel",))
        owner = _Owner([(("x",), 1.0)])
        gauge.bind(owner, _Owner.provide)
        assert gauge.collect() == [(("x",), 1.0)]
        del owner
        assert gauge.collect() == []


def test_kernel_cache_gauges_read_the_registry():
    """A registered factory's cache_info() is what the gauges render."""
    import functools

    reads = []
    for metrics, _, profile in PACKAGES:
        @functools.lru_cache(maxsize=4)
        def factory(n):
            return n

        for n in (1, 1, 2, 1):
            factory(n)
        registry = profile.KernelCacheRegistry()
        registry.register("test_factory", factory)
        reads.append((metrics.jit_cache_hits.collect(), metrics.jit_cache_misses.collect(),
                      registry.snapshot()))
    assert reads[0] == reads[1]
    assert reads[1][0] == [(("test_factory",), 2.0)]
    assert reads[1][1] == [(("test_factory",), 2.0)]
