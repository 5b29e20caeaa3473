"""The control plane's device programs' compile, cache and transfer
accounting in the port, against the JAX package's, on the CPU.

The same call sequences go through both packages' admission scorer,
gang-readiness aggregate and policy MLP. Each sequence repeats a bucket,
so the compile-once factories see misses and hits. Compared exactly:
`jobset_jit_compiles_total`, the count of `jobset_jit_compile_seconds`,
and the factories' cache hits and misses (`KERNEL_CACHES.snapshot()` and
the `jobset_jit_cache_*` gauges), per kernel family. Transfer bytes:
- the aggregate copies what the reference copies (three pod columns in,
  three int32 count vectors out): equal;
- the scorer copies the padded arrays with cohort and queue indexes as
  int64 and a [C, M] cohort member table, and reads back one f32 vector
  of 2P + Q: its own nbytes, computed here from `_pad` (the reference
  copies int32 indexes and reads back bool feasibility);
- the policy MLP copies its packed weights and padded rows and reads back
  the scores: its own nbytes (the reference's jit path counts none).
Fixtures reset both registries and tracers and clear both packages'
factory caches and high-water marks for each test.
"""

import numpy as np
import pytest
import torch

import test_columnar
from jobset_tpu.core import columnar as jcolumnar
from jobset_tpu.core import metrics as jmetrics
from jobset_tpu.obs import profile as jprofile
from jobset_tpu.obs import trace as jtrace
from jobset_tpu.policy import model as jmodel
from jobset_tpu.queue import scorer as jscorer
from jobset_tpu_torch.core import columnar as tcolumnar
from jobset_tpu_torch.core import metrics as tmetrics
from jobset_tpu_torch.obs import profile as tprofile
from jobset_tpu_torch.obs import trace as ttrace
from jobset_tpu_torch.policy import model as tmodel
from jobset_tpu_torch.queue import scorer as tscorer

FACTORIES = {"queue_scorer": (jscorer._kernel, tscorer._kernel),
             "columnar_agg": (jcolumnar._agg_kernel, tcolumnar._agg_kernel),
             "policy_mlp": (jmodel._kernel, tmodel._kernel)}
PACKAGES = ((jmetrics, jtrace, jprofile, 0), (tmetrics, ttrace, tprofile, 1))


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(jscorer, "_P_HIGH_WATER", {})
    monkeypatch.setattr(tscorer, "_P_HIGH_WATER", {})
    for metrics, trace, profile, side in PACKAGES:
        metrics.reset()
        trace.TRACER.reset()
        for kernel, pair in FACTORIES.items():
            pair[side].cache_clear()
            profile.KERNEL_CACHES.register(kernel, pair[side])  # rebinds the gauges
    yield
    for metrics, trace, profile, side in PACKAGES:
        metrics.reset()
        trace.TRACER.reset()
        for kernel, pair in FACTORIES.items():
            pair[side].cache_clear()
            profile.KERNEL_CACHES.register(kernel, pair[side])
    torch.set_num_threads(prev)


def _accounting(kernel):
    """Per package: compiles, compile-seconds count, cache (hits, misses)
    from the registry and from the gauges, bytes (h2d, d2h)."""
    out = []
    for metrics, _, profile, _ in PACKAGES:
        snap = profile.KERNEL_CACHES.snapshot()[kernel]
        out.append({
            "compiles": metrics.jit_compiles_total.value(kernel),
            "compile_seconds": metrics.jit_compile_seconds.count(kernel),
            "cache": (snap["hits"], snap["misses"]),
            "gauges": (metrics.jit_cache_hits.value(kernel),
                       metrics.jit_cache_misses.value(kernel)),
            "bytes": (metrics.jit_transfer_bytes_total.value(kernel, "h2d"),
                      metrics.jit_transfer_bytes_total.value(kernel, "d2h")),
        })
    return out


def _snapshot(seed, queues, resources, cohorts, candidates):
    rng = np.random.default_rng(seed)
    arrays = dict(
        resources=[f"r{i}" for i in range(resources)],
        queue_names=[f"q{i:03d}" for i in range(queues)],
        nominal=(rng.integers(0, 64, (queues, resources)) * 0.5).astype(np.float32),
        declared=rng.random((queues, resources)) > 0.1,
        usage=(rng.integers(0, 32, (queues, resources)) * 0.5).astype(np.float32),
        weight=rng.integers(1, 4, queues).astype(np.float32),
        cohort=rng.integers(-1, cohorts, queues).astype(np.int32),
        num_cohorts=cohorts,
        request=(rng.integers(0, 16, (candidates, resources)) * 0.5).astype(np.float32),
        queue_index=rng.integers(0, queues, candidates).astype(np.int32),
    )
    return jscorer.Snapshot(**arrays), tscorer.Snapshot(**arrays)


# (seed, Q, R, C, P): a bucket, the same bucket with other values, fewer
# candidates (the high-water mark keeps the bucket), a second bucket, and
# the first again.
SCORER_CALLS = [(0, 5, 2, 2, 20), (1, 5, 2, 2, 20), (2, 5, 2, 2, 9), (3, 12, 3, 5, 40),
                (4, 6, 2, 3, 17)]


def test_scorer_accounting_matches():
    padded_bytes = []
    high_water = {}
    for seed, *shape in SCORER_CALLS:
        jsnap, tsnap = _snapshot(seed, *shape)
        want = jscorer._score_jax(jsnap)
        got = tscorer.score(tsnap, device="cpu")
        np.testing.assert_array_equal(got.feasible, want.feasible)
        np.testing.assert_array_equal(got.queue_share, want.queue_share)
        # The copies this call made: _pad against the high-water state
        # as it stood before the call.
        saved, tscorer._P_HIGH_WATER = tscorer._P_HIGH_WATER, high_water
        arrays = tscorer._pad(tsnap)
        tscorer._P_HIGH_WATER = saved
        P, Q = arrays[6].shape[0], arrays[0].shape[0]
        padded_bytes.append((sum(a.nbytes for a in arrays), 4 * (2 * P + Q)))
    ref, port = _accounting("queue_scorer")
    assert port["compiles"] == ref["compiles"] == 2.0
    assert port["compile_seconds"] == ref["compile_seconds"] == 2
    assert port["cache"] == ref["cache"] == (3, 2)
    assert port["gauges"] == ref["gauges"] == (3.0, 2.0)
    h2d, d2h = (float(sum(b[i] for b in padded_bytes)) for i in (0, 1))
    assert port["bytes"] == (h2d, d2h)
    assert ref["bytes"][0] > 0 and ref["bytes"][1] > 0


def _grow(col, factor=2):
    """The state's pod columns at `factor` times their capacity, the new
    rows dead: a larger pod-capacity bucket with the same counts."""
    for name, fill in (("pod_job", -1), ("pod_phase", 0), ("pod_ready", 0), ("pod_cidx", -1)):
        a = getattr(col, name)
        setattr(col, name, np.concatenate([a, np.full(a.shape[0] * (factor - 1), fill,
                                                       a.dtype)]))


def test_aggregate_accounting_matches():
    col = test_columnar.run_scenario(True).columnar
    for grow in (False, False, True, False):
        if grow:
            _grow(col)
        Pc, Jc = col.pod_phase.shape[0], col.job_expected.shape[0]
        want = col.job_aggregates_locked(force_jax=True)
        got = tcolumnar.job_counts(col.pod_job[:Pc], col.pod_phase[:Pc], col.pod_ready[:Pc],
                                   Jc, device="cpu")
        J = max(col._job_len, 1)
        for g, field in zip(got, ("active", "ready", "failed")):
            np.testing.assert_array_equal(g[:J], np.asarray(getattr(want, field))[:J])
    ref, port = _accounting("columnar_agg")
    assert port == ref
    assert port["compiles"] == 2.0 and port["cache"] == (2, 2) and port["gauges"] == (2.0, 2.0)
    assert port["bytes"][0] > 0 and port["bytes"][1] > 0


def _models(seed):
    rng = np.random.default_rng(seed)
    params = [(w, (rng.standard_normal(b.shape) * 0.1).astype(np.float32))
              for w, b in tmodel.init_params(seed)]
    fields = dict(feat_mean=rng.random(params[0][0].shape[0]).astype(np.float32),
                  feat_std=(0.5 + rng.random(params[0][0].shape[0])).astype(np.float32),
                  label_mean=30.0, label_std=12.0)
    return (jmodel.PolicyModel(params=params, **fields),
            tmodel.PolicyModel(params=params, **fields))


# Rows per call: a bucket of 32, the same bucket, a bucket of 128, 32 again.
MLP_ROWS = (20, 25, 100, 30)


def test_policy_mlp_accounting_matches():
    jm, tm = _models(7)
    rng = np.random.default_rng(8)
    h2d = d2h = 0
    for rows in MLP_ROWS:
        feats = rng.random((rows, jm.feat_mean.shape[0])).astype(np.float32)
        want = jmodel.score(jm, feats)
        got = tmodel.score(tm, feats, device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1.0))
        rows_p = tmodel._round_up_pow2(rows)
        h2d += sum(4 * (w.size + b.size) for w, b in tm.params) + 4 * rows_p * feats.shape[1]
        d2h += 4 * rows_p
    ref, port = _accounting("policy_mlp")
    for key in ("compiles", "compile_seconds", "cache", "gauges"):
        assert port[key] == ref[key]
    assert port["compiles"] == 2.0 and port["cache"] == (2, 2)
    assert ref["bytes"] == (0.0, 0.0) and port["bytes"] == (float(h2d), float(d2h))


def test_repeated_bucket_times_only_its_first_call():
    """A hit runs the cached bucket call without a second compile record."""
    jsnap, tsnap = _snapshot(0, 5, 2, 2, 20)
    for _ in range(3):
        tscorer.score(tsnap, device="cpu")
    assert tmetrics.jit_compiles_total.value("queue_scorer") == 1.0
    assert tmetrics.jit_compile_seconds.count("queue_scorer") == 1
    assert tprofile.KERNEL_CACHES.snapshot()["queue_scorer"]["hits"] == 2
