"""The port's admission scorer against the JAX package's, on the CPU.

The contract is the reference's: bit-identical admission decisions. The
port's `score` (torch, here on the CPU) must give `feasible`,
`queue_share` and `candidate_share` equal bit for bit to the greedy numpy
path (`jobset_tpu.queue.scorer._score_greedy`, the reference's default) on
every snapshot, and to the reference's jit backend (`_score_jax`) wherever
that one agrees with the greedy path. Tolerance: none.

At non-integer quotas with 64 or more (padded) queues, the jit backend's
column sums (`nominal.sum(axis=0)`, XLA's order) differ from numpy's in
the last bit, so its shares differ from the greedy path's there: a fault
of the reference, recorded in ROADMAP §C. Feasibility does not depend on
that sum, so the port is held to the jit backend's `feasible` on every
snapshot and to its shares on integer ones.
"""

import numpy as np
import pytest
import torch

import test_queue
from jobset_tpu.core import features
from jobset_tpu.queue import manager as jmanager
from jobset_tpu.queue import scorer as jscorer
from jobset_tpu_torch.queue import scorer as tscorer

FIELDS = ("feasible", "queue_share", "candidate_share")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_buckets():
    """Each case starts with no high-water buckets, on both sides."""
    tscorer._P_HIGH_WATER.clear()
    jscorer._P_HIGH_WATER.clear()
    yield
    tscorer._P_HIGH_WATER.clear()
    jscorer._P_HIGH_WATER.clear()


def _port(snap: jscorer.Snapshot) -> tscorer.Snapshot:
    return tscorer.Snapshot(**{f: getattr(snap, f) for f in snap.__dataclass_fields__})


def _snapshot(rng, kind, Q, R, P, C):
    """A random snapshot. kind: "integer" (the reference's generator,
    tests/test_queue.py), "tenths" (quotas, usage and requests in steps of
    0.1), "near_1e7" (quotas near 1e7 with fractions, where a float32 ulp
    is 1), "cohort_heavy" (tenths, every queue in one of two cohorts)."""
    declared = rng.random((Q, R)) > 0.2
    if kind == "integer":
        nominal = rng.integers(0, 64, (Q, R)).astype(np.float64)
        usage = rng.integers(0, 32, (Q, R)).astype(np.float64)
        request = rng.integers(0, 16, (P, R)).astype(np.float64)
    elif kind in ("tenths", "cohort_heavy"):
        nominal = rng.integers(0, 640, (Q, R)) * 0.1
        usage = rng.integers(0, 320, (Q, R)) * 0.1
        request = rng.integers(0, 160, (P, R)) * 0.1
    elif kind == "near_1e7":
        nominal = 1e7 + rng.integers(0, 640, (Q, R)) * 0.1
        usage = rng.integers(0, 4_000_000, (Q, R)) * 0.1
        request = rng.integers(0, 30_000_000, (P, R)) * 0.1
    else:
        raise ValueError(kind)
    cohort = (rng.integers(0, min(C, 2), Q) if kind == "cohort_heavy"
              else rng.integers(-1, C, Q))
    return jscorer.Snapshot(
        resources=[f"r{i}" for i in range(R)],
        queue_names=[f"q{i}" for i in range(Q)],
        nominal=(nominal * declared).astype(np.float32),
        declared=declared,
        usage=usage.astype(np.float32),
        weight=rng.integers(1, 5, Q).astype(np.float32),
        cohort=cohort.astype(np.int32),
        num_cohorts=C,
        request=request.astype(np.float32),
        queue_index=rng.integers(0, Q, P).astype(np.int32),
    )


def _jit(snap):
    with features.gate("TPUQueueScorer", True):
        return jscorer.score(snap)


def _assert_equal(got, want, fields=FIELDS, what=""):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (what, f)


@pytest.mark.parametrize("kind", ["integer", "tenths", "near_1e7", "cohort_heavy"])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("R", [1, 3])
def test_port_scorer_matches_greedy_and_jit_bit_for_bit(kind, seed, R):
    rng = np.random.default_rng(1000 * seed + R)
    for trial in range(3):
        snap = _snapshot(rng, kind, int(rng.integers(1, 130)), R,
                         int(rng.integers(1, 300)), int(rng.integers(1, 7)))
        got = tscorer.score(_port(snap), device="cpu")
        assert got.backend == "torch"
        _assert_equal(got, jscorer._score_greedy(snap), what=(kind, trial, "greedy"))
        jit = _jit(snap)
        _assert_equal(got, jit, fields=("feasible",), what=(kind, trial, "jit"))
        if kind == "integer":
            _assert_equal(got, jit, what=(kind, trial, "jit"))


def test_reference_generator_snapshots_match_both_backends():
    """tests/test_queue.py's generator and seed, all three ways."""
    rng = np.random.default_rng(11)
    for trial in range(5):
        Q, R, P, C = (int(rng.integers(1, 20)), int(rng.integers(1, 5)),
                      int(rng.integers(1, 60)), int(rng.integers(1, 4)))
        declared = rng.random((Q, R)) > 0.2
        snap = jscorer.Snapshot(
            resources=[f"r{i}" for i in range(R)],
            queue_names=[f"q{i}" for i in range(Q)],
            nominal=(rng.integers(0, 64, (Q, R)) * declared).astype(np.float32),
            declared=declared,
            usage=rng.integers(0, 32, (Q, R)).astype(np.float32),
            weight=rng.integers(1, 5, Q).astype(np.float32),
            cohort=rng.integers(-1, C, Q).astype(np.int32),
            num_cohorts=C,
            request=rng.integers(0, 16, (P, R)).astype(np.float32),
            queue_index=rng.integers(0, Q, P).astype(np.int32),
        )
        got = tscorer.score(_port(snap), device="cpu")
        _assert_equal(got, jscorer._score_greedy(snap), what=trial)
        _assert_equal(got, _jit(snap), what=trial)


def test_no_cohort_and_unquoted_rows():
    """cohort -1 everywhere, and candidates asking for an undeclared
    resource: never feasible."""
    rng = np.random.default_rng(5)
    snap = _snapshot(rng, "tenths", 40, 2, 90, 3)
    snap.cohort[:] = -1
    snap.declared[:, 1] = False
    snap.nominal[:, 1] = 0.0
    snap.request[::2, 1] = 0.5
    got = tscorer.score(_port(snap), device="cpu")
    _assert_equal(got, jscorer._score_greedy(snap))
    assert not got.feasible[::2].any()


def test_no_candidates_gives_the_greedy_shares():
    rng = np.random.default_rng(6)
    snap = _snapshot(rng, "tenths", 12, 2, 0, 2)
    got = tscorer.score(_port(snap), device="cpu")
    want = jscorer.score(snap)
    assert got.backend == want.backend == "greedy"
    _assert_equal(got, want)


def test_candidates_across_buckets_keep_the_high_water():
    """P falls pass over pass (512 -> 300 -> 40 -> 3): the bucket stays at
    the first pass's, and every pass matches the greedy path."""
    rng = np.random.default_rng(7)
    base = _snapshot(rng, "tenths", 24, 2, 512, 3)
    for P in (512, 300, 40, 3):
        snap = jscorer.Snapshot(**{**base.__dict__, "request": base.request[:P].copy(),
                                   "queue_index": base.queue_index[:P].copy()})
        got = tscorer.score(_port(snap), device="cpu")
        _assert_equal(got, jscorer._score_greedy(snap), what=P)
    assert set(tscorer._P_HIGH_WATER.values()) == {512}
    tscorer.warm(24, 2, 3, 1000, device="cpu")
    assert tscorer._P_HIGH_WATER[(32, 4, 4)] == 1024


@pytest.mark.parametrize("R", [1, 2, 3, 8])
@pytest.mark.parametrize("Q", [3, 7, 8, 9, 64, 100, 129, 1024, 8193])
def test_column_sums_add_in_numpy_order(Q, R):
    """numpy's `sum(axis=0)` of a C-contiguous [Q, R] float32 array adds
    row after row when R >= 2, and pairwise when R == 1 (one contiguous
    run). The port's `column_sums` equals it bit for bit at adversarial
    values (mixed signs, magnitudes from 1e-3 to 1e7)."""
    rng = np.random.default_rng(Q * 10 + R)
    for _ in range(4):
        a = (rng.standard_normal((Q, R)) * 10.0 ** rng.integers(-3, 8, (Q, R))).astype(np.float32)
        want = a.sum(axis=0, dtype=np.float32)
        padded = np.zeros((tscorer._round_up_pow2(Q), max(R, 4)), np.float32)
        padded[:Q, :R] = a
        got = tscorer.column_sums(torch.from_numpy(padded), Q, R).numpy()
        assert np.array_equal(got[:R], want)
        assert not got[R:].any()
        rows = np.zeros(R, np.float32)
        for row in a:
            rows += row
        if R >= 2:
            assert np.array_equal(rows, want), "numpy adds row after row"


def test_numpy_single_column_sum_is_not_row_after_row():
    """Why `column_sums` has a pairwise branch: at one resource, numpy's
    sum of [1, 1e8, -1e8, 1, 1, 1, 1, 1] is ((1 + 1e8) + (-1e8 + 1)) +
    ((1 + 1) + (1 + 1)) = 4, where row after row gives 5."""
    a = np.array([1, 1e8, -1e8, 1, 1, 1, 1, 1], np.float32)[:, None]
    rows = np.zeros(1, np.float32)
    for row in a:
        rows += row
    assert rows[0] == 5.0 and a.sum(axis=0, dtype=np.float32)[0] == 4.0
    padded = np.zeros((8, 4), np.float32)
    padded[:, :1] = a
    assert tscorer.column_sums(torch.from_numpy(padded), 8, 1)[0].item() == 4.0


def test_cohort_members_table():
    table = tscorer.cohort_members(np.array([1, -1, 0, 1, 1, 0]), 3)
    assert table.tolist() == [[2, 5, 6], [0, 3, 4], [6, 6, 6]]


def test_admission_scenario_through_the_port_matches_greedy(monkeypatch):
    """tests/test_queue.py's gang admission, preemption and requeue
    scenario with the queue manager's scorer replaced by the port's: the
    ordered Queue* event stream equals the greedy one."""
    greedy = test_queue._run_gang_scenario(gate=False)
    calls = []

    def port_score(snapshot):
        calls.append(snapshot.request.shape[0])
        return tscorer.score(_port(snapshot), device="cpu")

    monkeypatch.setattr(jmanager, "score", port_score)
    assert test_queue._run_gang_scenario(gate=False) == greedy
    assert calls and any(calls)
