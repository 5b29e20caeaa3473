"""The port's gang-readiness aggregate against the JAX package's, on the
CPU.

`job_counts` (torch, here on the CPU) must equal the reference's jit
kernel (`jobset_tpu.core.columnar._agg_kernel`) and numpy `bincount`
exactly, at pow2 capacity buckets with dead rows (job -1) and every phase.
Tolerance: none; the counts are integers. End to end, the reference's
`job_aggregates_locked(force_jax=True)` with the port's function in place
of its kernel equals its numpy path on tests/test_columnar.py's scenario.
"""

import numpy as np
import pytest
import torch

import test_columnar
from jobset_tpu.core import columnar as jcolumnar
from jobset_tpu_torch.core import columnar as tcolumnar


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _columns(rng, pods, jobs, dead=0.1):
    """Pod columns at their pow2 capacities: a share `dead` of rows (and
    every row past `pods`) with job -1, all four phases, ready flags as
    int8, as `ColumnarState` keeps them."""
    Pc, Jc = jcolumnar._round_up_pow2(pods), jcolumnar._round_up_pow2(jobs)
    job = rng.integers(0, jobs, Pc).astype(np.int32)
    job[rng.random(Pc) < dead] = -1
    job[pods:] = -1
    phase = rng.integers(0, 4, Pc).astype(np.int32)
    ready = (rng.random(Pc) < 0.5).astype(np.int8)
    return job, phase, ready, Jc


@pytest.mark.parametrize("pods,jobs", [(1, 1), (1000, 10), (1025, 700), (5000, 1024),
                                       (16384, 1024), (40000, 3000)])
@pytest.mark.parametrize("dead", [0.0, 0.1, 1.0])
def test_job_counts_match_jit_kernel_and_bincount(pods, jobs, dead):
    rng = np.random.default_rng(pods + jobs)
    job, phase, ready, Jc = _columns(rng, pods, jobs, dead)
    got = tcolumnar.job_counts(job, phase, ready, Jc, device="cpu")
    want_jit = jcolumnar._agg_kernel(job.shape[0], Jc)(job, phase, ready)
    want_np = tcolumnar.job_counts_reference(job, phase, ready, Jc)
    for g, j, n in zip(got, want_jit, want_np):
        assert g.dtype == np.int32 and g.shape == (Jc,)
        assert np.array_equal(g, np.asarray(j)) and np.array_equal(g, n)
    if dead == 1.0:
        assert not any(g.any() for g in got)


def test_dead_rows_add_nothing_to_row_zero():
    job = np.array([-1, -1, 0, -1], np.int32)
    phase = np.array([1, 3, 1, 0], np.int32)
    ready = np.array([1, 1, 1, 1], np.int8)
    active, ready_c, failed = tcolumnar.job_counts(job, phase, ready, 4, device="cpu")
    assert active.tolist() == [1, 0, 0, 0] and ready_c.tolist() == [1, 0, 0, 0]
    assert failed.tolist() == [0, 0, 0, 0]


def test_plain_version_matches_the_reference_numpy_path():
    """`job_counts_reference` is the reference's bincount trio
    (`job_aggregates_locked`'s numpy branch) written out."""
    rng = np.random.default_rng(3)
    job, phase, ready, Jc = _columns(rng, 3000, 500)
    alive = job >= 0
    pend_run = alive & (phase <= jcolumnar.PHASE_RUNNING)
    want = (np.bincount(job[pend_run], minlength=Jc),
            np.bincount(job[pend_run & (ready != 0)], minlength=Jc),
            np.bincount(job[alive & (phase == jcolumnar.PHASE_FAILED)], minlength=Jc))
    for g, w in zip(tcolumnar.job_counts_reference(job, phase, ready, Jc), want):
        assert np.array_equal(g, w)
    assert (tcolumnar.PHASE_PENDING, tcolumnar.PHASE_RUNNING, tcolumnar.PHASE_SUCCEEDED,
            tcolumnar.PHASE_FAILED) == (jcolumnar.PHASE_PENDING, jcolumnar.PHASE_RUNNING,
                                        jcolumnar.PHASE_SUCCEEDED, jcolumnar.PHASE_FAILED)
    assert tcolumnar._round_up_pow2(5000) == jcolumnar._round_up_pow2(5000) == 8192


def test_job_aggregates_through_the_port_match_numpy(monkeypatch):
    """tests/test_columnar.py's scenario; the reference's aggregate with
    the port's counts in place of its jit kernel equals its numpy path."""
    cluster = test_columnar.run_scenario(True)
    col = cluster.columnar
    a_np = col.job_aggregates_locked(force_jax=False)
    calls = []

    def port_kernel(P, J):
        def kernel(jobs, phase, ready):
            calls.append((P, J))
            return tcolumnar.job_counts(jobs, phase, ready, J, device="cpu")
        return kernel

    monkeypatch.setattr(jcolumnar, "_agg_kernel", port_kernel)
    a_port = col.job_aggregates_locked(force_jax=True)
    assert calls
    for field in ("active", "ready", "failed"):
        lhs = np.asarray(getattr(a_np, field))
        rhs = np.asarray(getattr(a_port, field))
        n = min(lhs.shape[0], rhs.shape[0])
        assert np.array_equal(lhs[:n], rhs[:n]), field
        assert not lhs[n:].any() and not rhs[n:].any()
