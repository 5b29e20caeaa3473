"""The gang-readiness aggregate of the columnar cluster core, as torch code
on the card.

Counterpart of the aggregation kernel in `jobset_tpu/core/columnar.py`
(`_agg_kernel`): one whole-store pass over the pod columns that counts,
per job row, its live (Pending or Running) pods, the ready ones among
them, and its Failed pods. The columns themselves (`ColumnarState`)
belong to the control plane's `Cluster`, which stays with the reference.

The counts are int32 scatter-adds of 0/1 values (`index_add_`): integer
adds are exact in any order, so the card's atomics give numpy
`bincount`'s counts (`job_counts_reference`) exactly. Dead rows (job -1)
add zero into row 0 instead of indexing out of range; a job index at or
past the capacity adds nothing either, as the reference's scatter drops it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..obs import profile

# Phase interning (fixed, ordered so `phase <= RUNNING` selects live pods).
PHASE_PENDING = 0
PHASE_RUNNING = 1
PHASE_SUCCEEDED = 2
PHASE_FAILED = 3


def _round_up_pow2(n: int, minimum: int = 1024) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


def count_tensors(jobs: torch.Tensor, phase: torch.Tensor, ready: torch.Tensor,
                  job_capacity: int) -> torch.Tensor:
    """[3, job_capacity] int32 counts (active, ready, failed) from the [P]
    pod columns of one device: job row (-1 = dead), phase, ready flag."""
    alive = (jobs >= 0) & (jobs < job_capacity)
    pend_run = alive & (phase <= PHASE_RUNNING)
    flags = torch.stack([pend_run, pend_run & (ready != 0),
                         alive & (phase == PHASE_FAILED)]).to(torch.int32)
    safe = torch.where(alive, jobs, 0)
    counts = torch.zeros((3, job_capacity), dtype=torch.int32, device=jobs.device)
    return counts.index_add_(1, safe, flags)


@functools.lru_cache(maxsize=8)
def _agg_kernel(P: int, J: int):
    """The device call of one (pod capacity, job capacity) bucket, as the
    reference's compile-once factory keys it: its first call is timed as
    the family's compile (obs/profile.py), and the cache's hits and misses
    are the `jobset_jit_cache_*` gauges' "columnar_agg" series."""

    def kernel(jobs, phase, ready):
        return count_tensors(jobs, phase, ready, J)

    return profile.timed_compile("columnar_agg", kernel)


profile.KERNEL_CACHES.register("columnar_agg", _agg_kernel)


def job_counts(jobs: np.ndarray, phase: np.ndarray, ready: np.ndarray,
               job_capacity: int, device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-job (active, ready, failed) int32 counts, each [job_capacity],
    for the [Pc] pod columns at their pow2 capacities, counted on `device`
    (the card unless the caller names another; with no CUDA device and
    none named it raises). Transfers are counted as the reference counts
    them: the three columns in, the three counts out."""
    device = resolve_device(device)
    columns = (jobs, phase, ready)
    profile.note_transfer("columnar_agg", "h2d", *columns)
    counts = _agg_kernel(jobs.shape[0], job_capacity)(
        *(torch.from_numpy(a).to(device) for a in columns)).cpu().numpy()
    profile.note_transfer("columnar_agg", "d2h", counts)
    return counts[0], counts[1], counts[2]


def job_counts_reference(jobs: np.ndarray, phase: np.ndarray, ready: np.ndarray,
                         job_capacity: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The plain version: numpy `bincount`, as the reference's numpy path
    counts."""
    alive = (jobs >= 0) & (jobs < job_capacity)
    pend_run = alive & (phase <= PHASE_RUNNING)
    failed = alive & (phase == PHASE_FAILED)
    return tuple(
        np.bincount(jobs[mask], minlength=job_capacity).astype(np.int32)
        for mask in (pend_run, pend_run & (ready != 0), failed)
    )
