"""The placement policy's feature schema and per-domain outcome history:
the framework-free names the port's model, corpus builder and trainer
need.

Counterpart of part of `jobset_tpu/policy/features.py`. The extraction of
feature rows from a live cluster (`feature_matrix` and the domain views)
stays with the reference, since it reads the control plane's `Cluster`;
recorded rows reach the port through debug bundles and checkpoints.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Fixed feature schema (docs/policy.md documents each column). Order is
# the wire contract: recorded vectors, corpus matrices, and checkpoints all
# index by position.
FEATURE_NAMES: tuple[str, ...] = (
    "domain_position",    # sorted-domain index / num_domains (topology coord)
    "domain_coord",       # trailing integer of the domain value / num_domains
    "domain_distance",    # |coord - sticky domain's coord| / num_domains
    "occupancy_frac",     # allocated pods / capacity in this domain
    "free_frac",          # free pods / capacity
    "fit_headroom",       # (free - pods_needed) / max(capacity, 1)
    "fragmentation",      # (free % pods_needed) / max(capacity, 1) — waste
    "domain_occupied",    # 1 when another job key owns the domain
    "sticky",             # 1 when this job key last ran here
    "gang_replicas",      # jobs in the gang / 64 (clipped)
    "job_pods",           # pods this job needs / 64 (clipped)
    "gang_total_pods",    # total pods in the gang / 1024 (clipped)
    "queue_backlog",      # pending queue workloads / 64 (clipped)
    "priority",           # spec.priority / 100 (clipped)
    "hist_mean_outcome",  # corpus: mean outcome seconds of gangs placed here
    "hist_restart_rate",  # corpus: restarts per placement decision here
)
FEATURE_DIM = len(FEATURE_NAMES)

HIST_MEAN_IDX = FEATURE_NAMES.index("hist_mean_outcome")
HIST_RESTART_IDX = FEATURE_NAMES.index("hist_restart_rate")


class DomainHistory:
    """Aggregate per-domain outcome statistics from a training corpus.

    Per domain value: (decisions, outcome_sum_seconds, restarts). The
    corpus builder accumulates these while labeling examples; the trainer
    stores them in the checkpoint; the scorer replays them into the
    ``hist_*`` feature columns at inference time.
    """

    def __init__(self) -> None:
        self._stats: dict[str, list[float]] = {}

    def record_decision(self, domain: str, outcome_s: Optional[float]) -> None:
        s = self._stats.setdefault(domain, [0.0, 0.0, 0.0])
        s[0] += 1.0
        if outcome_s is not None:
            s[1] += float(outcome_s)

    def record_restart(self, domain: str) -> None:
        s = self._stats.setdefault(domain, [0.0, 0.0, 0.0])
        s[2] += 1.0

    def mean_outcome(self, domain: str) -> float:
        s = self._stats.get(domain)
        return (s[1] / s[0]) if s and s[0] else 0.0

    def mean_outcome_excluding(self, domain: str, outcome_s: float) -> float:
        """Leave-one-out mean: the domain's mean outcome WITHOUT one
        observed sample. The corpus builder fills each training row's
        ``hist_mean_outcome`` with this so the feature never contains the
        row's own label (a one-example domain would otherwise hand the
        model its answer verbatim). Inference uses the plain mean — the
        candidate's outcome is unknown there, so nothing leaks."""
        s = self._stats.get(domain)
        if not s or s[0] <= 1:
            return 0.0
        return (s[1] - float(outcome_s)) / (s[0] - 1)

    def restart_rate(self, domain: str) -> float:
        s = self._stats.get(domain)
        return (s[2] / s[0]) if s and s[0] else 0.0

    def __len__(self) -> int:
        return len(self._stats)

    # -- checkpoint round trip (plain arrays, deterministic order) --------

    def to_arrays(self) -> tuple[list[str], np.ndarray]:
        domains = sorted(self._stats)
        stats = np.array(
            [self._stats[d] for d in domains], np.float32
        ).reshape(len(domains), 3)
        return domains, stats

    @classmethod
    def from_arrays(cls, domains, stats) -> "DomainHistory":
        h = cls()
        for d, row in zip(list(domains), np.asarray(stats, np.float32)):
            h._stats[str(d)] = [float(row[0]), float(row[1]), float(row[2])]
        return h
