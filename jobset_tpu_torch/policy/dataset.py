"""Corpus builder: debug bundles -> (features, outcome) training examples.

A copy of `jobset_tpu/policy/dataset.py` for the port's trainer (numpy
only; no device).

The observability plane's ``debug-bundle`` tarballs already carry
everything the policy needs (this is the data flywheel): each JobSet
timeline records the placement decisions the provider stamped — feature
vector, chosen domain, decision time — and the lifecycle phase marks that
followed. The builder joins them:

* **example**: one placement decision whose gang subsequently reached
  ``Ready`` (first placement) or ``Recovered`` (restart placement);
* **label**: seconds from the decision to that mark — the time-to-ready
  outcome the SLO plane measures, attributed to the decision;
* **history**: per-domain aggregates (decisions, outcome sum, restarts)
  accumulated across the whole corpus, written back into the two
  ``hist_*`` feature columns (zero at record time by contract —
  ``policy/features.py``) and stored in the checkpoint so inference sees
  the same distribution.

Restarts are attributed to the domain the job was in when it failed: for
consecutive placements of one job, the earlier decision's domain takes the
restart — historical fragility signal the hand-written cost cannot see.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..obs.bundle import load_bundle
from .features import FEATURE_DIM, HIST_MEAN_IDX, HIST_RESTART_IDX, DomainHistory

# Phase marks that close an outcome window opened by a placement decision.
_OUTCOME_PHASES = ("Ready", "Recovered")


@dataclass
class Dataset:
    features: np.ndarray                 # [N, FEATURE_DIM] float32
    labels: np.ndarray                   # [N] outcome seconds, float32
    history: DomainHistory
    meta: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return int(self.labels.shape[0])


def discover_bundles(path: str) -> list[str]:
    """Bundle paths under `path` (a directory of ``.tgz``/``.tar.gz``
    archives, sorted for determinism) or `path` itself when it is a
    file."""
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, name)
            for name in os.listdir(path)
            if name.endswith((".tgz", ".tar.gz"))
        )
    return [path]


def _outcome_marks(timeline: dict) -> list[float]:
    """Sorted times of the phase marks that close outcome windows."""
    return sorted(
        e["time"]
        for e in timeline.get("entries", ())
        if e.get("source") == "phase" and e.get("type") in _OUTCOME_PHASES
    )


def examples_from_timeline(timeline: dict) -> tuple[list[tuple], list[dict]]:
    """(labeled examples, all placements) from one timeline.

    Each example is ``(features, label_seconds, domain)``; placements whose
    gang never reached Ready/Recovered afterwards produce no example but
    still count as decisions for the history aggregates."""
    placements = [
        p for p in timeline.get("placements", ())
        if isinstance(p.get("features"), list)
        and len(p["features"]) == FEATURE_DIM
        and p.get("domain")
    ]
    marks = _outcome_marks(timeline)
    examples: list[tuple] = []
    for p in placements:
        t = float(p.get("time", 0.0))
        label = next((m - t for m in marks if m >= t), None)
        if label is not None:
            examples.append((p["features"], float(label), p["domain"]))
    return examples, placements


def build_dataset(paths: list[str]) -> Dataset:
    """Join every bundle's timelines into one training set. Raises
    ValueError when the corpus yields zero labeled examples — an empty
    matrix would train a model that confidently knows nothing."""
    history = DomainHistory()
    feats: list[list[float]] = []
    labels: list[float] = []
    example_domains: list[str] = []
    bundles_used = 0
    decisions = 0
    unlabeled = 0

    for path in paths:
        bundle = load_bundle(path)
        bundles_used += 1
        timelines = bundle.get("timelines.json", {})
        for timeline in timelines.values():
            examples, placements = examples_from_timeline(timeline)
            decisions += len(placements)
            unlabeled += len(placements) - len(examples)
            for row, label, domain in examples:
                feats.append(row)
                labels.append(label)
                example_domains.append(domain)
                history.record_decision(domain, label)
            labeled_keys = {id(e[0]) for e in examples}
            for p in placements:
                if id(p["features"]) not in labeled_keys:
                    history.record_decision(p["domain"], None)
            # Restart attribution: the EARLIER of two consecutive
            # placements of the same job owns the restart.
            by_job: dict[str, list[dict]] = {}
            for p in placements:
                by_job.setdefault(p.get("job", ""), []).append(p)
            for job_placements in by_job.values():
                job_placements.sort(
                    key=lambda p: (float(p.get("time", 0.0)),
                                   int(p.get("restarts", 0)))
                )
                for prev in job_placements[:-1]:
                    history.record_restart(prev["domain"])

    if not labels:
        raise ValueError(
            f"no labeled training examples in {bundles_used} bundle(s) "
            f"({decisions} placement decisions, none followed by a "
            f"Ready/Recovered mark) — the corpus must come from runs "
            f"where gangs actually started"
        )

    matrix = np.asarray(feats, np.float32)
    # Fill the historical columns from the FINAL corpus aggregates (they
    # are recorded as zeros by contract; see policy/features.py). The
    # outcome mean is leave-one-out per row: a domain's aggregate minus
    # the row's own label, so the feature cannot leak the target.
    for row, domain in enumerate(example_domains):
        matrix[row, HIST_MEAN_IDX] = history.mean_outcome_excluding(
            domain, labels[row]
        )
        matrix[row, HIST_RESTART_IDX] = history.restart_rate(domain)

    return Dataset(
        features=matrix,
        labels=np.asarray(labels, np.float32),
        history=history,
        meta={
            "bundles": bundles_used,
            "decisions": decisions,
            "examples": len(labels),
            "unlabeled": unlabeled,
            "domains": len(history),
        },
    )
