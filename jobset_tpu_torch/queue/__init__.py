"""The admission queue's device program: the batched scorer."""

from .scorer import ScoreResult, Snapshot, score

__all__ = ["ScoreResult", "Snapshot", "score"]
