"""The workload plane's runtime on one device: optimizers, the input
pipeline, checkpoints, the LM workload runner, the per-pod worker and the
model benchmark."""

from .checkpoint import Checkpointer
from .distributed import RankInfo, initialize, rank_from_env
from .runner import TrainResult, WorkloadFailure, train_workload

__all__ = ["Checkpointer", "RankInfo", "TrainResult", "WorkloadFailure", "initialize",
           "rank_from_env", "train_workload"]
