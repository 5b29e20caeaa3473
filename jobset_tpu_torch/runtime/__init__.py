"""The workload plane's runtime, on one device or as a gang of processes
on `torch.distributed`: optimizers, the input pipeline, checkpoints, the
rendezvous, the workload runner (the lm, mlp and cnn kinds), the
simulator's gang runner, the per-pod worker and the model benchmark."""

from .checkpoint import Checkpointer
from .distributed import RankInfo, initialize, pod_env_for, rank_from_env, shutdown
from .runner import TrainResult, WorkloadFailure, WorkloadRunner, train_workload

__all__ = ["Checkpointer", "RankInfo", "TrainResult", "WorkloadFailure", "WorkloadRunner",
           "initialize", "pod_env_for", "rank_from_env", "shutdown", "train_workload"]
