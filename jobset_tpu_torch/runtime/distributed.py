"""In-pod rendezvous: the JobSet identity a pod's environment carries
(the port's own copy of `jobset_tpu/runtime/distributed.py`'s contract).

The control plane gives each pod its job index, global job index, pod
index, the gang's process count and a coordinator address. The port runs
one process on one device so far: `initialize` accepts a gang of one and
raises on more (multi-device training is a later slice).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

ENV_JOBSET_NAME = "JOBSET_NAME"
ENV_REPLICATED_JOB = "JOBSET_REPLICATED_JOB"
ENV_JOB_INDEX = "JOBSET_JOB_INDEX"
ENV_JOB_GLOBAL_INDEX = "JOBSET_JOB_GLOBAL_INDEX"
ENV_POD_INDEX = "JOBSET_POD_INDEX"
ENV_PODS_PER_JOB = "JOBSET_PODS_PER_JOB"
# Prefix sum of expected pod counts over all jobs preceding this one in
# global-index order; this job's pods occupy ranks [offset, offset+pods).
ENV_PROCESS_OFFSET = "JOBSET_PROCESS_OFFSET"
ENV_TOTAL_PROCESSES = "JOBSET_TOTAL_PROCESSES"
ENV_COORDINATOR = "JOBSET_COORDINATOR"  # <hostname>.<subdomain>[:port]

DEFAULT_COORDINATOR_PORT = 8476


@dataclass(frozen=True)
class RankInfo:
    """Identity of this process within the JobSet gang."""

    jobset_name: str
    replicated_job: str
    job_index: int
    job_global_index: int
    pod_index: int
    pods_per_job: int
    process_offset: int
    total_processes: int
    coordinator: str

    @property
    def process_id(self) -> int:
        """Global rank: the offset of the preceding jobs' pods plus this
        pod's completion index."""
        return self.process_offset + self.pod_index

    @property
    def coordinator_address(self) -> str:
        addr = self.coordinator
        if ":" not in addr:
            addr = f"{addr}:{DEFAULT_COORDINATOR_PORT}"
        return addr


def rank_from_env(env: Optional[dict] = None) -> RankInfo:
    """RankInfo from the environment; KeyError names a missing variable."""
    env = env if env is not None else dict(os.environ)

    def need(key):
        if key not in env:
            raise KeyError(f"missing JobSet rendezvous env var: {key}")
        return env[key]

    return RankInfo(
        jobset_name=need(ENV_JOBSET_NAME),
        replicated_job=need(ENV_REPLICATED_JOB),
        job_index=int(need(ENV_JOB_INDEX)),
        job_global_index=int(need(ENV_JOB_GLOBAL_INDEX)),
        pod_index=int(env.get(ENV_POD_INDEX, "0")),
        pods_per_job=int(env.get(ENV_PODS_PER_JOB, "1")),
        process_offset=int(need(ENV_PROCESS_OFFSET)),
        total_processes=int(need(ENV_TOTAL_PROCESSES)),
        coordinator=need(ENV_COORDINATOR),
    )


def standalone_rank() -> RankInfo:
    """The identity of a run with no rendezvous contract: one process."""
    return RankInfo(jobset_name="", replicated_job="", job_index=0, job_global_index=0,
                    pod_index=0, pods_per_job=1, process_offset=0, total_processes=1,
                    coordinator="")


def initialize(rank: Optional[RankInfo] = None) -> RankInfo:
    """Accept the gang this process belongs to. A gang of one needs no
    process group; a larger one raises, as multi-process training is not
    ported yet."""
    rank = rank if rank is not None else rank_from_env()
    if rank.total_processes > 1:
        raise NotImplementedError(
            f"a gang of {rank.total_processes} processes: the port trains in "
            "one process on one device so far"
        )
    return rank
