"""In-pod rendezvous: the JobSet identity a pod's environment carries
(the port's own copy of `jobset_tpu/runtime/distributed.py`'s contract),
and the gang's process group on `torch.distributed`.

The control plane gives each pod its job index, global job index, pod
index, the gang's process count and a coordinator address
(`pod_env_for` builds that environment for a simulated pod).
`initialize` joins the gang: `torch.distributed.init_process_group` at
`tcp://<coordinator>`, rank = the pod's process id, world = the gang's
process count, on the backend the caller names ("nccl" for the card,
"gloo" for the CPU, or for CUDA tensors of ranks that share one card).
A gang of one process makes a process group too, so the single-process
and the gang paths are one code path. A rank that cannot rendezvous
raises; no backend is swapped on a failure. The port runs one process per
device, where the reference runs one process over a host's local devices.
"""

from __future__ import annotations

import json
import os
import random
import socket
from dataclasses import dataclass
from datetime import timedelta
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

ENV_RESTART_ATTEMPT = "JOBSET_RESTART_ATTEMPT"
ENV_WORKLOAD = "JOBSET_WORKLOAD"

DEFAULT_COORDINATOR_PORT = 8476
# How long a rank waits for the rest of its gang, at the rendezvous and
# at each collective.
RENDEZVOUS_TIMEOUT_S = 300

# The control plane's label and annotation keys `pod_env_for` reads (the
# port's own copies of `jobset_tpu.api.keys`).
JOBSET_NAME_KEY = "jobset.sigs.k8s.io/jobset-name"
REPLICATED_JOB_NAME_KEY = "jobset.sigs.k8s.io/replicatedjob-name"
JOB_INDEX_KEY = "jobset.sigs.k8s.io/job-index"
JOB_GLOBAL_INDEX_KEY = "jobset.sigs.k8s.io/job-global-index"
RESTARTS_KEY = "jobset.sigs.k8s.io/restart-attempt"
COORDINATOR_KEY = "jobset.sigs.k8s.io/coordinator"
POD_COMPLETION_INDEX_KEY = "batch.kubernetes.io/job-completion-index"


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


def pod_env_for(cluster, pod) -> dict:
    """The rendezvous environment of a simulated pod, as a deployment's
    downward API would inject it (the reference's `pod_env_for`). `cluster`
    is taken duck-typed: `get_jobset(namespace, name)`, and the JobSet's
    `spec.replicated_jobs` (`name`, `replicas`, `template.spec.pods_expected()`)
    and `spec.network.subdomain`."""
    annotations = pod.annotations
    labels = pod.labels
    js = cluster.get_jobset(pod.metadata.namespace, annotations.get(JOBSET_NAME_KEY, ""))
    total = 0
    pods_per_job = 1
    process_offset = 0
    my_global_index = int(labels.get(JOB_GLOBAL_INDEX_KEY, "0"))
    if js is not None:
        global_index = 0
        for rjob in js.spec.replicated_jobs:
            expected = rjob.template.spec.pods_expected()
            for _ in range(int(rjob.replicas)):
                if global_index < my_global_index:
                    process_offset += expected
                global_index += 1
            total += int(rjob.replicas) * expected
            if rjob.name == labels.get(REPLICATED_JOB_NAME_KEY):
                pods_per_job = expected
    coordinator = annotations.get(COORDINATOR_KEY)
    if not coordinator and js is not None:
        # Default coordinator: pod 0 of job 0 of the first replicated job.
        network = js.spec.network
        subdomain = network.subdomain if network and network.subdomain else js.name
        first = js.spec.replicated_jobs[0].name if js.spec.replicated_jobs else ""
        coordinator = f"{js.name}-{first}-0-0.{subdomain}"

    env = {
        ENV_JOBSET_NAME: annotations.get(JOBSET_NAME_KEY, ""),
        ENV_REPLICATED_JOB: labels.get(REPLICATED_JOB_NAME_KEY, ""),
        ENV_JOB_INDEX: labels.get(JOB_INDEX_KEY, "0"),
        ENV_JOB_GLOBAL_INDEX: labels.get(JOB_GLOBAL_INDEX_KEY, "0"),
        ENV_POD_INDEX: annotations.get(POD_COMPLETION_INDEX_KEY, "0"),
        ENV_PODS_PER_JOB: str(pods_per_job),
        ENV_PROCESS_OFFSET: str(process_offset),
        ENV_TOTAL_PROCESSES: str(total),
        ENV_COORDINATOR: coordinator or "",
        ENV_RESTART_ATTEMPT: labels.get(RESTARTS_KEY, "0"),
    }
    if pod.spec.workload:
        env[ENV_WORKLOAD] = json.dumps(pod.spec.workload)
    return env


# Rendezvous ports are drawn from below the ephemeral ranges (Linux's
# default 32768-60999, IANA's 49152-65535). The kernel hands ports of
# those ranges to every `bind(0)` (gloo's own listeners) and to the source
# end of every `connect` (a store client retrying while its server starts),
# and one of them taking a port between `free_port` and the store's listen
# failed a gang with EADDRINUSE. A port below them is taken only by an
# explicit bind.
RENDEZVOUS_PORTS = range(16384, 32768)


def free_port() -> int:
    """A free TCP port on the loopback interface from RENDEZVOUS_PORTS,
    drawn at random and checked by binding it (no SO_REUSEADDR, so a port
    still in TIME_WAIT is passed over too), then released."""
    draw = random.SystemRandom()
    for _ in range(256):
        port = draw.choice(RENDEZVOUS_PORTS)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free loopback port in {RENDEZVOUS_PORTS}")


def default_backend(device) -> str:
    """"nccl" for the card, "gloo" for the CPU."""
    from ..device import resolve_device

    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(rank: Optional[RankInfo] = None, backend: Optional[str] = None,
               device=None) -> RankInfo:
    """Join the gang's process group: `init_process_group(backend,
    init_method=f"tcp://{coordinator}", rank=process_id,
    world_size=total_processes)`. `backend` defaults to `default_backend(device)`
    (the card unless the caller names the CPU; with no card and no named
    device it raises). A gang of one process is its own coordinator: it
    rendezvouses with itself on a free loopback port (nothing else has to
    find it). On the card the process takes card `process_id %
    device_count`."""
    import torch
    import torch.distributed as dist

    rank = rank if rank is not None else rank_from_env()
    if backend is None:
        backend = default_backend(device)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(rank.process_id % torch.cuda.device_count())
    if rank.total_processes == 1:
        address = f"127.0.0.1:{free_port()}"
    elif rank.coordinator:
        address = rank.coordinator_address
    else:
        raise ValueError(f"a gang of {rank.total_processes} processes needs a coordinator")
    dist.init_process_group(backend, init_method=f"tcp://{address}", rank=rank.process_id,
                            world_size=rank.total_processes,
                            timeout=timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    return rank


def shutdown() -> None:
    """Leave the gang: destroy the default process group, if any."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
