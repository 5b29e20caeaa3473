"""The port's gangs of processes through the entry points a user runs, on
the CPU (gloo): the per-pod worker (`python -m
jobset_tpu_torch.runtime.worker --cpu`) as 2 and 4 processes on
`examples/training/lm-moe-dropless.yaml`'s payload, with the rendezvous
environment of `pod_env_for` and a loopback coordinator; a mesh that
does not cover the gang exiting 2; a mesh axis the reference does not
have raising before anything starts. (tests/test_torch_gang_restart.py holds crashed
gangs, tests/test_torch_gang_state.py their state, and
tests/test_torch_gang_runner.py `WorkloadRunner` running the example as 4
processes to Completed, and the launcher's mesh layouts and failures; test_torch_workloads.py runs every example.)

Each gang is held against the port's own single-process run of the same
payload (same parameters, drawn from the same seed and cut to shards;
same batches): losses at rtol 1e-5, f32 (the same arithmetic, its sums
split over ranks and added in another order; the parity with the JAX
shard_map step is tests/test_torch_tp*.py's). Every join has a 180 s
limit that kills the processes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jobset_tpu import api
from jobset_tpu.core import make_cluster
from jobset_tpu_torch.runtime import WorkloadRunner, distributed, gang, runner

import torch_gang_bodies as bodies

REPO = Path(__file__).resolve().parent.parent
EXAMPLE = REPO / "examples" / "training" / "lm-moe-dropless.yaml"
LOSS_RTOL = 1e-5
FINAL = "tpu.jobset.x-k8s.io/final-loss"
JOIN_S = 180


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _example():
    return api.load_all(EXAMPLE.read_text())[0]


def _payload():
    return _example().spec.replicated_jobs[0].template.spec.template.spec.workload


def _cluster_with(js):
    cluster = make_cluster()
    cluster.add_topology("pool", num_domains=8, nodes_per_domain=4, capacity=16)
    cluster.create_jobset(js)
    cluster.run_until_stable()
    return cluster


def _pod_envs(n, workload):
    """The rendezvous env of the first n pods of the example's gang (a JobSet
    of n pods), by process id, with a loopback coordinator."""
    js = _example()
    rjob = js.spec.replicated_jobs[0]
    rjob.replicas = 1 if n <= 2 else 2
    rjob.template.spec.parallelism = rjob.template.spec.completions = 2 if n > 1 else 1
    rjob.template.spec.template.spec.workload = workload
    cluster = _cluster_with(js)
    envs = sorted((distributed.pod_env_for(cluster, pod) for pod in cluster.pods.values()),
                  key=lambda e: int(e[distributed.ENV_PROCESS_OFFSET])
                  + int(e[distributed.ENV_POD_INDEX]))
    assert len(envs) == n and [int(e[distributed.ENV_TOTAL_PROCESSES]) for e in envs] == [n] * n
    coordinator = f"127.0.0.1:{distributed.free_port()}"
    return [{**e, distributed.ENV_COORDINATOR: coordinator} for e in envs]


def _run_workers(envs, restarts=0):
    """Run the worker once per env; (exit codes, result lines, stderr)."""
    procs = []
    for env in envs:
        full = {**os.environ, **env, distributed.ENV_RESTART_ATTEMPT: str(restarts)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "jobset_tpu_torch.runtime.worker", "--cpu"], cwd=REPO,
            env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=JOIN_S))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    lines = [json.loads(out.strip().splitlines()[-1]) if out.strip() else None for out, _ in outs]
    return [p.returncode for p in procs], lines, [err for _, err in outs]


def _single(workload):
    """The same payload in this process, on one device."""
    return list(runner.train_workload({k: v for k, v in workload.items() if k != "mesh"}, "cpu"))


@pytest.mark.parametrize("n", [2, 4])
def test_worker_gang_on_the_example_payload(n):
    """2 processes: no mesh in the payload, so the default factoring takes
    tp = 2; 4: the example's {dp: 2, tp: 2}. Every rank reports the whole
    gang and the global losses, equal to one process's."""
    workload = dict(_payload(), steps=3)
    if n == 2:
        del workload["mesh"]
    codes, lines, errs = _run_workers(_pod_envs(n, workload))
    assert codes == [0] * n, errs[0][-3000:]
    want_mesh = {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 2} if n == 2 else \
        {"dp": 2, "pp": 1, "ep": 1, "sp": 1, "tp": 2}
    assert sorted(line["process_id"] for line in lines) == list(range(n))
    for line in lines:
        assert line["world"] == n and line["devices"] == n and line["mesh"] == want_mesh
        assert line["losses"] == lines[0]["losses"]
        assert set(line["kernel_launches"].values()) == {0}  # the CPU runs no kernel
    np.testing.assert_allclose(lines[0]["losses"], _single(workload), rtol=LOSS_RTOL)


@pytest.mark.parametrize("n, mesh", [(2, {"dp": 4}), (1, {"tp": 2}), (4, {"dp": 2})])
def test_a_mesh_that_does_not_cover_the_gang_exits_2(n, mesh):
    workload = dict(_payload(), mesh=mesh)
    envs = _pod_envs(n, workload) if n > 1 else [{distributed.ENV_WORKLOAD: json.dumps(workload)}]
    codes, lines, errs = _run_workers(envs)
    assert codes == [2] * n
    assert all("size the mesh to the gang" in err for err in errs)


def test_runner_raises_before_spawning_on_what_is_not_ported():
    js = _example()
    payload = js.spec.replicated_jobs[0].template.spec.template.spec.workload
    payload["zero1"] = True
    payload["mesh"] = {"dp": 2, "xp": 2}
    runner_ = WorkloadRunner(_cluster_with(js), device="cpu")
    with pytest.raises(TypeError, match="unexpected keyword argument 'xp'"):
        runner_.run_pending()


def test_gang_entry_points_without_device_raise():
    """The rendezvous and the gang launcher name their device: with no card
    and no named device they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.initialize(distributed.standalone_rank())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.default_backend(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gang.spawn(bodies.fail_on_rank, 1, (0,))

