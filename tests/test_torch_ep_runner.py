"""Expert parallelism through the entry points a user runs, on the CPU
(gloo): `python -m jobset_tpu_torch.runtime.worker --cpu` as a gang whose
payload `mesh` names ep (dropless at ep 2; capacity top-2 at no drop at
(dp 2, ep 2)), a crashed ep gang resuming from its checkpoint (the
global state, gathered over ep and cut again), and `WorkloadRunner`
running a soft-dispatch payload at (ep 2, tp 2) as 4 processes to
Completed. Each is held against the port's single-process run of the
same payload, whose math these routers keep at any ep (the capacity
router at no drop): losses at rtol 1e-5, f32. Every join has a 180 s
limit that kills the processes."""

import os

import numpy as np
import pytest
import torch

from jobset_tpu_torch.runtime import WorkloadRunner

from test_torch_gang import (
    FINAL,
    LOSS_RTOL,
    _cluster_with,
    _example,
    _payload,
    _pod_envs,
    _run_workers,
    _single,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ep_payload(mesh, **config):
    payload = dict(_payload(), steps=3, mesh=mesh)
    payload["config"] = dict(payload["config"], moe_aux_coef=0.1, **config)
    return payload


@pytest.mark.parametrize("mesh, config", [
    ({"ep": 2}, {}),
    ({"dp": 2, "ep": 2}, {"moe_dispatch": "capacity", "moe_capacity_factor": 2.0}),
], ids=["dropless_ep2", "capacity_dp2_ep2"])
def test_worker_gang_trains_an_ep_payload(mesh, config):
    workload = _ep_payload(mesh, **config)
    n = int(np.prod(list(mesh.values())))
    codes, lines, errs = _run_workers(_pod_envs(n, workload))
    assert codes == [0] * n, errs[0][-3000:]
    want_mesh = {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 1, **mesh}
    for line in lines:
        assert line["world"] == n and line["mesh"] == want_mesh
        assert line["losses"] == lines[0]["losses"]
    np.testing.assert_allclose(lines[0]["losses"], _single(workload), rtol=LOSS_RTOL)


def test_crashed_ep_gang_resumes_from_its_checkpoint(tmp_path):
    """Dropless at ep 2, a checkpoint every 2 steps, every rank crashing
    at step 3: restarted, the gang resumes from step 2 (each rank's expert
    shard cut from the global checkpoint) with the losses of an
    uninterrupted run."""
    base = dict(_ep_payload({"ep": 2}), steps=5, checkpoint_every=2)
    uninterrupted = _single(dict(base, checkpoint_every=0))
    crashing = dict(base, checkpoint_dir=str(tmp_path / "ck"), fail_at_step=3)
    codes, lines, _ = _run_workers(_pod_envs(2, crashing))
    assert codes == [1, 1] and all("failed" in line for line in lines)
    assert sorted(os.listdir(tmp_path / "ck")) == ["2"]
    codes, lines, errs = _run_workers(_pod_envs(2, crashing), restarts=1)
    assert codes == [0, 0], errs[0][-3000:]
    assert lines[0]["steps"] == 3  # steps 2..4
    np.testing.assert_allclose(lines[0]["losses"], uninterrupted[2:], rtol=LOSS_RTOL)


def test_workload_runner_runs_an_ep_payload_to_completion():
    js = _example()
    spec = js.spec.replicated_jobs[0].template.spec.template.spec
    spec.workload = _ep_payload({"ep": 2, "tp": 2}, moe_top_k=0, moe_dispatch="capacity")
    cluster = _cluster_with(js)
    runner_ = WorkloadRunner(cluster, device="cpu")
    assert runner_.run_pending() == [js.name]
    live = cluster.get_jobset(js.metadata.namespace, js.name)
    assert live.status.terminal_state == "Completed"
    assert [r["mesh"]["ep"] for r in runner_.last_gang_results] == [2] * 4
    want = _single(spec.workload)
    np.testing.assert_allclose(float(live.metadata.annotations[FINAL]), want[-1], rtol=LOSS_RTOL)
