"""Crashed gangs on the CPU (gloo): a dp = 2 LM whose ranks crash at step
5 (every rank exits 1) resumes, as a restarted gang, from its step-4
checkpoint with the losses of an uninterrupted run; and the simulator's
`WorkloadRunner` fails a crashed gang's first child job and runs the
restarted gang (resuming from its checkpoint) to Completed. Losses at
rtol 1e-5, f32 (the same arithmetic, its sums split over ranks and added
in another order). Every join has a 180 s limit that kills the
processes.
"""

import os

import numpy as np
import pytest
import torch

from jobset_tpu_torch.runtime import WorkloadRunner

from test_torch_gang import (
    LOSS_RTOL,
    _cluster_with,
    _example,
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


def test_crashed_gang_resumes_from_its_checkpoint(tmp_path):
    """A dp = 2 LM checkpointing every 2 steps crashes at step 5 on every
    rank (exit 1, a "failed" line); restarted (attempt 1) it resumes from
    step 4, and its losses are those of an uninterrupted run (one process:
    the gang's equal them, test_worker_gang_on_the_example_payload)."""
    base = {"kind": "lm", "steps": 8, "batch_size": 4, "seq_len": 8, "mesh": {"dp": 2},
            "checkpoint_every": 2,
            "config": {"vocab_size": 64, "d_model": 32, "n_heads": 4, "d_ff": 64,
                       "n_layers": 2}}
    uninterrupted = _single(dict(base, checkpoint_every=0))

    crashing = dict(base, checkpoint_dir=str(tmp_path / "crash"), fail_at_step=5)
    codes, lines, _ = _run_workers(_pod_envs(2, crashing))
    assert codes == [1, 1] and all("failed" in line for line in lines)
    assert sorted(os.listdir(tmp_path / "crash")) == ["2", "4"]
    codes, lines, errs = _run_workers(_pod_envs(2, crashing), restarts=1)
    assert codes == [0, 0], errs[0][-3000:]
    assert lines[0]["steps"] == 4  # steps 4..7
    np.testing.assert_allclose(lines[0]["losses"], uninterrupted[4:], rtol=LOSS_RTOL)


def test_workload_runner_fails_the_gang_on_a_crash_and_restarts_it(tmp_path):
    js = _example()
    payload = js.spec.replicated_jobs[0].template.spec.template.spec.workload
    payload.update(steps=4, checkpoint_every=2, fail_at_step=3,
                   checkpoint_dir=str(tmp_path))
    cluster = _cluster_with(js)
    runner_ = WorkloadRunner(cluster, device="cpu")
    runner_.run_pending()  # every rank crashes at step 3: the first job fails
    live = cluster.get_jobset(js.metadata.namespace, js.name)
    assert live.status.restarts == 1 and not live.status.terminal_state
    for _ in range(3):
        runner_.run_pending()
        cluster.run_until_stable()
    assert live.status.terminal_state == "Completed"
    assert sorted(os.listdir(tmp_path)) == ["2", "4"]
