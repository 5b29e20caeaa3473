"""The port's solver sidecar against the JAX package's, on the CPU.

The frames must be byte for byte the reference's. End to end, the JAX
control plane (`SolverPlacement` with a `RemoteAssignmentSolver`) talks
over gRPC to the port's `SolverServer` holding a CPU `AssignmentSolver`,
places a gang and recovers it from a failure, and its pod placements must
equal those of the JAX control plane with the in-process JAX solver. The
client must have solved remotely and never fallen back to its local JAX
solver, or the comparison would prove nothing.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jobset_tpu.api import FailurePolicy
from jobset_tpu.core import features, make_cluster
from jobset_tpu.placement import service as jsvc
from jobset_tpu.placement.provider import SolverPlacement
from jobset_tpu.placement.solver import AssignmentSolver as JaxSolver
from jobset_tpu.testing import make_jobset, make_replicated_job
from jobset_tpu_torch.placement import service as tsvc
from jobset_tpu_torch.placement.solver import AssignmentSolver

REPO = Path(__file__).resolve().parent.parent
TOPOLOGY = "tpu-slice"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _problems():
    rng = np.random.default_rng(0)
    cost = rng.random((5, 9)).astype(np.float32)
    feasible = rng.random((5, 9)) > 0.3
    batch = rng.integers(0, 40, size=(3, 8, 12)).astype(np.float32)
    return [(cost, feasible), (cost, None), (batch, None), (batch, rng.random(batch.shape) > 0.2)]


@pytest.mark.parametrize("index", range(4))
def test_problem_frames_are_the_references(index):
    cost, feasible = _problems()[index]
    frame = tsvc.pack_problem(cost, feasible)
    assert frame == jsvc.pack_problem(cost, feasible)
    for unpack in (tsvc.unpack_problem, jsvc.unpack_problem):
        got_cost, got_feasible = unpack(frame)
        np.testing.assert_array_equal(got_cost, cost)
        np.testing.assert_array_equal(
            got_feasible, np.ones(cost.shape, bool) if feasible is None else feasible)


@pytest.mark.parametrize("assignment", [np.array([3, -1, 0, 7]), np.array([[1, 2], [-1, 0]])])
def test_assignment_frames_are_the_references(assignment):
    frame = tsvc.pack_assignment(assignment)
    assert frame == jsvc.pack_assignment(assignment)
    np.testing.assert_array_equal(tsvc.unpack_assignment(frame), assignment)
    np.testing.assert_array_equal(jsvc.unpack_assignment(frame), assignment)


def test_bad_frames_rejected():
    with pytest.raises(ValueError):
        tsvc.unpack_problem(b"\x00" * 32)
    with pytest.raises(ValueError):
        tsvc.unpack_assignment(b"\x00" * 32)
    with pytest.raises(ValueError):
        tsvc.pack_problem(np.zeros(4, np.float32), None)
    with pytest.raises(ValueError):
        tsvc.pack_problem(np.zeros((2, 3), np.float32), np.ones((3, 2), bool))
    with pytest.raises(ValueError):
        tsvc.pack_assignment(np.zeros((2, 2, 2), np.int64))


def test_service_handlers_answer_as_the_references():
    """The same frames through the port's handlers (CPU solver) and the
    reference's (JAX solver on the CPU) give the same reply bytes."""
    ours = tsvc.SolverService(solver=AssignmentSolver(device="cpu"))
    ref = jsvc.SolverService(solver=JaxSolver())
    frames = [tsvc.pack_problem(c, f) for c, f in _problems()]
    for frame in frames:
        assert ours.solve(frame, None) == ref.solve(frame, None)
    assert list(ours.solve_stream(iter(frames), None)) == list(ref.solve_stream(iter(frames), None))


def _gang_create_and_recovery(solver):
    """The gang of tests/test_solver_service.py:177-202 on 4 domains (with
    restarts allowed), then a failure of one job and the gang restart: each
    pod's domain after the create and after the recovery."""
    cluster = make_cluster(placement=SolverPlacement(solver=solver))
    cluster.add_topology(TOPOLOGY, num_domains=4, nodes_per_domain=2, capacity=4)
    js = (
        make_jobset("stream-js")
        .exclusive_placement(TOPOLOGY)
        .failure_policy(FailurePolicy(max_restarts=5))
        .replicated_job(make_replicated_job("w").replicas(2).parallelism(2).completions(2).obj())
        .obj()
    )

    def placements():
        return {p.metadata.name: p.spec.node_selector.get(TOPOLOGY)
                for p in cluster.pods.values() if p.spec.node_name}

    with features.gate("TPUPlacementSolver", True):
        cluster.create_jobset(js)
        cluster.run_until_stable()
        created = placements()
        cluster.fail_job("default", "stream-js-w-0")
        cluster.run_until_stable()
        recovered = placements()
    assert cluster.get_jobset("default", "stream-js").status.restarts == 1
    return created, recovered


def test_jax_control_plane_through_the_port_sidecar():
    server = tsvc.SolverServer("127.0.0.1:0", solver=AssignmentSolver(device="cpu")).start()
    remote = jsvc.RemoteAssignmentSolver(server.address)
    try:
        created, recovered = _gang_create_and_recovery(remote)
        # Both the create and the recovery solved in the port's sidecar.
        assert remote.remote_solves >= 2 and remote.local_fallbacks == 0
    finally:
        remote.close()
        server.stop(grace=0.1)
    want_created, want_recovered = _gang_create_and_recovery(JaxSolver())
    assert len(created) == 4 and len(set(created.values())) == 2
    assert created == want_created
    assert recovered == want_recovered


def test_sidecar_entry_serves_on_the_cpu():
    """`python -m jobset_tpu_torch.placement.service --cpu`: warms up, says
    where it listens, answers a remote solve, and stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "jobset_tpu_torch.placement.service", "--cpu",
         "--addr", "127.0.0.1:0"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("solver sidecar listening on "), (line, proc.stderr.read())
        remote = jsvc.RemoteAssignmentSolver(line.split()[-1], fallback_local=False)
        cost = np.random.default_rng(2).integers(0, 50, size=(12, 20)).astype(np.float32)
        np.testing.assert_array_equal(remote.solve(cost), JaxSolver().solve(cost))
        remote.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
