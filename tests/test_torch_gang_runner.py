"""The simulator's `WorkloadRunner` running examples/training/lm-moe-dropless.yaml
(`{dp: 2, tp: 2}`) as a gang of 4 worker processes on the CPU (gloo), over
chip_smoke.py's stand-in cluster (phase 15 (d) runs the same on the
card): it completes, and its final-loss annotation is one process's
(rtol 1e-5, f32). test_torch_workloads.py runs it over the JAX control
plane's Cluster among every example. Also the gang launcher
(`runtime.gang.spawn`, whose wait the runner shares): the mesh's layouts
over a gang of four, and a failing rank failing its gang without waiting
for its peers.
"""

import importlib.util
import time

import numpy as np
import pytest
import torch

from jobset_tpu_torch.parallel import mesh
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies
from test_torch_gang import JOIN_S, LOSS_RTOL, REPO, _example, _payload, _single


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_chip_smokes_gang_runner_drives_the_example():
    """The card's phase 15 (d) runs lm-moe-dropless.yaml's payload through
    the port's runner over chip_smoke's stand-in cluster (the card's
    machine has no jobset_tpu): on the CPU it completes as a gang of 4
    with the final loss of one process."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rjob = _example().spec.replicated_jobs[0]
    assert cs.LM_MOE_DROPLESS_PAYLOAD == _payload()
    assert cs.LM_MOE_DROPLESS_GANG == (rjob.replicas, rjob.template.spec.parallelism)
    seq = cs.gang_runner_sequence("cpu", "gloo")
    assert seq["ran"] == ["lm-moe-dropless"] and seq["terminal_state"] == "Completed"
    assert sorted(r["process_id"] for r in seq["results"]) == [0, 1, 2, 3]
    np.testing.assert_allclose(float(seq["annotations"]["tpu.jobset.x-k8s.io/final-loss"]),
                               _single(_payload())[-1], rtol=LOSS_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", ["lm-adafactor", "lm-long-context", "lm-pp-interleaved"])
def test_chip_smokes_sp_examples_are_the_files(name):
    """Phase 16 (e) runs lm-adafactor.yaml and lm-long-context.yaml, and
    phase 17 (d) lm-pp-interleaved.yaml, through the port's runner over
    chip_smoke's stand-in cluster: their payloads and gangs are the files'
    (tests/test_torch_workloads.py runs them)."""
    from jobset_tpu import api

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    js = api.load_all((REPO / "examples" / "training" / f"{name}.yaml").read_text())[0]
    rjob = js.spec.replicated_jobs[0]
    payload, gang_shape = {**cs.SP_EXAMPLES, **cs.PP_EXAMPLES}[name]
    assert payload == rjob.template.spec.template.spec.workload
    assert gang_shape == (rjob.replicas, rjob.template.spec.parallelism)


def _check_layouts(got, grids):
    """Each rank's coordinates (None past a submesh) are its place in the
    grid, and each axis's group all-reduces over the ranks that share the
    rank's other coordinates; with dp and sp both above 1, so does the
    joint (dp, sp) group, and with two of dp, sp and pp above 1 the
    (dp, sp, pp) group."""
    for rank, layouts_ in enumerate(got):
        for grid, layout in zip(grids, layouts_):
            where = np.argwhere(grid == rank)
            if not len(where):
                assert layout is None  # past the submesh
                continue
            coords = dict(zip(mesh.AXIS_NAMES, where[0].tolist()))
            assert layout["coords"] == coords
            for axis, total in layout["sums"].items():
                axes = axis if isinstance(axis, tuple) else (axis,)
                line = [slice(None) if a in axes else coords[a] for a in mesh.AXIS_NAMES]
                assert total == float(grid[tuple(line)].sum())
            wide = {a for a, n in zip(mesh.AXIS_NAMES, grid.shape) if n > 1}
            assert set(layout["sums"]) == wide | {
                axes for axes in mesh.JOINT_AXES if len(set(axes) & wide) >= 2}


def test_mesh_layouts_over_a_gang_of_four():
    """build_mesh over every rank, on a prefix (allow_submesh: the ranks
    past it get None, and a too-small config without it raises), and
    build_multislice_mesh, as `_check_layouts` holds them."""
    layouts = [("mesh", {"dp": 2, "tp": 2}, False), ("mesh", {"tp": 2}, True),
               ("multislice", {"tp": 2}, {"dp": 2}), ("mesh", {"dp": 2, "sp": 2}, False)]
    got = gang.spawn(bodies.mesh_layouts, 4, (layouts, "cpu"), device="cpu", timeout_s=JOIN_S)
    _check_layouts(got, [
        mesh.rank_grid(mesh.MeshConfig(dp=2, tp=2)), mesh.rank_grid(mesh.MeshConfig(tp=2)),
        mesh.multislice_rank_grid(mesh.MeshConfig(tp=2), mesh.MeshConfig(dp=2)),
        mesh.rank_grid(mesh.MeshConfig(dp=2, sp=2))])
    with pytest.raises(RuntimeError, match="needs 2 devices, got 4"):
        gang.spawn(bodies.mesh_layouts, 4, ([("mesh", {"tp": 2}, False)], "cpu"), device="cpu",
                   timeout_s=JOIN_S)


def test_joint_group_on_a_submesh_keeps_the_gang_in_step():
    """A (dp 2, sp 2) submesh on a gang of 6: the two ranks past it make
    the joint group's process groups with the others, so the meshes built
    after it, over all six ranks, still agree on every group."""
    layouts = [("mesh", {"dp": 2, "sp": 2}, True), ("mesh", {"dp": 3, "sp": 2}, False),
               ("mesh", {"sp": 2, "tp": 3}, False)]
    got = gang.spawn(bodies.mesh_layouts, 6, (layouts, "cpu"), device="cpu", timeout_s=JOIN_S)
    _check_layouts(got, [mesh.rank_grid(mesh.MeshConfig(**shape)) for _, shape, _ in layouts])


def test_a_failing_rank_fails_the_gang_without_waiting_for_its_peers():
    """Rank 1 raises while rank 0 waits for it in an all-reduce: the gang
    fails with rank 1's traceback, well before the time limit (rank 0 is
    killed once the grace for a failed peer has passed)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of a gang of 2 failed(.|\n)*rank 1 fails"):
        gang.spawn(bodies.fail_on_rank, 2, (1,), device="cpu", timeout_s=JOIN_S)
    assert time.monotonic() - t0 < JOIN_S / 2
