"""The port's boundary: it imports no JAX and nothing of jobset_tpu, and
its entry points do not fall back to the CPU when no device is named."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "optax", "jobset_tpu")


def _port_files():
    return sorted((REPO / "jobset_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def test_port_files_exist():
    files = _port_files()
    assert all(f.exists() for f in files)
    assert len(files) >= 10


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_prefix_match_allows_the_port_itself():
    assert not _forbidden("jobset_tpu_torch.ops")
    assert _forbidden("jobset_tpu.ops") and _forbidden("jax.numpy") and _forbidden("jobset_tpu")


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")


def test_entry_without_device_raises():
    from jobset_tpu_torch.entry import entry

    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_worker_without_cpu_flag_raises(tmp_path):
    _no_cuda()
    path = tmp_path / "w.json"
    path.write_text('{"kind": "lm", "steps": 1}')
    run = subprocess.run([sys.executable, "-m", "jobset_tpu_torch.runtime.worker",
                          "--workload-file", str(path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "no CUDA device" in run.stderr


def test_worker_without_cpu_flag_raises_on_the_default_kind(tmp_path):
    _no_cuda()
    path = tmp_path / "w.json"
    path.write_text('{"steps": 1}')  # no kind: "mlp"
    run = subprocess.run([sys.executable, "-m", "jobset_tpu_torch.runtime.worker",
                          "--workload-file", str(path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode != 0 and "no CUDA device" in run.stderr


def test_chip_smoke_workloads_only_fails_without_a_card():
    _no_cuda()
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--workloads-only"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and "nothing was run" in run.stderr


def test_chip_smoke_fails_without_a_card():
    _no_cuda()
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout and '"kernels"' not in run.stdout


@pytest.mark.parametrize("entry_point", ["build_generate", "build_generate_int8_sampled",
                                         "build_forward", "init_params",
                                         "build_train_step", "build_eval_step",
                                         "train_workload", "run_model_bench",
                                         "run_decode_bench",
                                         "AssignmentSolver", "solver_service",
                                         "queue_score", "job_counts", "policy_score",
                                         "PolicyMLP", "policy_train",
                                         "train_bundles_to_checkpoint", "policy_train_main",
                                         "WorkloadRunner", "mlp_init_params",
                                         "mlp_build_train_step", "cnn_init_params",
                                         "cnn_build_train_step", "train_workload_mlp",
                                         "train_workload_cnn", "train_workload_zero1",
                                         "train_workload_sp", "train_workload_pp",
                                         "init_params_pp", "build_train_step_1f1b",
                                         "build_eval_step_interleaved"])
def test_entry_points_without_device_raise(entry_point, tmp_path):
    from dataclasses import replace

    import numpy as np

    from jobset_tpu_torch.core import columnar
    from jobset_tpu_torch.parallel.mesh import MeshConfig
    from jobset_tpu_torch.models import cnn, decode, mlp, transformer
    from jobset_tpu_torch.placement import service, solver
    from jobset_tpu_torch.policy import dataset, features, model, train
    from jobset_tpu_torch.queue import scorer
    from jobset_tpu_torch.runtime import model_bench, optim, runner

    _no_cuda()
    cfg = transformer.TransformerConfig(vocab_size=16, d_model=16, n_heads=2, d_ff=16,
                                        n_layers=1)
    piped = transformer.TransformerConfig(vocab_size=16, d_model=16, n_heads=2, d_ff=16,
                                          n_layers=2, n_microbatches=2)
    n_candidates = 0  # even a snapshot with nothing to score names its device
    policy_model = model.PolicyModel(model.init_params(0), np.zeros(16, np.float32),
                                     np.ones(16, np.float32), 0.0, 1.0)
    corpus = dataset.Dataset(np.zeros((4, 16), np.float32), np.ones(4, np.float32),
                             features.DomainHistory())
    call = {
        "build_generate": lambda: decode.build_generate(cfg, 2),
        "build_generate_int8_sampled": lambda: decode.build_generate(
            cfg, 2, temperature=0.9, top_k=4, quantized=True, quantized_kv=True),
        "build_forward": lambda: transformer.build_forward(cfg),
        "init_params": lambda: transformer.init_params(cfg, torch.Generator()),
        "build_train_step": lambda: transformer.build_train_step(cfg, optim.sgd(0.1)),
        "build_eval_step": lambda: transformer.build_eval_step(cfg),
        "train_workload": lambda: runner.train_workload({"kind": "lm", "steps": 1}),
        "run_model_bench": lambda: model_bench.run_model_bench(steps=1, config=cfg),
        "run_decode_bench": lambda: model_bench.run_decode_bench(
            batch=1, prompt_len=2, max_new_tokens=1, config=cfg, quantized=True),
        "AssignmentSolver": lambda: solver.AssignmentSolver(),
        "solver_service": lambda: service.main(["--addr", "127.0.0.1:0"]),
        "queue_score": lambda: scorer.score(scorer.Snapshot(
            ["r"], ["q"], np.ones((1, 1), np.float32), np.ones((1, 1), bool),
            np.zeros((1, 1), np.float32), np.ones(1, np.float32), np.full(1, -1, np.int32), 0,
            np.zeros((n_candidates, 1), np.float32), np.zeros(n_candidates, np.int32))),
        "job_counts": lambda: columnar.job_counts(np.zeros(4, np.int32), np.zeros(4, np.int32),
                                                  np.zeros(4, np.int8), 4),
        "policy_score": lambda: model.score(policy_model, np.zeros((3, 16), np.float32)),
        "PolicyMLP": lambda: model.PolicyMLP(policy_model.params),
        "policy_train": lambda: train.train(corpus),
        "train_bundles_to_checkpoint": lambda: train.train_bundles_to_checkpoint(
            str(tmp_path), str(tmp_path / "out.npz")),
        "policy_train_main": lambda: train.main(["--bundles", str(tmp_path),
                                                 "--out", str(tmp_path / "out.npz")]),
        "WorkloadRunner": lambda: runner.WorkloadRunner(object()),
        "mlp_init_params": lambda: mlp.init_params(mlp.MLPConfig(), torch.Generator()),
        "mlp_build_train_step": lambda: mlp.build_train_step(mlp.MLPConfig(), optim.sgd(0.1)),
        "cnn_init_params": lambda: cnn.init_params(cnn.CNNConfig(), torch.Generator()),
        "cnn_build_train_step": lambda: cnn.build_train_step(cnn.CNNConfig(),
                                                             optim.adafactor(0.1)),
        "train_workload_mlp": lambda: runner.train_workload({"steps": 1}),
        "train_workload_cnn": lambda: runner.train_workload({"kind": "cnn", "steps": 1}),
        "train_workload_zero1": lambda: runner.train_workload(
            {"kind": "lm", "steps": 1, "zero1": True}),
        "train_workload_sp": lambda: runner.train_workload(
            {"kind": "lm", "steps": 1, "mesh": {"sp": 2}, "config": {"attn_impl": "ulysses"}}),
        "train_workload_pp": lambda: runner.train_workload(
            {"kind": "lm", "steps": 1, "mesh": {"pp": 2},
             "config": {"n_microbatches": 4, "pipeline_schedule": "1f1b"}}),
        "init_params_pp": lambda: transformer.init_params(
            piped, torch.Generator(), mesh_config=MeshConfig(pp=2)),
        "build_train_step_1f1b": lambda: transformer.build_train_step(
            replace(piped, pipeline_schedule="1f1b"), optim.sgd(0.1)),
        "build_eval_step_interleaved": lambda: transformer.build_eval_step(
            replace(piped, pipeline_schedule="interleaved", pipeline_virtual=2)),
    }[entry_point]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_solver_ping_that_raises_raises():
    """A card that cannot move 32 bytes is a fault to report: the routing
    ping raises, caches nothing, and the solve it was routing raises too,
    instead of going to the host. (The device index past the last card
    fails on any machine.)"""
    import numpy as np

    from jobset_tpu_torch.placement.solver import AssignmentSolver

    s = AssignmentSolver(device=f"cuda:{torch.cuda.device_count()}")
    with pytest.raises((RuntimeError, AssertionError)):
        s._ping_default_device()
    assert s._accel_rtt_s is None
    with pytest.raises((RuntimeError, AssertionError)):
        s.solve(np.zeros((4, 4), np.float32))
    assert s.routes == {"cuda": 0, "cpu": 0}


def test_policy_train_module_without_cpu_flag_raises(tmp_path):
    _no_cuda()
    run = subprocess.run([sys.executable, "-m", "jobset_tpu_torch.policy.train",
                          "--bundles", str(tmp_path), "--out", str(tmp_path / "o.npz")],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode != 0 and "no CUDA device" in run.stderr


def test_backend_label_does_not_bring_the_card_up():
    """Before any CUDA use the label is "unloaded", and asking for it
    initializes nothing."""
    from jobset_tpu_torch.device import backend_label

    code = ("import torch\n"
            "from jobset_tpu_torch.device import backend_label\n"
            "label = backend_label()\n"
            "print(label, torch.cuda.is_initialized())\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["unloaded", "False"]
    if not torch.cuda.is_initialized():
        assert backend_label() == "unloaded"
