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


def test_chip_smoke_fails_without_a_card():
    _no_cuda()
    run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout and '"kernels"' not in run.stdout


@pytest.mark.parametrize("entry_point", ["build_generate", "build_forward", "init_params",
                                         "build_train_step", "build_eval_step",
                                         "train_workload", "run_model_bench"])
def test_entry_points_without_device_raise(entry_point):
    from jobset_tpu_torch.models import decode, transformer
    from jobset_tpu_torch.runtime import model_bench, optim, runner

    _no_cuda()
    cfg = transformer.TransformerConfig(vocab_size=16, d_model=16, n_heads=2, d_ff=16,
                                        n_layers=1)
    call = {
        "build_generate": lambda: decode.build_generate(cfg, 2),
        "build_forward": lambda: transformer.build_forward(cfg),
        "init_params": lambda: transformer.init_params(cfg, torch.Generator()),
        "build_train_step": lambda: transformer.build_train_step(cfg, optim.sgd(0.1)),
        "build_eval_step": lambda: transformer.build_eval_step(cfg),
        "train_workload": lambda: runner.train_workload({"kind": "lm", "steps": 1}),
        "run_model_bench": lambda: model_bench.run_model_bench(steps=1, config=cfg),
    }[entry_point]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
