"""The port's runtime (optimizers, schedules, data, checkpoints, the LM
workload, the worker and the model bench) against the JAX package's, on
the CPU (the mlp and cnn kinds and the gang runner:
test_torch_workloads.py).

Tolerances: optimizer updates and parameters max|d| <= 1e-6 * max|ref| +
1e-9 (the same f32 formulas; optax evaluates schedules and bias
corrections in f32, the port in f64, which moves the last bit); workload
losses rtol 1e-5 (f32 through 2 layers and a few adamw steps); a resumed
run equals an uninterrupted one exactly.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from jobset_tpu.models import init_params as jax_init
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu.runtime import data as jdata
from jobset_tpu.runtime import runner as jrunner
from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.runtime import checkpoint, data, model_bench, optim, runner, worker

REPO = Path(__file__).resolve().parent.parent
SMALL = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "d_ff": 64, "n_layers": 2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=1e-6, atol=1e-9):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + atol


# ---------------------------------------------------------------------------
# Optimizers and schedules against optax
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": {"optimizer": "adamw"},
    "adamw_wd": {"optimizer": "adamw", "weight_decay": 0.1},
    "adam": {"optimizer": "adam"},
    "sgd": {"optimizer": "sgd"},
    "sgd_momentum": {"optimizer": "sgd", "momentum": 0.9},
    "adafactor": {"optimizer": "adafactor"},
}
SCHEDULES = {
    "constant": {},
    "warmup": {"warmup_steps": 3},
    "cosine": {"lr_schedule": "cosine", "warmup_steps": 2},
    "cosine_no_warmup": {"lr_schedule": "cosine"},
}


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax_over_five_updates(name, schedule):
    workload = {"steps": 5, "learning_rate": 0.05, **OPTIMIZERS[name], **SCHEDULES[schedule]}
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "inner": {"b": rng.standard_normal(3).astype(np.float32)}}
    jopt = jrunner.make_optimizer(workload, "adamw", 1e-3)
    topt = runner.make_optimizer(workload, "adamw", 1e-3)
    jparams = jax.tree.map(jax.numpy.asarray, params)
    tparams = params_from_jax(params)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(5):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        jupd, jstate = jopt.update(jax.tree.map(jax.numpy.asarray, grads), jstate, jparams)
        tupd, tstate = topt.update(params_from_jax(grads), tstate, tparams)
        for g, w in zip(tree.leaves(tupd), tree.leaves(jax.tree.map(np.asarray, jupd))):
            _close(g.numpy(), w)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        tparams = tree.tree_map(lambda p, u: p + u, tparams, tupd)
    assert tstate["count"] == 5


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_match_optax(schedule):
    workload = {"steps": 10, "learning_rate": 0.3, **SCHEDULES[schedule]}
    want = jrunner.make_learning_rate(workload, 1e-3)
    got = runner.make_learning_rate(workload, 1e-3)
    for n in range(12):
        w = want(n) if callable(want) else want
        g = got(n) if callable(got) else got
        assert abs(g - float(w)) <= 1e-6 * 0.3
    if schedule != "constant":
        assert got(0) == 0.0 or schedule == "cosine_no_warmup"


def test_warmup_first_update_leaves_params_where_they_were():
    opt = runner.make_optimizer({"optimizer": "adamw", "warmup_steps": 4}, "adamw", 1e-3)
    params = {"w": torch.ones(3)}
    updates, state = opt.update({"w": torch.full((3,), 0.5)}, opt.init(params), params)
    assert torch.equal(updates["w"], torch.zeros(3)) and state["count"] == 1


def test_sgd_without_momentum_keeps_no_trace():
    assert set(optim.sgd(0.1).init({"w": torch.ones(2)})) == {"count"}
    assert "trace" in optim.sgd(0.1, momentum=0.0).init({"w": torch.ones(2)})


@pytest.mark.parametrize("bad, error", [
    ({"optimizer": "lion"}, ValueError),
    ({"lr_schedule": "step"}, ValueError),
])
def test_make_optimizer_rejects(bad, error):
    with pytest.raises(error):
        runner.make_optimizer(bad, "adamw", 1e-3)


# ---------------------------------------------------------------------------
# Data and checkpoints
# ---------------------------------------------------------------------------


def test_token_dataset_windows_match_jax(tmp_path):
    path = str(tmp_path / "corpus.bin")
    jdata.write_token_file(path, np.random.default_rng(5).integers(0, 1000, 4000))
    for rank, world in ((0, 1), (1, 2)):
        want = jdata.TokenDataset(path, seq_len=16, batch_size=4, seed=7, rank=rank, world=world)
        got = data.TokenDataset(path, seq_len=16, batch_size=4, seed=7, rank=rank, world=world)
        for step in (0, 3, 11):
            w, g = want.batch(step), got.batch(step)
            assert set(g) == {"inputs", "targets"}
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])
    with pytest.raises(ValueError, match="vocab_size"):
        data.TokenDataset(path, seq_len=16, batch_size=4, vocab_size=10).batch(0)


def test_write_token_file_layout(tmp_path):
    path = tmp_path / "t.bin"
    data.write_token_file(str(path), [1, 2, 65535])
    assert path.read_bytes() == np.asarray([1, 2, 65535], np.uint16).tobytes()


def test_prefetching_fn_serves_steps_in_order():
    made = []

    def make(step):
        made.append(step)
        return {"x": np.full(2, step)}

    fetch = data.prefetching_fn(make, "cpu", prefetch=2, start=3, stop=6)
    assert made == []  # nothing is made before the first request
    assert fetch(3)["x"].tolist() == [3, 3]
    assert made == [3, 4, 5]  # the next two batches are in flight
    assert isinstance(fetch(4)["x"], torch.Tensor)
    with pytest.raises(ValueError, match="expected 5"):
        fetch(7)
    assert made == [3, 4, 5]


def test_checkpointer_keeps_the_newest_steps(tmp_path):
    ckpt = checkpoint.Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    for step in (1, 2, 3):
        ckpt.save(step, {"state": {"w": torch.full((2,), float(step))}, "step": step,
                         "count": step})
    assert ckpt.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["2", "3"]
    restored = ckpt.restore(step=2)
    assert restored["step"] == 2 and torch.equal(restored["state"]["w"], torch.full((2,), 2.0))
    ckpt.save(3, {"step": 30})  # a step saved again replaces the old one
    assert ckpt.restore()["step"] == 30


# ---------------------------------------------------------------------------
# The LM workload against the JAX package's
# ---------------------------------------------------------------------------


def _jax_params(workload):
    mesh = build_mesh(MeshConfig(), jax.devices()[:1], allow_submesh=True)
    cfg = jrunner_config(workload)
    return jax.tree.map(np.asarray, jax_init(jax.random.key(0), cfg, mesh))


def jrunner_config(workload):
    import jax.numpy as jnp

    from jobset_tpu.models import TransformerConfig

    overrides = dict(workload.get("config", {}))
    overrides.setdefault("dtype", jnp.float32)
    return TransformerConfig(**overrides)


def _use_jax_params(monkeypatch, workload):
    params = _jax_params(workload)
    monkeypatch.setattr(runner, "init_params",
                        lambda cfg, generator, device, mesh_config=None:
                        params_from_jax(params, device))


@pytest.mark.parametrize("payload", [
    {"optimizer": "adamw", "eval_every": 2, "eval_steps": 2},
    {"optimizer": "sgd", "momentum": 0.9, "learning_rate": 0.1, "lr_schedule": "cosine",
     "warmup_steps": 1, "accum_steps": 2},
], ids=["adamw_eval", "sgd_cosine_accum"])
def test_train_workload_matches_jax(monkeypatch, payload):
    workload = {"kind": "lm", "steps": 4, "batch_size": 4, "seq_len": 16,
                "config": dict(SMALL), **payload}
    mesh = build_mesh(MeshConfig(), jax.devices()[:1], allow_submesh=True)
    want = jrunner.train_workload(workload, mesh)
    _use_jax_params(monkeypatch, workload)
    got = runner.train_workload(workload, "cpu")
    np.testing.assert_allclose(list(got), list(want), rtol=1e-5)
    assert len(got.val_losses) == len(want.val_losses)
    for (gs, gl), (ws, wl) in zip(got.val_losses, want.val_losses):
        assert gs == ws
        np.testing.assert_allclose(gl, wl, rtol=1e-5)


def test_train_workload_on_a_token_file_matches_jax(tmp_path, monkeypatch):
    path = str(tmp_path / "corpus.bin")
    data.write_token_file(path, np.tile(np.arange(64), 40))
    workload = {"kind": "lm", "steps": 3, "batch_size": 2, "seq_len": 16,
                "data": {"path": path, "val_path": path}, "eval_every": 3,
                "config": dict(SMALL, remat=False)}
    mesh = build_mesh(MeshConfig(), jax.devices()[:1], allow_submesh=True)
    want = jrunner.train_workload(workload, mesh)
    _use_jax_params(monkeypatch, workload)
    got = runner.train_workload(workload, "cpu")
    np.testing.assert_allclose(list(got), list(want), rtol=1e-5)
    np.testing.assert_allclose(got.val_losses[0][1], want.val_losses[0][1], rtol=1e-5)


def test_checkpoint_resume_equals_an_uninterrupted_run(tmp_path):
    base = {"kind": "lm", "steps": 6, "batch_size": 2, "seq_len": 16,
            "config": dict(SMALL, dtype="float32")}
    straight = runner.train_workload(base, "cpu")
    crashing = dict(base, checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"),
                    fail_at_step=3)
    with pytest.raises(runner.WorkloadFailure, match="step 3"):
        runner.train_workload(crashing, "cpu")
    assert checkpoint.Checkpointer(str(tmp_path / "ck")).latest_step() == 2
    resumed = runner.train_workload(crashing, "cpu", restarts=1)
    assert len(resumed) == 4  # steps 2..5
    assert resumed == straight[2:]


# Every mesh axis runs as a gang of processes: train_workload without a
# mesh refuses a payload whose mesh spans several devices (ValueError),
# with zero1 too.
@pytest.mark.parametrize("bad, error", [
    ({"kind": "gan"}, ValueError),
    ({"kind": "lm", "zero1": True, "mesh": {"ep": 2}}, ValueError),
    ({"kind": "lm", "mesh": {"dp": 2}}, ValueError),
    ({"kind": "mlp", "mesh": {"dp": 2}}, ValueError),
    ({"kind": "cnn", "mesh": {"tp": 2}}, ValueError),
    ({"kind": "lm", "mesh": {"sp": 2}}, ValueError),
    ({"kind": "lm", "mesh": {"pp": 2}}, ValueError),
    ({"kind": "mlp", "mesh": {"ep": 2}}, ValueError),
])
def test_train_workload_rejects_what_is_not_ported(bad, error):
    with pytest.raises(error):
        runner.train_workload({"steps": 1, "config": dict(SMALL), **bad}, "cpu")


def test_lm_config_reads_dtype_strings():
    cfg = runner.lm_config({"config": {"dtype": "bfloat16"}})
    assert cfg.dtype == torch.bfloat16
    assert runner.lm_config({}).dtype == torch.float32


def test_profile_dir_writes_a_trace(tmp_path):
    workload = {"kind": "lm", "steps": 1, "batch_size": 2, "seq_len": 8,
                "config": dict(SMALL), "profile_dir": str(tmp_path / "prof")}
    runner.train_workload(workload, "cpu")
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# The worker and the model bench
# ---------------------------------------------------------------------------


def _write(tmp_path, workload):
    path = tmp_path / "workload.json"
    path.write_text(json.dumps(workload))
    return str(path)


def test_worker_runs_a_workload_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv(worker.ENV_RESTART_ATTEMPT, raising=False)
    workload = {"kind": "lm", "steps": 3, "batch_size": 2, "seq_len": 8,
                "config": dict(SMALL), "eval_every": 3, "eval_steps": 1}
    assert worker.main(["--workload-file", _write(tmp_path, workload), "--cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == 3 and result["world"] == 1 and result["process_id"] == 0
    assert np.isfinite(result["final_loss"]) and len(result["val_losses"]) == 1
    assert result["mesh"] == {"dp": 1, "pp": 1, "ep": 1, "sp": 1, "tp": 1}


def test_worker_exit_codes(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv(worker.ENV_WORKLOAD, raising=False)
    assert worker.main(["--cpu"]) == 2
    workload = {"kind": "lm", "steps": 3, "batch_size": 2, "seq_len": 8,
                "config": dict(SMALL), "fail_at_step": 1}
    monkeypatch.setenv(worker.ENV_WORKLOAD, json.dumps(workload))
    monkeypatch.setenv(worker.ENV_RESTART_ATTEMPT, "0")
    assert worker.main(["--cpu"]) == 1
    failed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "injected failure at step 1" in failed["failed"]
    monkeypatch.setenv(worker.ENV_RESTART_ATTEMPT, "1")
    assert worker.main(["--cpu"]) == 0


def test_worker_module_runs_as_a_program(tmp_path):
    workload = {"kind": "lm", "steps": 2, "batch_size": 2, "seq_len": 8, "config": dict(SMALL)}
    run = subprocess.run(
        [sys.executable, "-m", "jobset_tpu_torch.runtime.worker", "--workload-file",
         _write(tmp_path, workload), "--cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout.strip().splitlines()[-1])["steps"] == 2


def test_worker_refuses_a_gang_of_several_processes(tmp_path, monkeypatch):
    """Gangs of several processes run (tests/test_torch_gang.py); the
    worker refuses one, before any rendezvous, whose mesh names an axis
    the mesh does not have (TypeError) or does not cover the gang (exit
    2)."""
    from jobset_tpu_torch.runtime import distributed

    env = {distributed.ENV_JOBSET_NAME: "js", distributed.ENV_REPLICATED_JOB: "w",
           distributed.ENV_JOB_INDEX: "0", distributed.ENV_JOB_GLOBAL_INDEX: "0",
           distributed.ENV_PROCESS_OFFSET: "0", distributed.ENV_TOTAL_PROCESSES: "2",
           distributed.ENV_COORDINATOR: "js-w-0-0.js"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    workload = {"kind": "lm", "steps": 1, "config": dict(SMALL), "mesh": {"xp": 2}}
    with pytest.raises(TypeError, match="unexpected keyword argument 'xp'"):
        worker.main(["--workload-file", _write(tmp_path, workload), "--cpu"])
    workload["mesh"] = {"dp": 4}
    assert worker.main(["--workload-file", _write(tmp_path, workload), "--cpu"]) == 2


def test_rank_from_env_matches_jax():
    from jobset_tpu.runtime import distributed as jdist
    from jobset_tpu_torch.runtime import distributed

    env = {"JOBSET_NAME": "js", "JOBSET_REPLICATED_JOB": "w", "JOBSET_JOB_INDEX": "1",
           "JOBSET_JOB_GLOBAL_INDEX": "3", "JOBSET_POD_INDEX": "2",
           "JOBSET_PODS_PER_JOB": "4", "JOBSET_PROCESS_OFFSET": "12",
           "JOBSET_TOTAL_PROCESSES": "16", "JOBSET_COORDINATOR": "js-w-0-0.js"}
    got, want = distributed.rank_from_env(env), jdist.rank_from_env(env)
    assert got.__dict__ == want.__dict__
    assert (got.process_id, got.coordinator_address) == (want.process_id,
                                                         want.coordinator_address)
    with pytest.raises(KeyError, match="JOBSET_NAME"):
        distributed.rank_from_env({})
    rank = distributed.initialize(distributed.standalone_rank(), backend="gloo")
    try:
        assert rank.process_id == 0 and torch.distributed.get_world_size() == 1
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


def test_model_bench_on_the_cpu():
    cfg = model_bench.flagship_config(seq_len=16, vocab_size=64, d_model=32, n_heads=4,
                                      d_ff=64, n_layers=2, dtype=torch.float32)
    result = model_bench.run_model_bench(steps=2, warmup=1, batch=2, seq_len=16, config=cfg,
                                         device="cpu")
    assert result["device_kind"] == "cpu" and result["mfu_pct"] is None
    assert result["peak_memory_gb"] is None and len(result["losses"]) == 3
    assert all(np.isfinite(result["losses"])) and result["tokens_per_sec"] > 0
    assert result["flops_per_token"] == model_bench.train_flops_per_token(cfg, 16)


def test_flop_accounting_matches_jax():
    from jobset_tpu.models import TransformerConfig
    from jobset_tpu.runtime import model_bench as jbench

    for kw in ({}, {"n_kv_heads": 4}):
        jcfg = TransformerConfig(vocab_size=32000, d_model=1024, n_heads=16, d_ff=4096,
                                 n_layers=8, **kw)
        tcfg = model_bench.flagship_config(**kw)
        assert model_bench.matmul_param_count(tcfg) == jbench.matmul_param_count(jcfg)
        assert (model_bench.train_flops_per_token(tcfg, 1024)
                == jbench.train_flops_per_token(jcfg, 1024))


def test_peak_flops_table():
    assert model_bench.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert model_bench.peak_flops_for("NVIDIA A10G") is None
