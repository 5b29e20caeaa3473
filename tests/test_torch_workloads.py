"""The port's remaining single-device runtime against the JAX package's, on
the CPU: the MLP model, the `mlp`, `cnn` and default workload kinds,
`adafactor` against `optax.adafactor`, the simulator's `WorkloadRunner`
driving the JAX control plane's `Cluster`, and the worker on the new
kinds. Parameters come from the JAX `init_params`, converted by
`params_from_jax`; batches are numpy arrays from a seed.

Tolerances:
- MLP outputs, f32 losses and parameters: max|d| <= 1e-5 * max|ref| +
  1e-6 (the same f32 arithmetic, summed in another order); workload losses
  rtol 1e-5 (f32), and the loss annotations (6 decimals) the same.
- Adafactor updates: max|d| <= 1e-6 * max|ref| + 1e-9 per leaf, over 5
  updates (optax's formulas in f32; its decay is evaluated in f32 here
  too, the means and RMSs add in another order).
- bf16 CNN workloads: losses rtol 2e-2 (both frameworks round each bf16
  convolution's output; the gradients that feed adam differ at bf16's
  precision).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from jobset_tpu import api
from jobset_tpu.api import FailurePolicy, keys
from jobset_tpu.core import make_cluster
from jobset_tpu.models import cnn as jcnn
from jobset_tpu.models import mlp as jmlp
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu.runtime import WorkloadRunner as JaxWorkloadRunner
from jobset_tpu.runtime import runner as jrunner
from jobset_tpu.testing import make_jobset, make_replicated_job
from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import cnn as tcnn
from jobset_tpu_torch.models import mlp as tmlp
from jobset_tpu_torch.runtime import WorkloadRunner, optim, runner, worker
from jobset_tpu_torch.runtime.checkpoint import Checkpointer

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "training"
LOSS_RTOL, BF16_LOSS_RTOL = 1e-5, 2e-2
MLP_CKPT = {"d_in": 8, "d_hidden": 32, "d_out": 4}
SMALL_CNN = {"widths": [8, 16], "blocks_per_stage": 1, "groups": 4}
FINAL, INITIAL = "tpu.jobset.x-k8s.io/final-loss", "tpu.jobset.x-k8s.io/initial-loss"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + atol


def _one_device_mesh():
    return build_mesh(MeshConfig(), jax.devices()[:1], allow_submesh=True)


# ---------------------------------------------------------------------------
# The MLP model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_layers", [1, 2, 3])
def test_mlp_forward_matches_jax(n_layers):
    cfg = jmlp.MLPConfig(d_in=8, d_hidden=32, d_out=4, n_layers=n_layers)
    jparams = jmlp.init_params(jax.random.key(n_layers), cfg)
    x = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    want = np.asarray(jmlp.forward(jparams, jnp.asarray(x)))
    got = tmlp.forward(params_from_jax(jax.tree.map(np.asarray, jparams)), torch.from_numpy(x))
    _close(got.numpy(), want)
    # The ReLU sits between layers: the output takes negative values.
    assert (got < 0).any()


def test_mlp_init_matches_jax_tree():
    cfg = tmlp.MLPConfig(d_in=8, d_hidden=32, d_out=4, n_layers=3)
    got = tmlp.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jmlp.init_params(jax.random.key(0), jmlp.MLPConfig(**cfg.__dict__))
    assert sorted(got) == sorted(want) == ["layer_0", "layer_1", "layer_2"]
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    assert all(torch.equal(got[k]["b"], torch.zeros_like(got[k]["b"])) for k in got)


def test_mlp_loss_sums_the_output_columns():
    """sum((pred - y)^2) / rows: with d_out = 4, four times a mean over
    elements."""
    cfg = tmlp.MLPConfig(**MLP_CKPT)
    params = tmlp.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x, y = torch.randn(16, 8), torch.randn(16, 4)
    loss = tmlp.loss_fn(params, x, y)
    torch.testing.assert_close(loss, 4 * torch.nn.functional.mse_loss(tmlp.forward(params, x), y))


@pytest.mark.parametrize("name", ["adam", "adafactor"])
def test_mlp_train_steps_match_jax(name):
    jcfg = jmlp.MLPConfig(**MLP_CKPT)
    jparams = jmlp.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jopt = {"adam": optax.adam(1e-2), "adafactor": optax.adafactor(learning_rate=1e-2)}[name]
    topt = {"adam": optim.adam(1e-2), "adafactor": optim.adafactor(1e-2)}[name]
    jstep = jmlp.build_train_step(jcfg, _one_device_mesh(), jopt)
    tstep = tmlp.build_train_step(tmlp.MLPConfig(**MLP_CKPT), topt, "cpu")
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    rng = np.random.default_rng(1)
    for _ in range(3):
        x = rng.standard_normal((32, 8)).astype(np.float32)
        batch = {"x": x, "y": (x @ rng.standard_normal((8, 4))).astype(np.float32)}
        jparams, jstate, jl = jstep(jparams, jstate, jax.tree.map(jnp.asarray, batch))
        tparams, tstate, tl = tstep(tparams, tstate, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    for g, w in zip(tree.leaves(tparams), jax.tree.leaves(jparams)):
        _close(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# train_workload: the mlp, cnn and default kinds
# ---------------------------------------------------------------------------


def _use_jax_params(monkeypatch, workload):
    """The port's runner trains from the parameters the JAX runner draws."""
    kind = workload.get("kind", "mlp")
    if kind == "mlp":
        jparams = jmlp.init_params(jax.random.key(0),
                                   jmlp.MLPConfig(**workload.get("config", {})))
        module = tmlp
    else:
        overrides = {k: tuple(v) if k == "widths" else v
                     for k, v in workload.get("config", {}).items()}
        jparams = jcnn.init_params(jax.random.key(0), jcnn.CNNConfig(**overrides))
        module = tcnn
    converted = jax.tree.map(np.asarray, jparams)
    monkeypatch.setattr(module, "init_params",
                        lambda cfg, generator, device: params_from_jax(converted, device))


WORKLOADS = {
    "mlp": ({"kind": "mlp", "steps": 6, "config": MLP_CKPT}, LOSS_RTOL),
    "default_kind": ({"steps": 4}, LOSS_RTOL),
    "mlp_sgd_cosine": ({"kind": "mlp", "steps": 5, "optimizer": "sgd", "momentum": 0.9,
                        "learning_rate": 0.05, "lr_schedule": "cosine", "warmup_steps": 1,
                        "batch_size": 16, "config": MLP_CKPT}, LOSS_RTOL),
    "cnn_f32": ({"kind": "cnn", "steps": 3, "batch_size": 4, "image_size": 16,
                 "config": dict(SMALL_CNN, dtype="float32")}, LOSS_RTOL),
    "cnn_bf16": ({"kind": "cnn", "steps": 3, "batch_size": 4, "image_size": 16,
                  "config": SMALL_CNN}, BF16_LOSS_RTOL),
    "cnn_adafactor": ({"kind": "cnn", "steps": 3, "batch_size": 4, "image_size": 9,
                       "optimizer": "adafactor", "config": dict(SMALL_CNN, dtype="float32")},
                      LOSS_RTOL),
}


@pytest.mark.parametrize("name", WORKLOADS)
def test_train_workload_matches_jax(monkeypatch, name):
    workload, rtol = WORKLOADS[name]
    want = jrunner.train_workload(workload, _one_device_mesh())
    _use_jax_params(monkeypatch, workload)
    got = runner.train_workload(workload, "cpu")
    assert len(got) == len(want) == workload["steps"]
    np.testing.assert_allclose(list(got), list(want), rtol=rtol)


def test_mlp_and_cnn_streams_restart_on_resume(tmp_path):
    """The reference's mlp and cnn streams are one generator per run, drawn
    in step order: a resumed run restarts the stream, so its losses are not
    an uninterrupted run's (the LM's positional stream's are)."""
    base = {"kind": "mlp", "steps": 6, "config": MLP_CKPT}
    straight = runner.train_workload(base, "cpu")
    crashing = dict(base, checkpoint_every=2, checkpoint_dir=str(tmp_path), fail_at_step=3)
    with pytest.raises(runner.WorkloadFailure):
        runner.train_workload(crashing, "cpu")
    resumed = runner.train_workload(crashing, "cpu", restarts=1)
    assert len(resumed) == 4
    assert resumed[0] != straight[2]


def test_cnn_config_reads_json_fields():
    cfg = runner.cnn_config({"config": {"widths": [16, 32], "dtype": "float32"}})
    assert cfg.widths == (16, 32) and cfg.dtype == torch.float32
    assert runner.cnn_config({}).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Adafactor against optax.adafactor
# ---------------------------------------------------------------------------

FACTORED_SHAPES = {"wide": (256, 128), "tall": (128, 256), "tie": (128, 128),
                   "stacked": (1, 8, 256, 384), "unfactored": (4, 200), "vector": (300,),
                   "small_scale": (4, 3)}


@pytest.mark.parametrize("schedule", [{}, {"lr_schedule": "cosine", "warmup_steps": 2}],
                         ids=["constant", "cosine"])
def test_adafactor_matches_optax_on_factored_leaves(schedule):
    rng = np.random.default_rng(4)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in FACTORED_SHAPES.items()}
    params["small_scale"][:] = 1e-4  # block RMS below the 1e-3 floor
    workload = {"optimizer": "adafactor", "learning_rate": 0.01, "steps": 5, **schedule}
    jopt = jrunner.make_optimizer(workload, "adamw", 1e-3)
    topt = runner.make_optimizer(workload, "adamw", 1e-3)
    jparams, tparams = jax.tree.map(jnp.asarray, params), params_from_jax(params)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(5):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
        jupd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        tupd, tstate = topt.update(params_from_jax(grads), tstate, tparams)
        for key in sorted(params):
            _close(tupd[key].numpy(), np.asarray(jupd[key]), rtol=1e-6, atol=1e-9)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        tparams = tree.tree_map(lambda p, u: p + u, tparams, tupd)
    factored = jstate[0]
    for name in ("v_row", "v_col", "v"):
        for key in sorted(params):
            _close(tstate[name][key].numpy(), np.asarray(getattr(factored, name)[key]), rtol=1e-6,
                   atol=1e-30)
    assert tstate["count"] == 5


@pytest.mark.parametrize("shape", [(256, 128), (128, 256), (128, 128), (1, 8, 1024, 1024),
                                   (1, 8, 1024, 4096), (1, 8, 4096, 1024), (1, 8, 1024),
                                   (32000, 1024), (4, 200), (300,), (128, 127), (200, 3, 300)])
def test_factored_dims_match_optax(shape):
    from optax._src.factorized import _factored_dims

    assert optim.factored_dims(shape) == _factored_dims(shape, True, 128)


def test_lm_workload_with_adafactor_matches_jax(monkeypatch):
    """An LM whose embedding and layer weights are factored ([1, L, 128,
    128] ties, [1, L, 128, 256]) and whose norms are not."""
    from jobset_tpu.models import TransformerConfig, init_params as jax_lm_init

    workload = {"kind": "lm", "steps": 3, "batch_size": 2, "seq_len": 16,
                "optimizer": "adafactor", "learning_rate": 1e-2,
                "config": {"vocab_size": 256, "d_model": 128, "n_heads": 4, "d_ff": 256,
                           "n_layers": 2, "remat": False}}
    want = jrunner.train_workload(workload, _one_device_mesh())
    jparams = jax.tree.map(np.asarray, jax_lm_init(
        jax.random.key(0), TransformerConfig(dtype=jnp.float32, **workload["config"]),
        _one_device_mesh()))
    monkeypatch.setattr(runner, "init_params",
                        lambda cfg, generator, device, mesh_config=None:
                        params_from_jax(jparams, device))
    got = runner.train_workload(workload, "cpu")
    np.testing.assert_allclose(list(got), list(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# WorkloadRunner driving the JAX control plane's Cluster
# ---------------------------------------------------------------------------


def _workload_jobset(workload, name="train", max_restarts=3):
    return (make_jobset(name)
            .failure_policy(FailurePolicy(max_restarts=max_restarts))
            .replicated_job(make_replicated_job("workers").replicas(2).parallelism(2)
                            .completions(2).workload(workload).obj())
            .obj())


def _build(workload, **kwargs):
    cluster = make_cluster()
    cluster.add_topology("rack", num_domains=4, nodes_per_domain=4, capacity=16)
    js = cluster.create_jobset(_workload_jobset(workload, **kwargs))
    cluster.run_until_stable()
    return cluster, js, WorkloadRunner(cluster, device="cpu")


def test_runner_trains_mlp_to_completion():
    cluster, js, runner_ = _build({"kind": "mlp", "steps": 40})
    assert runner_.gang_ready(js)
    assert runner_.run_pending() == ["train"]
    assert js.status.terminal_state == keys.JOBSET_COMPLETED
    initial, final = (float(js.metadata.annotations[k]) for k in (INITIAL, FINAL))
    assert final < 0.5 * initial  # the regression converged


def test_runner_runs_once_per_incarnation_and_prunes_dead_uids():
    cluster, js, runner_ = _build({"kind": "mlp", "steps": 3})
    assert runner_.run_pending() == ["train"]
    assert runner_.run_pending() == []  # Completed: nothing more
    assert js.metadata.uid in runner_._ran_at
    cluster.delete_jobset(js.metadata.namespace, js.name)
    assert runner_.run_pending() == [] and runner_._ran_at == {}


def test_runner_crash_restart_resumes_from_checkpoint(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    cluster, js, runner_ = _build({"kind": "mlp", "steps": 12, "checkpoint_every": 2,
                                   "checkpoint_dir": ckpt_dir, "fail_at_step": 7})
    runner_.run_pending()  # fails at step 7, step 6 checkpointed
    assert js.status.restarts == 1 and js.status.terminal_state == ""
    assert Checkpointer(ckpt_dir).latest_step() == 6
    cluster.run_until_stable()
    assert runner_.run_pending() == ["train"]
    assert js.status.terminal_state == keys.JOBSET_COMPLETED
    assert Checkpointer(ckpt_dir).latest_step() == 12


def test_runner_crash_without_restart_budget_fails_the_jobset():
    cluster, js, runner_ = _build({"kind": "mlp", "steps": 10, "fail_at_step": 3},
                                  max_restarts=0)
    runner_.run_pending()
    assert js.status.terminal_state == keys.JOBSET_FAILED
    assert FINAL not in js.metadata.annotations


def test_runner_trains_an_lm_with_held_out_eval():
    cluster, js, runner_ = _build({
        "kind": "lm", "steps": 2, "batch_size": 2, "seq_len": 16, "eval_every": 2,
        "eval_steps": 1, "config": {"vocab_size": 64, "d_model": 32, "n_heads": 4, "d_ff": 64,
                                    "n_layers": 2, "remat": False}})
    runner_.run_pending()
    assert js.status.terminal_state == keys.JOBSET_COMPLETED
    assert np.isfinite(float(js.metadata.annotations["tpu.jobset.x-k8s.io/val-loss"]))


def test_runner_rejects_a_mesh_of_several_devices():
    # Every axis runs as a gang (tests/test_torch_gang.py); a mesh axis the
    # reference does not have raises before any process starts.
    cluster, js, runner_ = _build({"kind": "mlp", "steps": 2, "mesh": {"xp": 2}})
    with pytest.raises(TypeError, match="unexpected keyword argument 'xp'"):
        runner_.run_pending()


def _example(name, tmp_path=None):
    js = api.load_all((EXAMPLES / name).read_text())[0]
    if tmp_path is not None:
        js.spec.replicated_jobs[0].template.spec.template.spec.workload["checkpoint_dir"] = str(
            tmp_path)
    return js


def _run_example(js, runner_factory, topology):
    cluster = make_cluster()
    cluster.add_topology("pool", **topology)
    runner_ = runner_factory(cluster)
    cluster.create_jobset(js)
    cluster.run_until_stable()
    rounds = []
    for _ in range(3):
        rounds.append(runner_.run_pending())
        cluster.run_until_stable()
    return cluster.get_jobset(js.metadata.namespace, js.name), rounds


@pytest.mark.parametrize("example, topology, rtol", [
    ("mlp-checkpoint.yaml", dict(num_domains=2, nodes_per_domain=2, capacity=4), LOSS_RTOL),
    ("cnn-ddp.yaml", dict(num_domains=4, nodes_per_domain=2, capacity=8), BF16_LOSS_RTOL),
])
def test_runner_runs_the_example_to_completion_as_jax_does(monkeypatch, tmp_path, example,
                                                           topology, rtol):
    """mlp-checkpoint.yaml: fails at step 5, the gang restarts, the rerun
    resumes from step 4 and completes; cnn-ddp.yaml completes in one run.
    The loss annotations equal the JAX runner's on the same Cluster."""
    want, want_rounds = _run_example(
        _example(example, tmp_path / "jax"),
        lambda c: JaxWorkloadRunner(c, mesh=_one_device_mesh()), topology)
    workload = _example(example).spec.replicated_jobs[0].template.spec.template.spec.workload
    _use_jax_params(monkeypatch, workload)
    got, rounds = _run_example(_example(example, tmp_path / "port"),
                               lambda c: WorkloadRunner(c, device="cpu"), topology)
    assert got.status.terminal_state == want.status.terminal_state == keys.JOBSET_COMPLETED
    assert rounds == want_rounds
    assert got.status.restarts == want.status.restarts
    for key in (INITIAL, FINAL):
        np.testing.assert_allclose(float(got.metadata.annotations[key]),
                                   float(want.metadata.annotations[key]), rtol=rtol, atol=1e-6)
    if example.startswith("mlp"):
        assert rounds == [[got.name], [got.name], []] and got.status.restarts == 1
        assert Checkpointer(str(tmp_path / "port")).latest_step() == 10


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smokes_stand_in_cluster_runs_the_sequence_jax_runs(monkeypatch, tmp_path):
    """The card's check of mlp-checkpoint.yaml drives the port's runner over
    a stand-in cluster (the card's machine has no jobset_tpu). On the CPU it
    takes the real Cluster's course, and its annotations are the JAX
    runner's."""
    cs = _chip_smoke()
    assert cs.MLP_CHECKPOINT_PAYLOAD == {
        k: v for k, v in _example("mlp-checkpoint.yaml").spec.replicated_jobs[0]
        .template.spec.template.spec.workload.items() if k != "checkpoint_dir"}
    want, _ = _run_example(_example("mlp-checkpoint.yaml", tmp_path / "jax"),
                           lambda c: JaxWorkloadRunner(c, mesh=_one_device_mesh()),
                           dict(num_domains=2, nodes_per_domain=2, capacity=4))
    _use_jax_params(monkeypatch, cs.MLP_CHECKPOINT_PAYLOAD)
    seq = cs.mlp_checkpoint_sequence("cpu", str(tmp_path / "stand_in"))
    assert seq["ran"] == [["mlp-checkpoint"], ["mlp-checkpoint"], []]
    assert seq["after_first"] == (1, "") and seq["checkpoint_after_failure"] == 4
    assert (seq["terminal_state"], seq["restarts"], seq["latest_step"]) == ("Completed", 1, 10)
    for key in (INITIAL, FINAL):
        np.testing.assert_allclose(float(seq["annotations"][key]),
                                   float(want.metadata.annotations[key]), rtol=LOSS_RTOL)


def test_chip_smokes_cnn_flops_from_the_conv_shapes():
    """About 0.21 GFLOP an image forward for the default CNNConfig on
    32x32x3, and 81 GFLOP a train step at B=128."""
    cs = _chip_smoke()
    per_image = cs.cnn_conv_flops(tcnn.CNNConfig(), 32)
    assert per_image == 211_487_232
    assert round(3 * 128 * per_image / 1e9, 1) == 81.2


# ---------------------------------------------------------------------------
# The worker on the new kinds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", [
    {"kind": "mlp", "steps": 3, "config": MLP_CKPT},
    {"kind": "cnn", "steps": 2, "batch_size": 2, "image_size": 8, "config": SMALL_CNN},
    {"steps": 2},
], ids=["mlp", "cnn", "default_kind"])
def test_worker_runs_the_kind_on_the_cpu(tmp_path, capsys, monkeypatch, workload):
    monkeypatch.delenv(worker.ENV_RESTART_ATTEMPT, raising=False)
    path = tmp_path / "workload.json"
    path.write_text(json.dumps(workload))
    assert worker.main(["--workload-file", str(path), "--cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["steps"] == workload["steps"] and np.isfinite(result["final_loss"])
    assert set(result["kernel_launches"].values()) == {0}


# Every example workload through the port's gang runner: those whose
# payload names no mesh axis above 1 run to Completed in process (the
# runner stands in for the whole gang, as the JAX runner does over its
# mesh), the others as a gang of one worker process a device of the
# payload's mesh, on gloo: lm-moe-dropless.yaml ({dp: 2, tp: 2}),
# lm-long-context.yaml ({sp: 2, tp: 2}, Ulysses) and lm-pp-interleaved.yaml
# ({pp: 2, tp: 2}, the interleave, 4 microbatches) as 4, lm-adafactor.yaml
# ({dp: 2}, zero1) as 2. All ten complete.
EXAMPLE_OUTCOMES = {
    "mlp-checkpoint.yaml": "Completed", "cnn-ddp.yaml": "Completed",
    "ddp-exclusive.yaml": "Completed", "lm-dp.yaml": "Completed",
    "multislice.yaml": "Completed", "ps-heterogeneous.yaml": "Completed",
    "lm-moe-dropless.yaml": "Completed",
    "lm-adafactor.yaml": "Completed", "lm-long-context.yaml": "Completed",
    "lm-pp-interleaved.yaml": "Completed",
}


def test_example_outcomes_cover_every_example():
    assert sorted(EXAMPLE_OUTCOMES) == sorted(p.name for p in EXAMPLES.glob("*.yaml"))


@pytest.mark.parametrize("example", sorted(EXAMPLE_OUTCOMES))
def test_runner_on_each_example(tmp_path, example):
    js = _example(example)
    workload = js.spec.replicated_jobs[0].template.spec.template.spec.workload
    for rjob in js.spec.replicated_jobs:
        payload = rjob.template.spec.template.spec.workload
        if payload and "checkpoint_dir" in payload:
            payload["checkpoint_dir"] = str(tmp_path)
    cluster = make_cluster()
    # A gang placed exclusively per domain needs its topology label.
    key = js.metadata.annotations.get("alpha.jobset.sigs.k8s.io/exclusive-topology", "pool")
    cluster.add_topology(key, num_domains=8, nodes_per_domain=4, capacity=16)
    runner_ = WorkloadRunner(cluster, device="cpu")
    cluster.create_jobset(js)
    cluster.run_until_stable()
    outcome = EXAMPLE_OUTCOMES[example]
    for _ in range(3):
        runner_.run_pending()
        cluster.run_until_stable()
    live = cluster.get_jobset(js.metadata.namespace, js.name)
    assert live.status.terminal_state == outcome
    assert np.isfinite(float(live.metadata.annotations[FINAL]))
    devices = int(np.prod(list((workload.get("mesh") or {}).values())))
    if devices > 1:  # a gang: one worker process a device of the mesh
        assert len(runner_.last_gang_results) == devices
