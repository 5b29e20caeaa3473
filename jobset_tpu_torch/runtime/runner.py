"""The workload plane's training engine: the counterpart of
`jobset_tpu/runtime/runner.py` (`train_workload`, what it runs, and the
simulator's `WorkloadRunner`), on one device or as one rank of a gang.

Workload payload (a pod template's `spec.workload`), as the JAX package
reads it:
    {"kind": "lm" | "mlp" | "cnn",  # model family; "mlp" when absent
     "steps": 20, "batch_size": 4, "seq_len": 16, "image_size": 32,
     "checkpoint_every": 5, "checkpoint_dir": "...",   # 0 = none
     "fail_at_step": 7,            # raise once, on restart attempt 0
     "eval_every": 0, "eval_steps": 2,
     "data": {"path": "...", "val_path": "...", "dtype": "uint16", "seed": 0},
     "optimizer": "adamw" | "adam" | "sgd" | "adafactor",
     "learning_rate": 1e-3, "weight_decay": 1e-4,
     "momentum": null, "lr_schedule": "constant" | "cosine", "warmup_steps": 0,
     "accum_steps": 1,
     "profile_dir": "...",         # a torch.profiler trace of the run
     "config": {...}}              # model config overrides

An LM computes in f32 unless the config names another dtype ("float32" or
"bfloat16" as a JSON string; a CNN config may name one too). LM synthetic
batches (no data.path) come from np.random.default_rng((17, step)), eval
batches from (29, ...), so a resumed run sees what an uninterrupted one
would. The "mlp" and "cnn" streams are the reference's: one
np.random.default_rng(0) per run, drawn in step order (the MLP draws its
true weights first), so a resumed run restarts the stream from its start.
Every kind's parameters are drawn from a CPU generator seeded 0 whatever
the device, so a run (or a gang) on the card starts where the CPU's does.
A restart resumes from the latest checkpoint.

As one rank of a gang (`train_workload(workload, device, mesh)`, the
mesh over the gang's processes): an LM's full parameters are drawn as
above and cut to the rank's tp and ep shards of its pp stage; each rank
takes the rows of its dp coordinate and the positions of its sp
coordinate of every batch (its ep, tp and pp peers take the same: the
batch is replicated over them, as the reference's P("dp", "sp") is),
from the same positional stream, so a resumed gang
still sees the batches of an uninterrupted one; `"zero1": true` splits an
LM's optimizer state over dp (`optim.zero1`); the mlp and cnn kinds split
their batch over dp and replicate over the other axes; a checkpoint holds
the global state, so it restores with or without zero1.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..convert import shard_params
from ..device import resolve_device
from ..models import cnn, mlp
from ..models.transformer import (
    TransformerConfig,
    build_eval_step,
    build_train_step,
    global_shapes,
    init_params,
    param_specs,
)
from ..parallel.mesh import MeshConfig, single_device_mesh
from . import distributed, optim
from .checkpoint import Checkpointer
from .data import TokenDataset, place_batch, prefetching_fn, sequence_shard
from .gang import wait_or_kill

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class WorkloadFailure(Exception):
    """Raised by a workload to simulate a training crash."""


def make_learning_rate(workload: dict, default_lr: float) -> optim.LearningRate:
    """Learning rate (a float or a schedule) from `learning_rate`,
    `lr_schedule` ("constant" | "cosine") and `warmup_steps` (linear warmup
    from 0, under either schedule)."""
    lr = float(workload.get("learning_rate", default_lr))
    warmup = int(workload.get("warmup_steps", 0))
    schedule = workload.get("lr_schedule", "constant")
    total = int(workload.get("steps", 10))
    if schedule == "cosine":
        return optim.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=warmup,
            decay_steps=max(total, warmup + 1), end_value=0.0,
        )
    if schedule != "constant":
        raise ValueError(f"unknown lr_schedule: {schedule!r}")
    if warmup:
        return optim.linear_schedule(0.0, lr, warmup)
    return lr


def make_optimizer(workload: dict, default: str, default_lr: float, specs=None,
                   mesh=None) -> optim.Optimizer:
    """Optimizer from `optimizer` ("adamw" | "adam" | "sgd" | "adafactor"),
    `weight_decay` (adamw) and `momentum` (sgd), with the learning rate of
    `make_learning_rate`; adafactor over a sharded tree takes its specs
    and the mesh."""
    lr = make_learning_rate(workload, default_lr)
    name = workload.get("optimizer", default)
    if name == "adamw":
        return optim.adamw(lr, weight_decay=float(workload.get("weight_decay", 1e-4)))
    if name == "adam":
        return optim.adam(lr)
    if name == "sgd":
        m = workload.get("momentum")
        return optim.sgd(lr, momentum=float(m) if m is not None else None)
    if name == "adafactor":
        return optim.adafactor(lr, specs, mesh)
    raise ValueError(f"unknown optimizer {name!r} (expected adamw | adam | sgd | adafactor)")


class TrainResult(list):
    """Per-step train losses, plus the held-out eval history as
    `.val_losses` ([(step, loss), ...])."""

    def __init__(self, losses=(), val_losses=()):
        super().__init__(losses)
        self.val_losses = list(val_losses)


@contextlib.contextmanager
def profiled(profile_dir, device):
    """A torch.profiler trace of the block, written to
    <profile_dir>/trace.json (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def _run_loop(workload, state, train_step, make_batch, device, restarts: int = 0,
              eval_fn=None, mesh=None, specs=None) -> TrainResult:
    """Restore -> steps (eval and checkpoint cadence) -> losses. Over a
    gang (`mesh`, with the state's `specs`) the checkpoint holds the global
    state."""
    every = int(workload.get("checkpoint_every", 0))
    ckpt = (Checkpointer(workload["checkpoint_dir"], mesh=mesh, specs=specs)
            if every > 0 else None)
    total_steps = int(workload.get("steps", 10))
    fail_at = workload.get("fail_at_step")
    start = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        restored = ckpt.restore(map_location=device)
        state, start = restored["state"], int(restored["step"])

    fetch = prefetching_fn(make_batch, device, start=start, stop=total_steps)
    profile_dir = workload.get("profile_dir")
    profiler = profiled(profile_dir, device) if profile_dir else contextlib.nullcontext()

    losses, val_losses = [], []
    eval_every = int(workload.get("eval_every", 0))
    try:
        with profiler:
            for step in range(start, total_steps):
                if fail_at is not None and restarts == 0 and step == int(fail_at):
                    raise WorkloadFailure(f"injected failure at step {step}")
                params, opt_state, loss = train_step(
                    state["params"], state["opt_state"], fetch(step)
                )
                state = {"params": params, "opt_state": opt_state}
                losses.append(float(loss))
                if eval_fn is not None and eval_every and (step + 1) % eval_every == 0:
                    val_losses.append((step + 1, eval_fn(params, step + 1)))
                if ckpt is not None and (step + 1) % every == 0:
                    ckpt.save(step + 1, {"state": state, "step": step + 1})
    finally:
        if ckpt is not None:
            ckpt.close()
    return TrainResult(losses, val_losses)


def _with_dtypes(overrides: dict) -> dict:
    """Config overrides with "float32"/"bfloat16" strings made torch dtypes."""
    return {k: _DTYPES[v] if k in ("dtype", "param_dtype") and isinstance(v, str) else v
            for k, v in overrides.items()}


def lm_config(workload: dict) -> TransformerConfig:
    """The workload's TransformerConfig: f32 compute unless the payload's
    config names a dtype (a torch dtype, or "float32"/"bfloat16")."""
    overrides = _with_dtypes(dict(workload.get("config", {})))
    overrides.setdefault("dtype", torch.float32)
    return TransformerConfig(**overrides)


def cnn_config(workload: dict) -> cnn.CNNConfig:
    """The workload's CNNConfig: `widths` (a JSON list) as a tuple, dtype
    strings as torch dtypes."""
    overrides = _with_dtypes(dict(workload.get("config", {})))
    if "widths" in overrides:
        overrides["widths"] = tuple(overrides["widths"])
    return cnn.CNNConfig(**overrides)


def batch_rows(batch_size: int, dp: int, index: int, accum_steps: int = 1) -> np.ndarray:
    """The global batch's rows that dp rank `index` holds: of each of the
    `accum_steps` chunks (consecutive row blocks, the reference's
    accumulation chunks) its dp block, so that chunk k of the rank's rows
    is its share of the reference's chunk k."""
    if batch_size % (dp * accum_steps):
        raise ValueError(f"batch_size {batch_size} not divisible by dp {dp} x accum_steps "
                         f"{accum_steps}")
    chunk, share = batch_size // accum_steps, batch_size // (dp * accum_steps)
    return np.concatenate([np.arange(k * chunk + index * share, k * chunk + (index + 1) * share)
                           for k in range(accum_steps)])


def _dp_rows(batch_size: int, mesh, accum_steps: int = 1) -> np.ndarray:
    """This rank's rows of a global batch (`batch_rows`)."""
    return batch_rows(batch_size, mesh.size("dp"), mesh.index("dp"), accum_steps)


def _setup_mlp(workload: dict, device, mesh):
    cfg = mlp.MLPConfig(**workload.get("config", {}))
    params = mlp.init_params(cfg, torch.Generator().manual_seed(0), device)
    optimizer = make_optimizer(workload, "adam", 1e-2)
    train_step = mlp.build_train_step(cfg, optimizer, device, mesh)
    batch_size = int(workload.get("batch_size", 32))
    rows = _dp_rows(batch_size, mesh)
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal((cfg.d_in, cfg.d_out))

    def make_batch(step):
        del step  # the stream is stateful, as the reference's is
        x = rng.standard_normal((batch_size, cfg.d_in)).astype(np.float32)[rows]
        return {"x": x, "y": (x @ w_true).astype(np.float32)}

    return params, optimizer, train_step, make_batch, None, None


def _setup_cnn(workload: dict, device, mesh):
    """Vision family: ResNet-style training on synthetic images."""
    cfg = cnn_config(workload)
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), device)
    optimizer = make_optimizer(workload, "adam", 1e-3)
    train_step = cnn.build_train_step(cfg, optimizer, device, mesh)
    batch_size = int(workload.get("batch_size", 8))
    image_size = int(workload.get("image_size", 32))
    rows = _dp_rows(batch_size, mesh)
    rng = np.random.default_rng(0)

    def make_batch(step):
        del step  # the stream is stateful, as the reference's is
        images = rng.standard_normal(
            (batch_size, image_size, image_size, cfg.in_channels)).astype(np.float32)
        labels = rng.integers(0, cfg.num_classes, (batch_size,))
        return {"images": images[rows], "labels": labels[rows]}

    return params, optimizer, train_step, make_batch, None, None


def _setup_lm(workload: dict, device, mesh):
    cfg = lm_config(workload)
    cfg.validate(mesh.config)
    specs = param_specs(cfg)
    params = shard_params(init_params(cfg, torch.Generator().manual_seed(0), device,
                                      mesh.config), cfg, mesh)
    optimizer = make_optimizer(workload, "adamw", 1e-3, specs, mesh)
    if workload.get("zero1"):
        optimizer = optim.zero1(optimizer, specs, mesh)
    accum = int(workload.get("accum_steps", 1))
    train_step = build_train_step(cfg, optimizer, accum, device, mesh)
    state_specs = {"state": {"params": specs,
                             "opt_state": optimizer.state_specs(
                                 specs, global_shapes(cfg, mesh.config))}}
    batch_size = int(workload.get("batch_size", 4))
    seq_len = int(workload.get("seq_len", 16))
    data_cfg = workload.get("data") or {}
    rows = _dp_rows(batch_size, mesh, accum)
    columns = sequence_shard(seq_len, mesh.size("sp"), mesh.index("sp"))

    def synthetic_batches(seed: int):
        """Positionally seeded token stream: a resumed run sees the batches
        of an uninterrupted one. A rank keeps its dp rows and sp positions."""

        def make(step):
            rng = np.random.default_rng((seed, step))
            tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len + 1))[rows]
            return {"inputs": np.ascontiguousarray(tokens[:, :-1][:, columns]),
                    "targets": np.ascontiguousarray(tokens[:, 1:][:, columns])}

        return make

    def dataset(path, seed):
        """The corpus's batches, this rank's rows and positions: the rows
        read process-locally (only its own windows) where they are one
        block (no accumulation)."""
        local = accum == 1
        data = TokenDataset(path, seq_len=seq_len, batch_size=batch_size,
                            dtype=data_cfg.get("dtype", "uint16"), seed=seed,
                            rank=mesh.index("dp") if local else 0,
                            world=mesh.size("dp") if local else 1, vocab_size=cfg.vocab_size)
        mine = slice(None) if local else rows
        return lambda step: {k: np.ascontiguousarray(v[mine][:, columns])
                             for k, v in data.batch(step).items()}

    seed = int(data_cfg.get("seed", 0))
    make_batch = (dataset(data_cfg["path"], seed) if data_cfg.get("path")
                  else synthetic_batches(17))

    eval_fn = None
    if int(workload.get("eval_every", 0)) > 0:
        eval_step = build_eval_step(cfg, device, mesh)
        eval_steps = int(workload.get("eval_steps", 2))
        make_val = (dataset(data_cfg["val_path"], seed + 1) if data_cfg.get("val_path")
                    else synthetic_batches(29))

        def eval_fn(p, at_step):
            vals = [float(eval_step(p, place_batch(make_val(at_step * 1000 + i), device)))
                    for i in range(eval_steps)]
            return sum(vals) / len(vals)

    return params, optimizer, train_step, make_batch, eval_fn, state_specs


_SETUPS = {"mlp": _setup_mlp, "cnn": _setup_cnn, "lm": _setup_lm}


def check_workload(workload: dict) -> MeshConfig:
    """The workload's mesh (its `mesh` mapping; every axis 1 without one),
    once its kind is known (an unknown kind raises ValueError, an unknown
    mesh axis TypeError)."""
    kind = workload.get("kind", "mlp")
    if kind not in _SETUPS:
        raise ValueError(f"unknown workload kind: {kind}")
    return MeshConfig.of(workload.get("mesh"))


def train_workload(workload: dict, device=None, mesh=None, restarts: int = 0) -> TrainResult:
    """Run one workload's training loop on `device` (the card unless the
    caller names another); returns the per-step losses (the global batch's
    on every rank). `mesh` is this process's place in a gang
    (`parallel.mesh.build_mesh` over the process group); without one the
    run is on one device, and a payload whose `mesh` spans more devices
    raises. The engine behind the simulator's `WorkloadRunner` and the
    per-pod entry point (`jobset_tpu_torch.runtime.worker`)."""
    mesh_cfg = check_workload(workload)
    device = resolve_device(device)
    if mesh is None:
        if mesh_cfg.num_devices > 1:
            raise ValueError(
                f"the workload's mesh {mesh_cfg.shape} spans {mesh_cfg.num_devices} devices: "
                "run it as a gang of that many processes (runtime.worker, WorkloadRunner)"
            )
        mesh = single_device_mesh()
    params, optimizer, train_step, make_batch, eval_fn, specs = _SETUPS[
        workload.get("kind", "mlp")](workload, device, mesh)
    state = {"params": params, "opt_state": optimizer.init(params)}
    return _run_loop(workload, state, train_step, make_batch, device, restarts=restarts,
                     eval_fn=eval_fn, mesh=mesh if mesh.groups else None, specs=specs)


# ---------------------------------------------------------------------------
# The simulator's gang runner
# ---------------------------------------------------------------------------

# The control plane's constants the runner reads (the port's own copies of
# `jobset_tpu.api.keys.JOBSET_NAME_KEY` and `jobset_tpu.core.objects.POD_RUNNING`).
JOBSET_NAME_KEY = "jobset.sigs.k8s.io/jobset-name"
POD_RUNNING = "Running"
# The loss annotations `_record_losses` writes on a JobSet.
INITIAL_LOSS_KEY = "tpu.jobset.x-k8s.io/initial-loss"
FINAL_LOSS_KEY = "tpu.jobset.x-k8s.io/final-loss"
VAL_LOSS_KEY = "tpu.jobset.x-k8s.io/val-loss"


# The longest a spawned gang may run before its processes are killed.
GANG_TIMEOUT_S = 180.0


class GangFailure(RuntimeError):
    """A rank of a spawned gang exited nonzero without reporting a
    `WorkloadFailure`, or the gang outlived its time limit."""


class WorkloadRunner:
    """Runs a JobSet's training payload once every pod of its gang is
    Running and Ready. A payload whose `mesh` spans one device runs in
    process, standing in for the whole gang; one whose mesh spans N > 1
    devices runs as N processes of the port's worker
    (`python -m jobset_tpu_torch.runtime.worker`), one per device, with
    the env `distributed.pod_env_for` gives the gang's first N pods, a
    loopback coordinator on a free port, and `backend` (default: "gloo" on
    the CPU, "nccl" on the card; ranks that share one card need "gloo",
    passed explicitly; on the CPU each process gets its share of the
    host's cores as its torch threads). One process per device is torch's
    idiom; it stands in for the reference's one process over its local
    mesh. Rank 0's result line gives the loss annotations.

    A workload that raises `WorkloadFailure` (on any rank) fails the
    JobSet's first child job (its failure policy then fails the JobSet or
    restarts the gang); one that finishes completes every child job. A
    restarted gang's run resumes from its latest checkpoint. A rank that
    exits nonzero otherwise, or a gang past GANG_TIMEOUT_S (its processes
    killed), raises `GangFailure`; an unknown kind or mesh axis raises
    (`check_workload`) before anything is spawned.

    `cluster` is taken duck-typed: the runner reads `pods` and `jobsets`
    (dicts of objects with the control plane's `Pod` and `JobSet` fields)
    and calls `get_jobset`, `jobs_for_jobset`, `fail_job`,
    `complete_all_jobs` and `run_until_stable`. `device` is the card unless
    the caller names another; without a card and without a named device it
    raises here."""

    def __init__(self, cluster, device=None, backend=None):
        self.cluster = cluster
        self.device = resolve_device(device)
        self.backend = backend or distributed.default_backend(self.device)
        # The result lines of the last spawned gang's ranks, by rank.
        self.last_gang_results: list = []
        # jobset uid -> restart count at which its workload last ran: one run
        # per gang incarnation (by uid, so a delete and recreate under the
        # same name runs again).
        self._ran_at: dict[str, int] = {}

    def gang_ready(self, js) -> bool:
        """All expected pods of every replicated job are Running and Ready."""
        expected = sum(int(rjob.replicas) * rjob.template.spec.pods_expected()
                       for rjob in js.spec.replicated_jobs)
        if expected == 0:
            return False
        ready = sum(1 for pod in self.cluster.pods.values()
                    if pod.annotations.get(JOBSET_NAME_KEY) == js.name
                    and pod.metadata.namespace == js.namespace
                    and pod.status.phase == POD_RUNNING and pod.status.ready)
        return ready >= expected

    @staticmethod
    def _workload_of(js):
        for rjob in js.spec.replicated_jobs:
            payload = rjob.template.spec.template.spec.workload
            if payload:
                return payload
        return None

    def _gang_pods(self, js) -> list:
        """The JobSet's pods, in process-id order."""
        pods = [pod for pod in self.cluster.pods.values()
                if pod.annotations.get(JOBSET_NAME_KEY) == js.name
                and pod.metadata.namespace == js.namespace]
        envs = [distributed.pod_env_for(self.cluster, pod) for pod in pods]
        return sorted(envs, key=lambda env: int(env[distributed.ENV_PROCESS_OFFSET])
                      + int(env[distributed.ENV_POD_INDEX]))

    def _run_gang(self, js, workload, n: int) -> TrainResult:
        """The workload as n worker processes, one per device; rank 0's
        losses."""
        envs = self._gang_pods(js)
        if len(envs) < n:
            raise ValueError(f"the workload's mesh spans {n} devices but the gang of "
                             f"{js.name} has {len(envs)} pods")
        coordinator = f"127.0.0.1:{distributed.free_port()}"
        package_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        command = [sys.executable, "-m", "jobset_tpu_torch.runtime.worker",
                   "--backend", self.backend]
        if self.device.type == "cpu":
            command.append("--cpu")
        with tempfile.TemporaryDirectory() as tmp:
            procs, outputs = [], []
            for rank, pod_env in enumerate(envs[:n]):
                env = {**os.environ, **pod_env,
                       distributed.ENV_TOTAL_PROCESSES: str(n),
                       distributed.ENV_COORDINATOR: coordinator,
                       distributed.ENV_WORKLOAD: json.dumps(workload),
                       "PYTHONPATH": os.pathsep.join(
                           [package_root] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
                if self.device.type == "cpu":  # each rank its share of the host's cores
                    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // n))
                out = open(os.path.join(tmp, f"rank{rank}.out"), "w+")
                err = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
                outputs.append((out, err))
                procs.append(subprocess.Popen(command, env=env, stdout=out, stderr=err))
            codes = wait_or_kill(procs, GANG_TIMEOUT_S)
            texts = []
            for out, err in outputs:
                out.seek(0)
                err.seek(0)
                texts.append((out.read(), err.read()))
                out.close()
                err.close()
        if codes is None:
            raise GangFailure(f"the gang of {js.name} ran past {GANG_TIMEOUT_S} s; "
                              "its processes were killed")
        results = [_result_line(stdout) for stdout, _ in texts]
        self.last_gang_results = results
        if any(r is not None and "failed" in r for r in results) and set(codes) <= {0, 1}:
            raise WorkloadFailure(next(r["failed"] for r in results
                                       if r is not None and "failed" in r))
        bad = [rank for rank, code in enumerate(codes) if code != 0]
        if bad:
            raise GangFailure(f"rank {bad[0]} of the gang of {js.name} exited {codes[bad[0]]}:\n"
                              + texts[bad[0]][1][-4000:])
        first = results[0]
        return TrainResult(first["losses"], [tuple(v) for v in first["val_losses"]])

    def run_pending(self) -> list[str]:
        """Run the workload of every gang-ready JobSet that has not run in
        its current incarnation; returns the names of those that ran."""
        ran = []
        live_uids = {js.metadata.uid for js in self.cluster.jobsets.values()}
        for uid in list(self._ran_at):
            if uid not in live_uids:  # deleted (TTL) or recreated JobSets
                del self._ran_at[uid]
        for js in list(self.cluster.jobsets.values()):
            if js.status.terminal_state:
                continue
            workload = self._workload_of(js)
            if workload is None or not self.gang_ready(js):
                continue
            if self._ran_at.get(js.metadata.uid) == js.status.restarts:
                continue  # already ran for this incarnation
            self._ran_at[js.metadata.uid] = js.status.restarts
            n = check_workload(workload).num_devices
            try:
                losses = (self._run_gang(js, workload, n) if n > 1 else
                          train_workload(workload, self.device, restarts=js.status.restarts))
            except WorkloadFailure:
                # A crashed workload surfaces as a failed child job; the
                # failure policy decides between failing and a gang restart.
                first_job = next(iter(self.cluster.jobs_for_jobset(js)), None)
                if first_job is not None:
                    self.cluster.fail_job(first_job.metadata.namespace, first_job.metadata.name)
            else:
                _record_losses(js, losses)
                self.cluster.complete_all_jobs(js)
            ran.append(js.name)
            self.cluster.run_until_stable()
        return ran


def _result_line(stdout: str):
    """The last JSON object line of a worker's output, or None."""
    for line in reversed(stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except ValueError:
                continue
    return None


def _record_losses(js, losses) -> None:
    if not losses:
        return
    js.metadata.annotations[INITIAL_LOSS_KEY] = f"{losses[0]:.6f}"
    js.metadata.annotations[FINAL_LOSS_KEY] = f"{losses[-1]:.6f}"
    val = getattr(losses, "val_losses", None)
    if val:
        js.metadata.annotations[VAL_LOSS_KEY] = f"{val[-1][1]:.6f}"
