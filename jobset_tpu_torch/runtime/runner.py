"""The LM workload's training engine on one device: the counterpart of
`jobset_tpu/runtime/runner.py::train_workload` and what it runs.

Workload payload (a pod template's `spec.workload`), as the JAX package
reads it:
    {"kind": "lm",
     "steps": 20, "batch_size": 4, "seq_len": 16,
     "checkpoint_every": 5, "checkpoint_dir": "...",   # 0 = none
     "fail_at_step": 7,            # raise once, on restart attempt 0
     "eval_every": 0, "eval_steps": 2,
     "data": {"path": "...", "val_path": "...", "dtype": "uint16", "seed": 0},
     "optimizer": "adamw", "learning_rate": 1e-3, "weight_decay": 1e-4,
     "momentum": null, "lr_schedule": "constant" | "cosine", "warmup_steps": 0,
     "accum_steps": 1,
     "profile_dir": "...",         # a torch.profiler trace of the run
     "config": {...}}              # TransformerConfig overrides

Compute runs in f32 unless the config names another dtype ("float32" or
"bfloat16" as a JSON string). Synthetic batches (no data.path) come from
np.random.default_rng((17, step)), eval batches from (29, ...), so a
resumed run sees what an uninterrupted one would. A restart resumes from
the latest checkpoint.

Not ported yet: the "mlp" and "cnn" kinds, ZeRO-1, any mesh axis > 1,
adafactor, and the simulator's `WorkloadRunner` (it needs the control
plane's Cluster).
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import (
    TransformerConfig,
    build_eval_step,
    build_train_step,
    init_params,
)
from . import optim
from .checkpoint import Checkpointer
from .data import TokenDataset, place_batch, prefetching_fn

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


def make_optimizer(workload: dict, default: str, default_lr: float) -> optim.Optimizer:
    """Optimizer from `optimizer` ("adamw" | "adam" | "sgd"),
    `weight_decay` (adamw) and `momentum` (sgd), with the learning rate of
    `make_learning_rate`."""
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
        raise NotImplementedError("optimizer 'adafactor' is not ported yet")
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
              eval_fn=None) -> TrainResult:
    """Restore -> steps (eval and checkpoint cadence) -> losses."""
    every = int(workload.get("checkpoint_every", 0))
    ckpt = Checkpointer(workload["checkpoint_dir"]) if every > 0 else None
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


def lm_config(workload: dict) -> TransformerConfig:
    """The workload's TransformerConfig: f32 compute unless the payload's
    config names a dtype (a torch dtype, or "float32"/"bfloat16")."""
    overrides = dict(workload.get("config", {}))
    overrides.setdefault("dtype", torch.float32)
    for key in ("dtype", "param_dtype"):
        if isinstance(overrides.get(key), str):
            overrides[key] = _DTYPES[overrides[key]]
    return TransformerConfig(**overrides)


def _setup_lm(workload: dict, device):
    cfg = lm_config(workload)
    cfg.validate(workload.get("mesh"))
    if workload.get("zero1"):
        raise NotImplementedError("zero1 (optimizer state sharded over dp) is not ported yet")

    params = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    optimizer = make_optimizer(workload, "adamw", 1e-3)
    train_step = build_train_step(cfg, optimizer, int(workload.get("accum_steps", 1)), device)
    batch_size = int(workload.get("batch_size", 4))
    seq_len = int(workload.get("seq_len", 16))
    data_cfg = workload.get("data") or {}

    def synthetic_batches(seed: int):
        """Positionally seeded token stream: a resumed run sees the batches
        of an uninterrupted one."""

        def make(step):
            rng = np.random.default_rng((seed, step))
            tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len + 1))
            return {"inputs": np.ascontiguousarray(tokens[:, :-1]),
                    "targets": np.ascontiguousarray(tokens[:, 1:])}

        return make

    def dataset(path, seed):
        return TokenDataset(path, seq_len=seq_len, batch_size=batch_size,
                            dtype=data_cfg.get("dtype", "uint16"), seed=seed,
                            vocab_size=cfg.vocab_size).batch

    seed = int(data_cfg.get("seed", 0))
    make_batch = (dataset(data_cfg["path"], seed) if data_cfg.get("path")
                  else synthetic_batches(17))

    eval_fn = None
    if int(workload.get("eval_every", 0)) > 0:
        eval_step = build_eval_step(cfg, device)
        eval_steps = int(workload.get("eval_steps", 2))
        make_val = (dataset(data_cfg["val_path"], seed + 1) if data_cfg.get("val_path")
                    else synthetic_batches(29))

        def eval_fn(p, at_step):
            vals = [float(eval_step(p, place_batch(make_val(at_step * 1000 + i), device)))
                    for i in range(eval_steps)]
            return sum(vals) / len(vals)

    return params, optimizer, train_step, make_batch, eval_fn


def train_workload(workload: dict, device=None, restarts: int = 0) -> TrainResult:
    """Run one workload's training loop on `device` (the card unless the
    caller names another); returns the per-step losses. The engine behind
    the per-pod entry point (`jobset_tpu_torch.runtime.worker`)."""
    kind = workload.get("kind", "mlp")
    if kind in ("mlp", "cnn"):
        raise NotImplementedError(f"workload kind {kind!r} is not ported yet (only 'lm')")
    if kind != "lm":
        raise ValueError(f"unknown workload kind: {kind}")
    device = resolve_device(device)
    params, optimizer, train_step, make_batch, eval_fn = _setup_lm(workload, device)
    state = {"params": params, "opt_state": optimizer.init(params)}
    return _run_loop(workload, state, train_step, make_batch, device,
                     restarts=restarts, eval_fn=eval_fn)
