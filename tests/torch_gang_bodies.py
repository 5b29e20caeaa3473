"""Rank bodies for `jobset_tpu_torch.runtime.gang.spawn` in the port's
tests: each runs on every rank of a gang and returns what the test holds
against the JAX package or a single-process run. This module imports
neither JAX nor the JAX package, so that a spawned rank (which inherits
its parent's `sys.path`) starts without them.

`train_steps`: a transformer's train steps over the gang's mesh, from full
parameters (given, or drawn from a seed on the device) and global
batches, returning the losses and the gathered parameters, and the
gathered gradients of a step with `optimizer="grads"` (an optimizer that
keeps the gradients as its state and moves nothing).
"""

from __future__ import annotations

import torch

from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import (
    gather_params,
    gather_tree,
    params_from_jax,
    shard_params,
    shard_tree,
)
from jobset_tpu_torch.device import resolve_device
from jobset_tpu_torch.models.transformer import (
    TransformerConfig,
    build_train_step,
    global_shapes,
    init_params,
    param_specs,
)
from jobset_tpu_torch.parallel.mesh import MeshConfig, build_mesh, build_multislice_mesh
from jobset_tpu_torch.runtime import optim
from jobset_tpu_torch.runtime.runner import _with_dtypes, batch_rows, train_workload


def _numpy_tree(tree_):
    if isinstance(tree_, dict):
        return {k: _numpy_tree(v) for k, v in tree_.items()}
    if isinstance(tree_, list):
        return [_numpy_tree(v) for v in tree_]
    if torch.is_tensor(tree_):
        return tree_.detach().float().cpu().numpy()
    return tree_


def grads_optimizer(inner=None):
    """An optimizer that keeps the gradients of its first update as
    `state["g"]` and otherwise is `inner` (without one it moves nothing):
    a train step's (dp-summed) gradients, beside the steps of a run."""
    def init(params):
        return {"count": 0, "g": tree.tree_map(lambda p: p.new_zeros(p.shape), params),
                "inner": inner.init(params) if inner else None}

    def update(grads, state, params):
        if inner is None:
            updates, inner_state = tree.tree_map(lambda g: g.new_zeros(g.shape), grads), None
        else:
            updates, inner_state = inner.update(grads, state["inner"], params)
        return updates, {"count": state["count"] + 1,
                         "g": grads if state["count"] == 0 else state["g"], "inner": inner_state}

    def state_specs(specs, shapes):
        return {"count": None, "g": specs,
                "inner": inner.state_specs(specs, shapes) if inner else None}

    return optim.Optimizer(init, update, state_specs)


def train_steps(config: dict, mesh_shape: dict, batches: list, optimizer: str = "adamw",
                learning_rate: float = 1e-3, accum_steps: int = 1, params=None, seed: int = 0,
                device=None, keep_grads: bool = False) -> dict:
    """`len(batches)` train steps of the transformer `config`
    (TransformerConfig's fields; "dtype" and "param_dtype" as
    "float32"/"bfloat16") over the mesh `mesh_shape` laid over the gang,
    each rank fed its rows of each global batch (numpy dicts). Parameters:
    `params` (a full numpy tree, as `params_from_jax` takes it) or
    `init_params` from a generator on the device seeded `seed`. optimizer:
    "adamw", "adam", "sgd", "adafactor" or "grads"; `keep_grads` keeps the
    first step's gradients in the optimizer state (`grads_optimizer`).
    Returns the losses, the gathered parameters and optimizer state as
    numpy, and this rank's mesh coordinates."""
    device = resolve_device(device)
    cfg = TransformerConfig(**_with_dtypes(config))
    mesh = build_mesh(MeshConfig(**mesh_shape), device)
    specs = param_specs(cfg)
    full = (params_from_jax(params, device) if params is not None
            else init_params(cfg, torch.Generator(device=device).manual_seed(seed), device))
    local = shard_params(full, cfg, mesh)
    del full
    opt = {"adamw": lambda: optim.adamw(learning_rate), "adam": lambda: optim.adam(learning_rate),
           "sgd": lambda: optim.sgd(learning_rate),
           "adafactor": lambda: optim.adafactor(learning_rate, specs, mesh.group("tp")),
           "grads": grads_optimizer}[optimizer]()
    if keep_grads:
        opt = grads_optimizer(opt)
    state = opt.init(local)
    step = build_train_step(cfg, opt, accum_steps, device, mesh)
    rows = batch_rows(len(batches[0]["inputs"]), mesh.size("dp"), mesh.index("dp"), accum_steps)
    losses = []
    for batch in batches:
        local, state, loss = step(local, state, {k: v[rows] for k, v in batch.items()})
        losses.append(float(loss))
    state_specs = opt.state_specs(specs, global_shapes(cfg))
    return {"losses": losses, "coords": mesh.coords,
            "params": _numpy_tree(gather_params(local, cfg, mesh)),
            "opt_state": _numpy_tree(gather_tree(state, state_specs, mesh))}


def train_runs(runs: dict) -> dict:
    """Several `train_steps` runs on one gang, one after the other: runs is
    {key: train_steps' keyword arguments}; returns {key: its result}."""
    return {key: train_steps(**kwargs) for key, kwargs in runs.items()}


def workload_runs(workloads: list, mesh_shape: dict, device=None) -> list:
    """`runner.train_workload` of each workload in turn over the mesh
    `mesh_shape` laid over the gang; their losses."""
    mesh = build_mesh(MeshConfig(**mesh_shape), device)
    return [list(train_workload(w, device, mesh)) for w in workloads]


def optimizer_updates(name: str, learning_rate: float, params: dict, grads: list, specs: dict,
                      mesh_shape: dict, device=None) -> list:
    """The updates of `optim.<name>` (over the tp group where it takes one)
    for each gradient tree of `grads` in turn, applied to the parameters as
    they go, from full numpy trees cut to the rank's shards by `specs`; each
    gathered back to the full tree (numpy)."""
    device = resolve_device(device)
    mesh = build_mesh(MeshConfig(**mesh_shape), device)
    opt = (optim.adafactor(learning_rate, specs, mesh.group("tp")) if name == "adafactor"
           else getattr(optim, name)(learning_rate))
    local = shard_tree(params_from_jax(params, device), specs, mesh)
    state = opt.init(local)
    out = []
    for g in grads:
        updates, state = opt.update(shard_tree(params_from_jax(g, device), specs, mesh), state,
                                    local)
        out.append(_numpy_tree(gather_tree(updates, specs, mesh)))
        local = tree.apply_updates(local, updates)
    return out


def mesh_layouts(layouts: list, device=None) -> list:
    """Each layout of `layouts` built over the gang, in turn: ("mesh",
    mesh_shape, allow_submesh) through `build_mesh`, ("multislice", ici,
    dcn) through `build_multislice_mesh`. For each, this rank's
    coordinates (None where a submesh leaves it out) and, per axis with a
    process group, the all-reduced sum of the ranks on this rank's group."""
    import torch.distributed as dist

    device = resolve_device(device)
    out = []
    for kind, *shape in layouts:
        if kind == "mesh":
            mesh = build_mesh(MeshConfig(**shape[0]), device, allow_submesh=shape[1])
        else:
            mesh = build_multislice_mesh(MeshConfig(**shape[0]), MeshConfig(**shape[1]), device)
        if mesh is None:
            out.append(None)
            continue
        sums = {}
        for axis, group in mesh.groups.items():
            t = torch.tensor([float(mesh.rank)], device=device)
            dist.all_reduce(t, group=group)
            sums[axis] = float(t)
        out.append({"coords": mesh.coords, "sums": sums})
    return out


def fail_on_rank(failing: int) -> None:
    """Rank `failing` raises; every other rank waits for it in an
    all-reduce over the gang."""
    import torch.distributed as dist

    if dist.get_rank() == failing:
        raise RuntimeError(f"rank {failing} fails")
    dist.all_reduce(torch.zeros(1))
