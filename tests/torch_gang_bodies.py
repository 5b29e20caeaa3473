"""Rank bodies for `jobset_tpu_torch.runtime.gang.spawn` in the port's
tests: each runs on every rank of a gang and returns what the test holds
against the JAX package or a single-process run. This module imports
neither JAX nor the JAX package, so that a spawned rank (which inherits
its parent's `sys.path`) starts without them.

`train_steps`: a transformer's train steps over the gang's mesh, from full
parameters (given, or drawn from a seed on the device) and global
batches (each rank its dp rows and sp positions), returning the losses,
the eval loss of held-out batches, and the gathered parameters, and the
gathered gradients of a step with `optimizer="grads"` (an optimizer that
keeps the gradients as its state and moves nothing); `zero1` splits the
optimizer state over dp. `serve_runs`: `build_generate` over a dp x tp
mesh, each rank its dp rows of a prompt and its shards of full (maybe
int8) parameters. `pick_draws`: the sampled pick over a tp-sharded
vocab. `forward_runs`: `build_forward` over any mesh, each rank its dp
rows and sp chunk of the tokens. `sp_attention`: ring and Ulysses
attention on the rank's chunks, with their gradients. `toy_pipeline`: the pipeline
loop on a toy stage, with its gradients. `ep_collectives`: the gather
(with its backward) and the all-to-all over ep.
"""

from __future__ import annotations

import numpy as np
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
from jobset_tpu_torch.models import decode
from jobset_tpu_torch.models.quant import quantize_params_for_serving
from jobset_tpu_torch.models.transformer import (
    TransformerConfig,
    build_eval_step,
    build_forward,
    build_train_step,
    global_shapes,
    init_params,
    param_specs,
)
from jobset_tpu_torch.parallel import ring_attention, ulysses_attention
from jobset_tpu_torch.parallel.mesh import MeshConfig, build_mesh, build_multislice_mesh
from jobset_tpu_torch.runtime import optim
from jobset_tpu_torch.runtime.data import sequence_shard
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

    def update(grads, state, params, shards=None):
        if inner is None:
            updates, inner_state = tree.tree_map(lambda g: g.new_zeros(g.shape), grads), None
        else:
            updates, inner_state = inner.update(grads, state["inner"], params, shards=shards)
        return updates, {"count": state["count"] + 1,
                         "g": grads if state["count"] == 0 else state["g"], "inner": inner_state}

    def state_specs(specs, shapes):
        return {"count": None, "g": specs,
                "inner": inner.state_specs(specs, shapes) if inner else None}

    return optim.Optimizer(init, update, state_specs)


def train_steps(config: dict, mesh_shape: dict, batches: list, optimizer: str = "adamw",
                learning_rate: float = 1e-3, accum_steps: int = 1, params=None, seed: int = 0,
                device=None, keep_grads: bool = False, zero1: bool = False,
                eval_batches=()) -> dict:
    """`len(batches)` train steps of the transformer `config`
    (TransformerConfig's fields; "dtype" and "param_dtype" as
    "float32"/"bfloat16") over the mesh `mesh_shape` laid over the gang,
    each rank fed its rows of each global batch (numpy dicts). Parameters:
    `params` (a full numpy tree, as `params_from_jax` takes it) or
    `init_params` from a generator on the device seeded `seed`. optimizer:
    "adamw", "adam", "sgd", "adafactor" or "grads"; `keep_grads` keeps the
    first step's gradients in the optimizer state (`grads_optimizer`);
    `zero1` wraps the optimizer in `optim.zero1`. Returns the losses, the
    eval step's loss on each of `eval_batches` after the steps, the
    gathered parameters and optimizer state as numpy, the bytes of this
    rank's optimizer state, and this rank's mesh coordinates."""
    device = resolve_device(device)
    cfg = TransformerConfig(**_with_dtypes(config))
    mesh = build_mesh(MeshConfig(**mesh_shape), device)
    specs = param_specs(cfg)
    full = (params_from_jax(params, device) if params is not None
            else init_params(cfg, torch.Generator(device=device).manual_seed(seed), device,
                             mesh.config))
    local = shard_params(full, cfg, mesh)
    del full
    opt = {"adamw": lambda: optim.adamw(learning_rate), "adam": lambda: optim.adam(learning_rate),
           "sgd": lambda: optim.sgd(learning_rate),
           "adafactor": lambda: optim.adafactor(learning_rate, specs, mesh),
           "grads": grads_optimizer}[optimizer]()
    if keep_grads:
        opt = grads_optimizer(opt)
    if zero1:
        opt = optim.zero1(opt, specs, mesh)
    state = opt.init(local)
    step = build_train_step(cfg, opt, accum_steps, device, mesh)
    rows = batch_rows(len(batches[0]["inputs"]), mesh.size("dp"), mesh.index("dp"), accum_steps)
    columns = sequence_shard(batches[0]["inputs"].shape[1], mesh.size("sp"), mesh.index("sp"))

    def mine(batch):
        return {k: v[rows][:, columns] for k, v in batch.items()}

    losses = []
    for batch in batches:
        local, state, loss = step(local, state, mine(batch))
        losses.append(float(loss))
    eval_step = build_eval_step(cfg, device, mesh)
    eval_losses = [float(eval_step(local, mine(b))) for b in eval_batches]
    state_specs = opt.state_specs(specs, global_shapes(cfg, mesh.config))
    return {"losses": losses, "eval_losses": eval_losses, "coords": mesh.coords,
            "state_bytes": sum(t.numel() * t.element_size() for t in tree.leaves(state)
                               if torch.is_tensor(t)),
            "params": _numpy_tree(gather_params(local, cfg, mesh)),
            "opt_state": _numpy_tree(gather_tree(state, state_specs, mesh))}


def _rank_rows(n: int, mesh) -> np.ndarray:
    return batch_rows(n, mesh.size("dp"), mesh.index("dp"))


def serve_runs(runs: dict, device=None) -> dict:
    """For each run {key: dict(config, mesh, params, prompt, max_new, and
    optionally temperature, top_k, quantized, quantized_kv, seed, noise,
    record_noise)}: `build_generate` over the mesh (a dict of axis sizes,
    laid over the gang; runs with one mesh shape share it), the full
    numpy `params` converted, quantized whole when `quantized`, then cut to
    this rank's shards; the rank serves its dp rows of the numpy `prompt`.
    `seed` makes the caller's generator (a torch.Generator on the device);
    `noise` (numpy, the rank's [B / dp, V / tp] shape) replaces every draw
    of `decode._gumbel`; `record_noise` keeps the rank's first draw.
    Returns {key: {"tokens", "coords", and "noise" when recorded}}."""
    device = resolve_device(device)
    meshes: dict = {}
    out = {}
    real_gumbel = decode._gumbel
    for key, run in runs.items():
        shape = tuple(sorted(run["mesh"].items()))
        if shape not in meshes:
            meshes[shape] = build_mesh(MeshConfig(**run["mesh"]), device)
        mesh = meshes[shape]
        cfg = TransformerConfig(**_with_dtypes(run["config"]))
        full = params_from_jax(run["params"], device)
        if run.get("quantized"):
            full = quantize_params_for_serving(full)
        local = shard_params(full, cfg, mesh)
        del full
        drawn = []

        def gumbel(generator, shape_, dev, noise=run.get("noise")):
            g = (torch.from_numpy(noise).to(dev) if noise is not None
                 else real_gumbel(generator, shape_, dev))
            drawn.append(g.cpu().numpy())
            return g

        decode._gumbel = gumbel
        try:
            generate = decode.build_generate(
                cfg, run["max_new"], device, temperature=run.get("temperature", 0.0),
                top_k=run.get("top_k", 0), quantized=run.get("quantized", False),
                quantized_kv=run.get("quantized_kv", False), mesh=mesh)
            generator = (torch.Generator(device=device).manual_seed(run["seed"])
                         if "seed" in run else None)
            prompt = torch.from_numpy(run["prompt"][_rank_rows(len(run["prompt"]), mesh)])
            tokens = generate(local, prompt, generator)
        finally:
            decode._gumbel = real_gumbel
        out[key] = {"tokens": tokens.cpu().numpy(), "coords": mesh.coords}
        if run.get("record_noise"):
            out[key]["noise"] = drawn[0]
    return out


def pick_draws(logits, top_k: int, temperature: float, seeds, device=None) -> list:
    """At tp = the gang's size: `decode._pick_token` of this rank's vocab
    shard of the numpy `logits` [B, V], sampled at `temperature` over
    `top_k`, once with each generator seed (each rank's generator from
    `decode.rank_generator`). Returns the picked ids of every draw."""
    device = resolve_device(device)
    import torch.distributed as dist

    mesh = build_mesh(MeshConfig(tp=dist.get_world_size()), device)
    v_local = logits.shape[-1] // mesh.size("tp")
    shard = torch.from_numpy(logits[:, mesh.index("tp") * v_local:][:, :v_local]).to(device)
    picks = []
    for seed in seeds:
        generator = decode.rank_generator(torch.Generator(device=device).manual_seed(seed),
                                          device, mesh)
        picks.append(decode._pick_token(shard, generator, temperature, top_k, mesh).tolist())
    return picks


def forward_runs(runs: dict, device=None) -> dict:
    """For each run {key: dict(config, mesh, params, tokens)}:
    `build_forward` over the mesh (laid over the gang; runs with one mesh
    shape share it), the full numpy `params` cut to this rank's shards,
    the rank fed its dp rows and sp chunk of the numpy `tokens`. Returns
    {key: {"logits": its block of the global logits (numpy f32), "coords"}}."""
    device = resolve_device(device)
    meshes: dict = {}
    out = {}
    for key, run in runs.items():
        shape = tuple(sorted(run["mesh"].items()))
        if shape not in meshes:
            meshes[shape] = build_mesh(MeshConfig(**run["mesh"]), device)
        mesh = meshes[shape]
        cfg = TransformerConfig(**_with_dtypes(run["config"]))
        local = shard_params(params_from_jax(run["params"], device), cfg, mesh)
        tokens = run["tokens"]
        columns = sequence_shard(tokens.shape[1], mesh.size("sp"), mesh.index("sp"))
        mine = torch.from_numpy(tokens[_rank_rows(len(tokens), mesh)][:, columns])
        logits = build_forward(cfg, device, mesh)(local, mine)
        out[key] = {"logits": logits.float().cpu().numpy(), "coords": mesh.coords}
    return out


def train_runs(runs: dict) -> dict:
    """Several `train_steps` runs on one gang, one after the other: runs is
    {key: train_steps' keyword arguments}; returns {key: its result}."""
    return {key: train_steps(**kwargs) for key, kwargs in runs.items()}


def workload_runs(workloads: list, mesh_shape: dict, device=None) -> list:
    """`runner.train_workload` of each workload in turn over the mesh
    `mesh_shape` laid over the gang; their losses."""
    mesh = build_mesh(MeshConfig(**mesh_shape), device)
    return [list(train_workload(w, device, mesh)) for w in workloads]


def workload_sequence(runs: list, device=None) -> list:
    """`runner.train_workload` of each (workload, mesh_shape) of `runs` in
    turn, each over its own mesh laid over the gang; their losses."""
    out = []
    for workload, mesh_shape in runs:
        mesh = build_mesh(MeshConfig(**mesh_shape), device)
        out.append(list(train_workload(workload, device, mesh)))
    return out


def optimizer_updates(name: str, learning_rate: float, params: dict, grads: list, specs: dict,
                      mesh_shape: dict, device=None) -> list:
    """The updates of `optim.<name>` (over the tp group where it takes one)
    for each gradient tree of `grads` in turn, applied to the parameters as
    they go, from full numpy trees cut to the rank's shards by `specs`; each
    gathered back to the full tree (numpy)."""
    device = resolve_device(device)
    mesh = build_mesh(MeshConfig(**mesh_shape), device)
    opt = (optim.adafactor(learning_rate, specs, mesh) if name == "adafactor"
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


def ep_collectives(chunks, sends, cot, dtype: str = "float32", device=None) -> dict:
    """At ep = the gang's size (numpy inputs, one row a rank): `gather` of
    this rank's chunk over ep and its backward from `cot`, the cotangent of
    the gathered value, and the `all_to_all` of its [ep, ...] send buffer
    (split and concatenated along dim 0)."""
    from jobset_tpu_torch.parallel import collectives

    device = resolve_device(device)
    dt = getattr(torch, dtype)
    mesh = build_mesh(MeshConfig(ep=len(chunks)), device)
    me, group = mesh.index("ep"), mesh.group("ep")
    x = torch.as_tensor(chunks[me]).to(device, dt).requires_grad_()
    gathered = collectives.gather(x, 0, group)
    gathered.backward(torch.as_tensor(cot).to(device, dt))
    moved = collectives.all_to_all(torch.as_tensor(sends[me]).to(device, dt), 0, 0, group)
    return {"gathered": _numpy_tree(gathered), "gather_grad": _numpy_tree(x.grad),
            "moved": _numpy_tree(moved)}


def sp_attention(cases: dict, sp: int, device=None) -> dict:
    """Each case {key: (impl "ring" | "ulysses", causal, q, k, v, w)} on a
    gang of sp ranks (the sp axis): this rank's chunk of q, k, v (numpy
    [B, T, H, D], k/v maybe fewer heads) through the attention, and the
    gradients of sum(out * w's chunk). Returns {key: (out, dq, dk, dv)} of
    the rank's chunk, numpy."""
    device = resolve_device(device)
    mesh = build_mesh(MeshConfig(sp=sp), device)
    out = {}
    for key, (impl, causal, *arrays) in cases.items():
        chunk = sequence_shard(arrays[0].shape[1], sp, mesh.index("sp"))
        q, k, v, w = (torch.from_numpy(a[:, chunk]).to(device) for a in arrays)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        fn = ring_attention if impl == "ring" else ulysses_attention
        got = fn(q, k, v, mesh.group("sp"), causal=causal)
        (got * w).sum().backward()
        out[key] = tuple(x.detach().cpu().numpy() for x in (got, q.grad, k.grad, v.grad))
    return out


def sp_collectives(x, w, sp: int, dtypes=("float32",), device=None) -> dict:
    """`collectives.rotate`, `collectives.all_to_all` (split dim 2, concat
    dim 1) and `collectives.gather` (dim 1) of this rank's chunk of x
    (numpy [B, T, H, D], split along T over the sp ranks), in each of
    `dtypes`, and for the first two the gradient of sum(out * w's block) for the chunk,
    w's block taken where the rank's output lies in the global [B, T, H, D]
    (rotate: its chunk of T; all_to_all: its chunk of H). Returns {dtype:
    {name: (out, grad)}}, numpy f32 (gather's grad None); every output
    contiguous."""
    from jobset_tpu_torch.parallel import collectives

    device = resolve_device(device)
    mesh = build_mesh(MeshConfig(sp=sp), device)
    index, group = mesh.index("sp"), mesh.group("sp")
    times = sequence_shard(x.shape[1], sp, index)
    heads = sequence_shard(x.shape[2], sp, index)
    out = {}
    for name in dtypes:
        dtype, moved = getattr(torch, name), {}
        for op, fn, block in (("rotate", lambda t: collectives.rotate(t, group), w[:, times]),
                              ("all_to_all", lambda t: collectives.all_to_all(t, 2, 1, group),
                               w[:, :, heads])):
            t = torch.from_numpy(x[:, times]).to(device, dtype).requires_grad_()
            got = fn(t)
            assert got.is_contiguous() and got.dtype == dtype
            (got * torch.from_numpy(block).to(device, dtype)).sum().backward()
            moved[op] = (got.detach().float().cpu().numpy(), t.grad.float().cpu().numpy())
        got = collectives.gather(torch.from_numpy(x[:, times]).to(device, dtype), 1, group)
        assert got.is_contiguous() and got.dtype == dtype
        moved["gather"] = (got.float().cpu().numpy(), None)
        out[name] = moved
    return out


def zero_state_round_trip(config: dict, mesh_shape: dict, device=None) -> dict:
    """Adam's and adafactor's states of the transformer `config` (seeded
    parameters, cut to the rank's tp shards) split over dp by
    `parallel.zero` and gathered back: for each optimizer, the widened
    state specs, whether each leaf came back equal, and the bytes this
    rank holds split and whole."""
    from jobset_tpu_torch.parallel import zero

    device = resolve_device(device)
    cfg = TransformerConfig(**_with_dtypes(config))
    mesh = build_mesh(MeshConfig(**mesh_shape), device)
    specs = param_specs(cfg)
    local = shard_params(init_params(cfg, torch.Generator().manual_seed(0), device), cfg, mesh)
    out = {}
    for name, opt in (("adam", optim.adam(1e-3)),
                      ("adafactor", optim.adafactor(1e-3, specs, mesh))):
        state = opt.init(local)
        state = tree.rebuild(state, [  # distinct entries, alike on every dp rank
            torch.arange(t.numel(), dtype=t.dtype, device=t.device).reshape(t.shape)
            if torch.is_tensor(t) else t for t in tree.leaves(state)])
        state_specs, _ = zero.zero1_plan(state, local, opt.state_specs(
            specs, global_shapes(cfg, mesh.config)), specs, mesh.size("dp"))
        split = zero.shard_state(state, state_specs, mesh)
        back = gather_tree(split, state_specs, mesh, axes=("dp",))
        out[name] = {"specs": state_specs,
                     "equal": [bool(torch.equal(a, b)) for a, b in zip(tree.leaves(back),
                                                                      tree.leaves(state))
                               if torch.is_tensor(a)],
                     "bytes": [sum(t.numel() * t.element_size() for t in tree.leaves(x)
                                   if torch.is_tensor(t)) for x in (split, state)]}
    return out


def toy_pipeline(cases: dict, pp: int, device=None) -> dict:
    """The pipeline loop (`parallel.pipeline.drive`) on a gang of pp ranks
    (the pp axis), for each case {key: (schedule, n_virtual, w, hw, mbs)}:
    w [pp, v, D, D] the stage weights (rank r's chunk c is w[r, c]; a
    stage is tanh(x @ w)), hw [D, D] the head's weight, mbs [M, rows, D]
    the microbatches (numpy, f32). The objective is the sum over
    microbatches of 0.01 * sum((y @ hw - 1)^2) of the last stage's output
    y. Returns {key: (objective on the last rank, this rank's w gradient
    [v, D, D], hw's gradient, the microbatches' cotangents (rank 0's; else
    None), the last stage's outputs of an eval run (the last rank's; else
    None), the most saved graphs this rank held)}."""
    from jobset_tpu_torch.parallel.pipeline import drive, timetable

    device = resolve_device(device)
    mesh = build_mesh(MeshConfig(pp=pp), device)
    rank, group = mesh.index("pp"), mesh.group("pp")
    out = {}
    for key, (schedule, v, w, hw, mbs) in cases.items():
        table = timetable(schedule, mbs.shape[0], pp, v)
        w_leaf = torch.from_numpy(w[rank]).to(device).requires_grad_()
        hw_leaf = torch.from_numpy(hw).to(device).requires_grad_()
        feed_mbs = torch.from_numpy(mbs).to(device)

        def stage(b, c, x):
            return torch.tanh(x @ w_leaf[c]), None

        def head(b, y):
            return 0.01 * ((y @ hw_leaf - 1.0) ** 2).sum()

        def finish(outputs, extras):
            return sum(head(b, y) for b, y in sorted(outputs.items())) if outputs else None

        ran = drive(table, rank, group, stage, lambda b: feed_mbs[b], feed_mbs[0],
                    finish=finish, head=head)
        last = rank == pp - 1
        with torch.no_grad():
            evaluated = drive(table, rank, group, stage, lambda b: feed_mbs[b], feed_mbs[0],
                              train=False).outputs
            objective = None
            if last:
                objective = float(sum(ran.head_values) if table.fused
                                  else sum(head(b, y) for b, y in sorted(evaluated.items())))
        out[key] = (objective, w_leaf.grad.cpu().numpy(),
                    hw_leaf.grad.cpu().numpy() if hw_leaf.grad is not None else None,
                    np.stack([ran.feed_grads[b].cpu().numpy() for b in range(len(mbs))])
                    if rank == 0 else None,
                    np.stack([evaluated[b].cpu().numpy() for b in range(len(mbs))])
                    if last else None,
                    ran.peak_saved)
    return out


def fail_on_rank(failing: int) -> None:
    """Rank `failing` raises; every other rank waits for it in an
    all-reduce over the gang."""
    import torch.distributed as dist

    if dist.get_rank() == failing:
        raise RuntimeError(f"rank {failing} fails")
    dist.all_reduce(torch.zeros(1))
