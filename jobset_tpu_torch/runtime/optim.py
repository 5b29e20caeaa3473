"""Optimizers and learning-rate schedules with optax's formulas and
defaults, as small functional transforms over parameter trees.

    opt = adamw(1e-3)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = {p + u}

`update` returns new tensors and a new state and leaves its arguments as
they were, so the state passes through the train step and into a
checkpoint as optax's does (`torch.optim` binds itself to the tensors it
is built with). A state is a dict of an int `count` (updates applied so
far) and trees of tensors shaped like the params.

A learning rate is a float or a schedule, `schedule(count) -> float`:
update n (counted from 0) uses schedule(n), as optax's
`scale_by_schedule` does; Adam's bias correction uses n + 1.

Over a sharded parameter tree (`models.transformer.param_specs`: tp and
ep shards, pp stages) adam, adamw and sgd need no change: they are
elementwise, so a rank's update of its shard is the global update's
slice. Adafactor is not: its factored dims, row and column means and
block RMSs are those of the global leaf, so it takes the specs and the
mesh (`adafactor(lr, specs, mesh)`).
`Optimizer.state_specs(param_specs, global_shapes)` names which dim of
each state leaf is split over tp, ep or pp (and, under ZeRO-1, dp), for a
checkpoint that saves the global state.

`zero1(optimizer, specs, mesh)` is ZeRO-1 over the mesh's dp axis: the
parameter-shaped state leaves split over dp (`parallel.zero`), each rank
updating its slice of those leaves from the summed gradient's slice, and
the updates gathered back over dp, so the parameters stay replicated.
An update takes `shards`, for each leaf the cuts the caller made beyond
the optimizer's own specs; the elementwise optimizers ignore them, and
adafactor adds the sliced leaves' sums over dp to its means and block
RMSs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import tree
from ..parallel.collectives import all_reduce_

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


@dataclass(frozen=True)
class Optimizer:
    """init(params) -> state; update(grads, state, params, shards=None) ->
    (updates, state); state_specs(param_specs, global_shapes) -> the
    state's tree of specs (for each tensor leaf the mesh axis each dim is
    split over, as `param_specs` gives them; None for a number). `shards`:
    for each leaf, the (dim, group, parts) cuts of the leaf the caller
    made (ZeRO-1's dp slices); an update that reduces over a leaf adds the
    cut parts' sums over the group."""

    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict], tuple]
    state_specs: Callable[[dict, dict], dict]


# ---------------------------------------------------------------------------
# Schedules (optax.schedules)
# ---------------------------------------------------------------------------


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule: init_value to end_value over transition_steps,
    then constant; a non-positive transition_steps gives init_value."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        return (init_value - end_value) * (1 - count / transition_steps) + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: schedule i+1 takes over, restarted at 0, at
    boundary i."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, later in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = later(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup to peak_value, then
    cosine decay to end_value at decay_steps (counted from 0)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps],
    )


def _lr(learning_rate: LearningRate, count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


# ---------------------------------------------------------------------------
# Optimizers (optax.adam, adamw, sgd)
# ---------------------------------------------------------------------------


def _zeros(params: dict) -> dict:
    return tree.tree_map(torch.zeros_like, params)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in f32, as optax evaluates it (in f64 Adam's first
    updates would differ from optax's by about 1e-5 relative)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


# optax.adam's defaults; eps_root is 0, so it is left out.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _adam_like(learning_rate: LearningRate, weight_decay: Optional[float]) -> Optimizer:
    """optax's chain(scale_by_adam, [add_decayed_weights], scale_by_learning_rate)."""
    b1, b2 = ADAM_B1, ADAM_B2

    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(grads, state, params, shards=None):
        del shards  # elementwise
        g = tree.leaves(grads)
        count = state["count"]
        mu = torch._foreach_mul(tree.leaves(state["mu"]), b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        nu = torch._foreach_mul(tree.leaves(state["nu"]), b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        step = count + 1  # bias correction counts this update
        updates = torch._foreach_div(mu, _bias_correction(b1, step))
        denom = torch._foreach_div(nu, _bias_correction(b2, step))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        torch._foreach_div_(updates, denom)
        if weight_decay:
            torch._foreach_add_(updates, tree.leaves(params), alpha=weight_decay)
        torch._foreach_mul_(updates, -_lr(learning_rate, count))
        new_state = {"count": step, "mu": tree.rebuild(grads, mu), "nu": tree.rebuild(grads, nu)}
        return tree.rebuild(grads, updates), new_state

    def state_specs(specs, shapes):
        return {"count": None, "mu": specs, "nu": specs}

    return Optimizer(init, update, state_specs)


def adam(learning_rate: LearningRate) -> Optimizer:
    """optax.adam with its defaults. Elementwise: on a rank's tp shards it
    gives the global update's slice, with no collective."""
    return _adam_like(learning_rate, None)


def adamw(learning_rate: LearningRate, weight_decay: float = 1e-4) -> Optimizer:
    """optax.adamw with its defaults and mask=None: every leaf is decayed.
    Elementwise, as adam: no collective over tp shards."""
    return _adam_like(learning_rate, weight_decay)


def sgd(learning_rate: LearningRate, momentum: Optional[float] = None) -> Optimizer:
    """optax.sgd without Nesterov: momentum None keeps no trace (0.0 keeps
    one, multiplied by zero); the trace is g + momentum * trace.
    Elementwise, as adam: no collective over tp shards."""

    def init(params):
        state = {"count": 0}
        if momentum is not None:
            state["trace"] = _zeros(params)
        return state

    def update(grads, state, params, shards=None):
        del params, shards  # elementwise
        count = state["count"]
        new_state = {"count": count + 1}
        updates = tree.leaves(grads)
        if momentum is not None:
            updates = torch._foreach_mul(tree.leaves(state["trace"]), momentum)
            torch._foreach_add_(updates, tree.leaves(grads))
            new_state["trace"] = tree.rebuild(grads, updates)
        updates = torch._foreach_mul(updates, -_lr(learning_rate, count))
        return tree.rebuild(grads, updates), new_state

    def state_specs(specs, shapes):
        return {"count": None, **({"trace": specs} if momentum is not None else {})}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (optax.adafactor with its defaults)
# ---------------------------------------------------------------------------

# optax.adafactor's defaults: second moments factored where the two largest
# dims are both at least 128, decay 1 - (count + 1)**-0.8, eps added to g^2,
# updates clipped to block RMS 1, scaled by the parameter's block RMS
# (at least 1e-3).
ADAFACTOR_MIN_DIM_TO_FACTOR = 128
ADAFACTOR_DECAY_EXPONENT = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIP = 1.0
ADAFACTOR_MIN_PARAM_SCALE = 1e-3


def factored_dims(shape) -> Optional[tuple[int, int]]:
    """optax's `_factored_dims`: (second-largest axis, largest axis) by
    `np.argsort` (so ties pick the axes optax picks), or None where the
    leaf has fewer than 2 dims or its second-largest is below 128."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def _decay(count: int) -> tuple[float, float]:
    """(d, 1 - d) for d = 1 - (count + 1)**-0.8, evaluated in f32 as optax
    does."""
    d = np.float32(1) - np.float32(count + 1) ** np.float32(-ADAFACTOR_DECAY_EXPONENT)
    return float(d), float(np.float32(1) - d)


def _block_rms(x: torch.Tensor, cuts=()) -> torch.Tensor:
    """The RMS of a whole leaf; with `cuts` ((group, parts) for each dim x
    is cut along over a group), of the leaf the groups' ranks hold
    together (the squares summed over each group)."""
    if not cuts:
        return torch.sqrt(torch.mean(x * x))
    total, parts = (x * x).sum(), 1
    for group, n in cuts:
        all_reduce_([total], group)
        parts *= n
    return torch.sqrt(total / (x.numel() * parts))


def _mean(x: torch.Tensor, dim: int, cut=None, keepdim: bool = False) -> torch.Tensor:
    """x's mean over `dim`; with `cut` (group, parts), over the dim the
    group's ranks hold `parts` pieces of (the sums added over the group)."""
    if cut is None:
        return x.mean(dim=dim, keepdim=keepdim)
    group, parts = cut
    total = x.sum(dim=dim, keepdim=keepdim)
    all_reduce_([total], group)
    return total / (x.shape[dim] * parts)


def _drop(spec, dim: int) -> tuple:
    return tuple(axis for i, axis in enumerate(spec) if i != dim)


def adafactor(learning_rate: LearningRate, specs: Optional[dict] = None,
              mesh=None) -> Optimizer:
    """optax.adafactor(learning_rate) with its defaults: the chain
    scale_by_factored_rms, clip_by_block_rms(1), the learning rate,
    scale_by_param_block_rms(1e-3), scale(-1).

    A factored leaf keeps v_row (the mean of g^2 + eps over its largest
    axis) and v_col (over its second-largest), and v of shape (1,); any
    other leaf keeps a full v and (1,)-shaped v_row and v_col, as optax's
    state does. A stacked leaf ([pp, layers / pp, ...]) is one block: both
    block RMSs run over all its layers at once, as optax runs them over the
    JAX package's stacked tree.

    specs, mesh: over a sharded tree, the leaves' specs
    (`models.transformer.param_specs`) and the `parallel.mesh.Mesh`. Each
    leaf is then updated as optax updates the global leaf: its factored
    dims picked from the global shape, its row and column means and both
    block RMSs taken over the whole leaf (sums all-reduced over each axis
    its spec splits it over, tp, ep and pp, and over dp where an update's
    `shards` slice a leaf, as ZeRO-1 does). Without them every leaf is
    whole."""

    def cuts_of(p, spec, shard=()):
        """({dim: (group, parts)} for each dim of p cut over a group, p's
        global shape)."""
        cuts = {d: (mesh.group(axis), mesh.size(axis)) for d, axis in enumerate(spec or ())
                if mesh is not None and axis is not None and mesh.size(axis) > 1}
        cuts.update({d: (g, n) for d, g, n in shard})
        shape = list(p.shape)
        for d, (_, n) in cuts.items():
            shape[d] *= n
        return cuts, shape

    def leaf_specs(p):
        return tree.leaves(specs) if specs is not None else [None] * len(tree.leaves(p))

    def init(params):
        rows, cols, full = [], [], []
        for p, spec in zip(tree.leaves(params), leaf_specs(params)):
            one = p.new_zeros(1)
            dims = factored_dims(cuts_of(p, spec)[1])
            if dims is None:
                rows.append(one)
                cols.append(one.clone())
                full.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                rows.append(p.new_zeros([s for i, s in enumerate(p.shape) if i != d0]))
                cols.append(p.new_zeros([s for i, s in enumerate(p.shape) if i != d1]))
                full.append(one.clone())
        return {"count": 0, "v_row": tree.rebuild(params, rows),
                "v_col": tree.rebuild(params, cols), "v": tree.rebuild(params, full)}

    def update(grads, state, params, shards=None):
        count = state["count"]
        keep, take = _decay(count)
        lr = _lr(learning_rate, count)
        new_rows, new_cols, new_full, updates = [], [], [], []
        for i, (g, p, v_row, v_col, v, spec) in enumerate(zip(
                tree.leaves(grads), tree.leaves(params), tree.leaves(state["v_row"]),
                tree.leaves(state["v_col"]), tree.leaves(state["v"]), leaf_specs(params))):
            cuts, shape = cuts_of(p, spec, shards[i] if shards else ())
            whole = list(cuts.values())  # the groups the leaf is cut over
            g_sq = g * g + ADAFACTOR_EPS
            dims = factored_dims(shape)
            if dims is None:
                v = keep * v + take * g_sq
                u = g * v.rsqrt()
            else:
                d1, d0 = dims
                v_row = keep * v_row + take * _mean(g_sq, d0, cuts.get(d0))
                v_col = keep * v_col + take * _mean(g_sq, d1, cuts.get(d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_mean = _mean(v_row, reduced_d1, cuts.get(d1), keepdim=True)
                row_factor = (v_row / row_mean).rsqrt()
                u = g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
            u = u / torch.clamp(_block_rms(u, whole) / ADAFACTOR_CLIP, min=1.0)
            u = u * lr
            u = u * torch.clamp(_block_rms(p, whole), min=ADAFACTOR_MIN_PARAM_SCALE)
            new_rows.append(v_row)
            new_cols.append(v_col)
            new_full.append(v)
            updates.append(-u)
        new_state = {"count": count + 1, "v_row": tree.rebuild(grads, new_rows),
                     "v_col": tree.rebuild(grads, new_cols), "v": tree.rebuild(grads, new_full)}
        return tree.rebuild(grads, updates), new_state

    def state_specs(param_specs_, global_shapes):
        """v_row drops the largest dim of a factored leaf, v_col the second
        largest, and v keeps the leaf's spec where it is not factored."""
        rows, cols, full = [], [], []
        for spec, shape in zip(tree.leaves(param_specs_), tree.leaves(global_shapes)):
            dims = factored_dims(shape)
            if dims is None:
                rows.append((None,))
                cols.append((None,))
                full.append(spec)
            else:
                rows.append(_drop(spec, dims[1]))
                cols.append(_drop(spec, dims[0]))
                full.append((None,))
        return {"count": None, "v_row": tree.rebuild(param_specs_, rows),
                "v_col": tree.rebuild(param_specs_, cols), "v": tree.rebuild(param_specs_, full)}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------


def zero1(optimizer: Optimizer, specs: dict, mesh) -> Optimizer:
    """`optimizer` with its state split over the mesh's dp axis (ZeRO-1, the
    reference's `init_zero1_opt_state`): each parameter-shaped state leaf
    holds this rank's dp slice along the dim `parallel.zero.widen_spec`
    gives its parameter, in memory of its own. An update cuts the summed
    gradient and the parameter of each such leaf to the same slice, runs
    `optimizer`'s update on the slices (adafactor's means and block RMSs
    summing over dp too), and gathers the updates back over dp
    (`collectives.gather`), so the parameters stay replicated. Adam, adamw
    and sgd are elementwise, so their updates equal the unsplit ones bit
    for bit. `specs` are the parameters' (`param_specs`); the state's
    (`state_specs`) name dp where it is split. At dp = 1 it is
    `optimizer`."""
    from ..parallel import zero
    from ..parallel.collectives import gather

    dp = mesh.size("dp")
    if dp == 1:
        return optimizer
    group, index = mesh.group("dp"), mesh.index("dp")

    def on_meta(shapes):
        return tree.tree_map(lambda s: torch.empty(s, device="meta"), shapes)

    def plan(meta, global_shapes):
        """(the state's specs, split over dp, and each parameter leaf's dp
        dim or None) from a state initialized on meta tensors."""
        return zero.zero1_plan(optimizer.init(meta), meta,
                               optimizer.state_specs(specs, global_shapes), specs, dp)

    plans: dict = {}

    def local_plan(params):
        """`plan` for parameters of these local shapes, made once."""
        key = tuple(tuple(p.shape) for p in tree.leaves(params))
        if key not in plans:
            shapes = tree.tree_map(lambda p: tuple(p.shape), params)
            globals_ = tree.tree_map(
                lambda shape, spec: tuple(n * (mesh.size(a) if a else 1)
                                          for n, a in zip(shape, spec)), shapes, specs)
            plans[key] = plan(on_meta(shapes), globals_)
        return plans[key]

    def cut(t, dim):
        return t if dim is None else t.chunk(dp, dim)[index].contiguous()

    def init(params):
        state_specs_, _ = local_plan(params)
        return zero.shard_state(optimizer.init(params), state_specs_, mesh)

    def update(grads, state, params, shards=None):
        del shards  # the dp slices are this wrapper's own
        _, dims = local_plan(params)
        sliced = [[(d, group, dp)] if d is not None else [] for d in dims]
        updates, state = optimizer.update(
            tree.rebuild(grads, [cut(t, d) for t, d in zip(tree.leaves(grads), dims)]), state,
            tree.rebuild(params, [cut(t, d) for t, d in zip(tree.leaves(params), dims)]),
            shards=sliced)
        return tree.rebuild(grads, [t if d is None else gather(t, d, group)
                                    for t, d in zip(tree.leaves(updates), dims)]), state

    def state_specs(param_specs_, global_shapes):
        local = tree.tree_map(
            lambda shape, spec: tuple(n // (mesh.size(a) if a else 1) for n, a in zip(shape, spec)),
            global_shapes, param_specs_)
        return plan(on_meta(local), global_shapes)[0]

    return Optimizer(init, update, state_specs)
