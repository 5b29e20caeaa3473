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
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import tree

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


@dataclass(frozen=True)
class Optimizer:
    """init(params) -> state; update(grads, state, params) -> (updates, state)."""

    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict], tuple]


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

    def update(grads, state, params):
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

    return Optimizer(init, update)


def adam(learning_rate: LearningRate) -> Optimizer:
    """optax.adam with its defaults."""
    return _adam_like(learning_rate, None)


def adamw(learning_rate: LearningRate, weight_decay: float = 1e-4) -> Optimizer:
    """optax.adamw with its defaults and mask=None: every leaf is decayed."""
    return _adam_like(learning_rate, weight_decay)


def sgd(learning_rate: LearningRate, momentum: Optional[float] = None) -> Optimizer:
    """optax.sgd without Nesterov: momentum None keeps no trace (0.0 keeps
    one, multiplied by zero); the trace is g + momentum * trace."""

    def init(params):
        state = {"count": 0}
        if momentum is not None:
            state["trace"] = _zeros(params)
        return state

    def update(grads, state, params):
        del params
        count = state["count"]
        new_state = {"count": count + 1}
        updates = tree.leaves(grads)
        if momentum is not None:
            updates = torch._foreach_mul(tree.leaves(state["trace"]), momentum)
            torch._foreach_add_(updates, tree.leaves(grads))
            new_state["trace"] = tree.rebuild(grads, updates)
        updates = torch._foreach_mul(updates, -_lr(learning_rate, count))
        return tree.rebuild(grads, updates), new_state

    return Optimizer(init, update)
