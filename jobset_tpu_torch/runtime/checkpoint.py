"""Checkpoint and resume for the workload plane, on `torch.save`.

The control plane checkpoints nothing: a gang restart recreates every pod
and the workload resumes from its own latest checkpoint. Each step is a
directory `<directory>/<step>/state.pt`, written under a temporary name
and renamed into place, so a reader never sees a half-written step. The
newest `max_to_keep` steps are kept. Saves are synchronous. Orbax
checkpoints of the JAX package are not read.

A gang saves the global state, as orbax saves global arrays: given its
mesh and the state's specs, `save` gathers every tensor over each axis
its spec splits (tp, ep, pp, and dp for a ZeRO-1 optimizer state) and the rank at
every axis's 0 writes it, and every rank waits for the write; `restore`
reads the global state on every rank and cuts each tensor to the rank's
shard. So a checkpoint written at one mesh restores at another (a layer
leaf is stacked [pp, n_layers / pp, ...]: `restack_layers` moves a
checkpoint between pp sizes), and one written with ZeRO-1 restores
without it and the other way round.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

from ..convert import gather_tree, shard_tree

_STATE = "state.pt"


def restack_layers(state: Any, specs: Any, pp: int) -> Any:
    """`state` with each tensor whose spec puts pp on its first dim (a
    layer leaf, or its optimizer state) restacked [pp, n / pp, ...], n the
    product of its first two dims: the layers keep their global order, so
    a global state saved at one pp size reads at another."""
    if isinstance(state, dict):
        return {k: restack_layers(v, specs.get(k) if isinstance(specs, dict) else None, pp)
                for k, v in state.items()}
    if isinstance(state, list):
        return [restack_layers(v, specs[i] if isinstance(specs, list) else None, pp)
                for i, v in enumerate(state)]
    if (torch.is_tensor(state) and isinstance(specs, tuple) and specs and specs[0] == "pp"
            and state.shape[0] != pp):
        return state.reshape(pp, -1, *state.shape[2:])
    return state


class Checkpointer:
    """`mesh` (a `parallel.mesh.Mesh`) and `specs` (the state's tree of specs,
    as `param_specs` gives them; None: nothing sharded) make it a gang's
    checkpointer; without a mesh it is one process's (with `specs`, its
    layer leaves restacked to one stage on restore)."""

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None, specs=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        self.specs = specs
        os.makedirs(self.directory, exist_ok=True)

    def _writes(self) -> bool:
        return self.mesh is None or all(i == 0 for i in self.mesh.coords.values())

    def _barrier(self) -> None:
        if self.mesh is not None and torch.distributed.is_initialized():
            torch.distributed.barrier()

    def _steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.exists(os.path.join(self.directory, name, _STATE)))

    def save(self, step: int, state: Any) -> None:
        """Write `state` (tensors, dicts, numbers) as step `step`, replacing
        a step of that number, then drop the oldest beyond max_to_keep. A
        gang's ranks all call it: the global state is gathered and one rank
        writes it."""
        if self.mesh is not None:
            state = gather_tree(state, self.specs, self.mesh)
        if self._writes():
            self._write(step, state)
        self._barrier()

    def _write(self, step: int, state: Any) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp.{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE), "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self._steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The state saved at `step` (default: the latest), its tensors on
        `map_location` (default: where they were saved)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        path = os.path.join(self.directory, str(step), _STATE)
        state = torch.load(path, map_location=map_location, weights_only=True)
        if self.specs is not None:
            state = restack_layers(state, self.specs,
                                   self.mesh.size("pp") if self.mesh is not None else 1)
        if self.mesh is not None:
            state = shard_tree(state, self.specs, self.mesh)
        return state

    def close(self) -> None:
        """Nothing is in flight: saves finish before they return."""
