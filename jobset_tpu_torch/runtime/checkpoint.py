"""Checkpoint and resume for the workload plane, on `torch.save`.

The control plane checkpoints nothing: a gang restart recreates every pod
and the workload resumes from its own latest checkpoint. Each step is a
directory `<directory>/<step>/state.pt`, written under a temporary name
and renamed into place, so a reader never sees a half-written step. The
newest `max_to_keep` steps are kept. Saves are synchronous. Orbax
checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

_STATE = "state.pt"


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit()
                      and os.path.exists(os.path.join(self.directory, name, _STATE)))

    def save(self, step: int, state: Any) -> None:
        """Write `state` (tensors, dicts, numbers) as step `step`, replacing
        a step of that number, then drop the oldest beyond max_to_keep."""
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
        return torch.load(path, map_location=map_location, weights_only=True)

    def close(self) -> None:
        """Nothing is in flight: saves finish before they return."""
