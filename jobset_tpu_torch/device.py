"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no CUDA device and no explicit request it raises rather
    than run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU"
        )
    return torch.device("cuda")


# The mesh axes the port does not run yet, each with the ROADMAP item (A6's
# step) that ports it.
UNPORTED_AXES = {"ep": "A6 step 6 (expert parallelism)"}


def check_axes(mesh_shape) -> None:
    """Raise NotImplementedError, naming the axis, where a mesh (a payload's
    `mesh` mapping or a MeshConfig) has ep above 1: the port runs dp, pp,
    sp and tp so far."""
    shape = (dict(zip(("dp", "pp", "ep", "sp", "tp"), mesh_shape.shape))
             if hasattr(mesh_shape, "shape") else dict(mesh_shape or {}))
    for axis, item in UNPORTED_AXES.items():
        size = int(shape.get(axis, 1))
        if size != 1:
            raise NotImplementedError(
                f"mesh axis {axis}={size}: the port runs dp, pp, sp and tp so far; {axis} comes "
                f"with ROADMAP {item}"
            )


def backend_label() -> str:
    """The torch backend a health or build-info report names, without
    bringing the card up: "unloaded" while CUDA has not been initialized
    in this process, then "cuda" or "cpu" ("unavailable" if asking
    fails). It reads no environment switch."""
    try:
        if not torch.cuda.is_initialized():
            return "unloaded"
        return "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "unavailable"
