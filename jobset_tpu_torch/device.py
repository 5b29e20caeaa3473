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
