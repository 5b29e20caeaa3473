"""The placement policy's MLP outcome scorer, as torch code on the card,
with deterministic plain-npz checkpoints.

Counterpart of `jobset_tpu/policy/model.py`. The model predicts the
lifecycle outcome (seconds to gang-ready) of placing one job into one
domain from its FEATURE_DIM candidate vector; the placer ranks domains by
predicted outcome, lower is better.

`score` pads its rows to a power-of-two bucket, as the reference's jit
kernel does, and runs `PolicyMLP` on a device; `forward_np` is the plain
version. Each layer's product is a broadcast multiply and a sum over the
input axis, not a matmul: the scorer computes in f32 on any device, and
the process's TF32 setting (which reaches cuBLAS matmuls) cannot lower it.

Checkpoints are plain ``.npz`` files readable by ``numpy.load``, written
through our own zip writer with zeroed timestamps (``np.savez`` stamps
wall-clock mtimes): the same model gives the same bytes, the reference's
writer's bytes included.
"""

from __future__ import annotations

import functools
import io
import json
import zipfile
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..obs import profile
from .features import FEATURE_DIM, FEATURE_NAMES, DomainHistory

# Checkpoint schema major version: load_checkpoint rejects anything else.
CHECKPOINT_SCHEMA = 1

DEFAULT_HIDDEN = (32, 16)


class CheckpointError(Exception):
    """Missing, corrupt, or incompatible policy checkpoint."""


@dataclass
class PolicyModel:
    """Everything the scorer needs: MLP params, feature/label
    normalization, and the per-domain outcome history from the corpus."""

    params: list[tuple[np.ndarray, np.ndarray]]  # [(W, b), ...]
    feat_mean: np.ndarray
    feat_std: np.ndarray
    label_mean: float
    label_std: float
    history: DomainHistory = field(default_factory=DomainHistory)
    meta: dict = field(default_factory=dict)

    @property
    def dims(self) -> tuple[int, ...]:
        return (self.params[0][0].shape[0],) + tuple(
            w.shape[1] for w, _ in self.params
        )


def init_params(
    seed: int, in_dim: int = FEATURE_DIM, hidden: tuple[int, ...] = DEFAULT_HIDDEN
) -> list[tuple[np.ndarray, np.ndarray]]:
    """He-initialized MLP params from a numpy Generator, so the initial
    bytes are independent of the framework and the device (the
    determinism contract covers the whole checkpoint) and equal the
    reference's for one seed."""
    rng = np.random.default_rng(seed)
    dims = (in_dim, *hidden, 1)
    params = []
    for fan_in, fan_out in zip(dims, dims[1:]):
        w = (rng.standard_normal((fan_in, fan_out)) *
             np.sqrt(2.0 / fan_in)).astype(np.float32)
        params.append((w, np.zeros(fan_out, np.float32)))
    return params


def forward_np(params, x: np.ndarray) -> np.ndarray:
    """The plain version, numpy: [N, F] -> [N] normalized scores."""
    h = np.asarray(x, np.float32)
    last = len(params) - 1
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < last:
            h = np.maximum(h, 0.0)
    return h[:, 0]


# ---------------------------------------------------------------------------
# The MLP in torch, and scoring on pow2 row buckets
# ---------------------------------------------------------------------------


def _round_up_pow2(n: int, minimum: int = 8) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def mlp_forward(flat, x: torch.Tensor) -> torch.Tensor:
    """[N, F] -> [N] through the layers of `flat` = [W0, b0, W1, b1, ...]
    (W [in, out]): ReLU between layers, none after the last. Each product
    is a broadcast multiply and a sum over the input axis, in f32 whatever
    the TF32 setting."""
    h = x
    last = len(flat) // 2 - 1
    for i in range(last + 1):
        h = (h.unsqueeze(2) * flat[2 * i]).sum(dim=1) + flat[2 * i + 1]
        if i < last:
            h = torch.relu(h)
    return h[:, 0]


class PolicyMLP(nn.Module):
    """The scorer's MLP on one device, built from a `(W, b)` list. The
    weights travel in one host-to-device copy."""

    def __init__(self, params: list[tuple[np.ndarray, np.ndarray]], device=None):
        super().__init__()
        device = resolve_device(device)
        arrays = [np.asarray(a, np.float32) for wb in params for a in wb]
        packed = torch.from_numpy(np.concatenate([a.ravel() for a in arrays])).to(device)
        tensors, offset = [], 0
        for a in arrays:
            tensors.append(nn.Parameter(
                packed[offset:offset + a.size].view(a.shape), requires_grad=False))
            offset += a.size
        self.flat = nn.ParameterList(tensors)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_forward(list(self.flat), x)


@functools.lru_cache(maxsize=32)
def _kernel(rows_p: int, dims: tuple[int, ...]):
    """The forward of one (row bucket, layer dims) bucket, as the
    reference's compile-once factory keys it: its first call is timed as
    the family's compile (obs/profile.py), and the cache's hits and misses
    are the `jobset_jit_cache_*` gauges' "policy_mlp" series."""

    def kernel(x, *flat):
        return mlp_forward(flat, x)

    return profile.timed_compile("policy_mlp", kernel)


profile.KERNEL_CACHES.register("policy_mlp", _kernel)


def score(
    model: PolicyModel, feats: np.ndarray, backend: str = "torch", device=None
) -> np.ndarray:
    """Predicted outcome SECONDS per candidate row (denormalized; lower is
    better). `backend="torch"` runs the MLP on `device` (the card unless
    the caller names another; with no CUDA device and none named it
    raises), its rows padded to a pow2 bucket; `backend="numpy"` is the
    plain version. The torch path counts its copies as transfers (the
    packed weights and the padded rows in, the scores out); the
    reference's jit path counts none."""
    feats = np.asarray(feats, np.float32)
    if feats.ndim != 2 or feats.shape[1] != model.feat_mean.shape[0]:
        raise ValueError(
            f"feature matrix shape {feats.shape} does not match the "
            f"checkpoint's feature width {model.feat_mean.shape[0]}"
        )
    if backend not in ("torch", "numpy"):
        raise ValueError(f"unknown scoring backend {backend!r}")
    x = (feats - model.feat_mean) / model.feat_std
    if backend == "numpy":
        y = forward_np(model.params, x)
    else:
        mlp = PolicyMLP(model.params, device=device)
        rows = x.shape[0]
        rows_p = _round_up_pow2(rows)
        padded = np.zeros((rows_p, x.shape[1]), np.float32)
        padded[:rows] = x
        profile.note_transfer("policy_mlp", "h2d", *mlp.flat, padded)
        with torch.no_grad():
            out = _kernel(rows_p, model.dims)(
                torch.from_numpy(padded).to(mlp.flat[0].device), *mlp.flat).cpu().numpy()
        profile.note_transfer("policy_mlp", "d2h", out)
        y = out[:rows]
    return y * model.label_std + model.label_mean


# ---------------------------------------------------------------------------
# Checkpoints: deterministic plain npz
# ---------------------------------------------------------------------------


def _write_npz_deterministic(path: str, arrays: dict) -> None:
    """A valid ``.npz`` (numpy.load round-trips it) whose bytes are a pure
    function of the arrays: sorted member order, stored (no deflate —
    compressor versions vary), and the 1980-01-01 zip epoch instead of
    wall-clock mtimes."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for name in sorted(arrays):
            buf = io.BytesIO()
            np.save(buf, np.ascontiguousarray(arrays[name]))
            info = zipfile.ZipInfo(
                f"{name}.npy", date_time=(1980, 1, 1, 0, 0, 0)
            )
            zf.writestr(info, buf.getvalue())


def save_checkpoint(path: str, model: PolicyModel) -> None:
    arrays: dict[str, np.ndarray] = {
        "schema": np.array([CHECKPOINT_SCHEMA], np.int32),
        "layers": np.array(model.dims, np.int32),
        "feat_mean": model.feat_mean.astype(np.float32),
        "feat_std": model.feat_std.astype(np.float32),
        "label_norm": np.array(
            [model.label_mean, model.label_std], np.float32
        ),
    }
    for i, (w, b) in enumerate(model.params):
        arrays[f"w{i}"] = w.astype(np.float32)
        arrays[f"b{i}"] = b.astype(np.float32)
    domains, stats = model.history.to_arrays()
    arrays["hist_domains"] = np.array(domains, dtype="U64")
    arrays["hist_stats"] = stats
    meta = dict(model.meta)
    meta.setdefault("featureNames", list(FEATURE_NAMES))
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8
    )
    _write_npz_deterministic(path, arrays)


def load_checkpoint(path: str) -> PolicyModel:
    """Load + validate a checkpoint; raises CheckpointError on anything
    that is not a compatible policy checkpoint (the active-mode placer
    catches this and falls back to the auction solver)."""
    try:
        with np.load(path, allow_pickle=False) as npz:
            data = {k: npz[k] for k in npz.files}
    except (OSError, ValueError, zipfile.BadZipFile, EOFError) as exc:
        raise CheckpointError(
            f"policy checkpoint {path!r} unreadable: {exc}"
        ) from exc
    try:
        schema = int(data["schema"][0])
        if schema != CHECKPOINT_SCHEMA:
            raise CheckpointError(
                f"policy checkpoint {path!r} has schema {schema}; this "
                f"build understands schema {CHECKPOINT_SCHEMA}"
            )
        dims = tuple(int(d) for d in data["layers"])
        params = []
        for i in range(len(dims) - 1):
            w, b = data[f"w{i}"], data[f"b{i}"]
            if w.shape != (dims[i], dims[i + 1]) or b.shape != (dims[i + 1],):
                raise CheckpointError(
                    f"policy checkpoint {path!r}: layer {i} shape "
                    f"{w.shape}/{b.shape} disagrees with dims {dims}"
                )
            params.append((w.astype(np.float32), b.astype(np.float32)))
        feat_mean = data["feat_mean"].astype(np.float32)
        feat_std = data["feat_std"].astype(np.float32)
        if feat_mean.shape[0] != dims[0] or feat_std.shape[0] != dims[0]:
            raise CheckpointError(
                f"policy checkpoint {path!r}: normalization width "
                f"{feat_mean.shape[0]} != input dim {dims[0]}"
            )
        label_mean, label_std = (float(x) for x in data["label_norm"])
        history = DomainHistory.from_arrays(
            data.get("hist_domains", np.array([], "U64")),
            data.get("hist_stats", np.zeros((0, 3), np.float32)),
        )
        meta = json.loads(bytes(data["meta_json"]).decode()) \
            if "meta_json" in data else {}
    except CheckpointError:
        raise
    except Exception as exc:  # missing keys, bad json, bad dtypes
        raise CheckpointError(
            f"policy checkpoint {path!r} malformed: {exc}"
        ) from exc
    return PolicyModel(
        params=params,
        feat_mean=feat_mean,
        feat_std=np.maximum(feat_std, 1e-6),
        label_mean=label_mean,
        label_std=max(label_std, 1e-9),
        history=history,
        meta=meta,
    )
