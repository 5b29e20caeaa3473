"""Seeded, byte-deterministic offline trainer for the placement policy, on
the card.

    python -m jobset_tpu_torch.policy.train --bundles DIR --out CKPT \
        [--seed 0] [--epochs 200] [--lr 0.05] [--hidden 32,16] [--cpu]

Counterpart of `jobset_tpu/policy/train.py` (and of its
`jobset-tpu policy train` command): build the corpus from debug bundles
(`dataset.py`) and fit the MLP scorer by full-batch gradient descent on a
masked MSE, with torch autograd on a device (the card unless `--cpu` or
`device="cpu"`; with no CUDA device and neither it raises). Two runs on
one corpus with one seed write byte-identical checkpoints:

* the initial parameters come from ``np.random.default_rng(seed)``, the
  reference's bytes;
* full-batch descent: no shuffling; the batch is padded to a pow2 bucket
  whose rows carry zero weight in the masked loss;
* every operation in the step is deterministic on the card (elementwise
  ops and library reductions; no atomics, no matmul);
* the update is ``p - lr * g``: two roundings, as the reference's;
* no wall clock in the loop, and the checkpoint writer zeroes zip
  timestamps (`model.py`).
"""

from __future__ import annotations

import argparse
import json
import sys
import tarfile

import numpy as np
import torch

from ..device import resolve_device
from .dataset import Dataset, build_dataset, discover_bundles
from .features import FEATURE_DIM
from .model import (
    DEFAULT_HIDDEN,
    PolicyModel,
    _round_up_pow2,
    init_params,
    mlp_forward,
    save_checkpoint,
)


def masked_mse(flat, x, y, mask):
    """The reference's loss: sum((f(x) - y)^2 * mask^2) / max(sum(mask), 1)."""
    err = (mlp_forward(flat, x) - y) * mask
    return (err * err).sum() / torch.clamp_min(mask.sum(), 1.0)


def train_step(flat, x, y, mask, lr: float):
    """One full-batch gradient step: (loss, new flat params)."""
    loss = masked_mse(flat, x, y, mask)
    grads = torch.autograd.grad(loss, flat)
    with torch.no_grad():
        new = [(p - lr * g).requires_grad_() for p, g in zip(flat, grads)]
    return loss.detach(), new


def train(
    dataset: Dataset,
    seed: int = 0,
    epochs: int = 200,
    lr: float = 0.05,
    hidden: tuple[int, ...] = DEFAULT_HIDDEN,
    device=None,
) -> tuple[PolicyModel, dict]:
    """Fit the scorer; returns (model, summary). Deterministic for fixed
    (dataset, seed, epochs, lr, hidden) on one device."""
    device = resolve_device(device)
    x = np.asarray(dataset.features, np.float32)
    y = np.asarray(dataset.labels, np.float32)
    if x.ndim != 2 or x.shape[1] != FEATURE_DIM:
        raise ValueError(
            f"dataset feature width {x.shape} != FEATURE_DIM {FEATURE_DIM}"
        )
    n = x.shape[0]

    feat_mean = x.mean(axis=0).astype(np.float32)
    feat_std = np.maximum(x.std(axis=0), 1e-6).astype(np.float32)
    label_mean = float(y.mean())
    label_std = float(max(y.std(), 1e-9))
    xn = (x - feat_mean) / feat_std
    yn = (y - label_mean) / label_std

    rows_p = _round_up_pow2(n)
    x_pad = np.zeros((rows_p, FEATURE_DIM), np.float32)
    x_pad[:n] = xn
    y_pad = np.zeros(rows_p, np.float32)
    y_pad[:n] = yn
    mask = np.zeros(rows_p, np.float32)
    mask[:n] = 1.0

    if int(epochs) < 1:
        raise ValueError("epochs must be >= 1")
    dims = (FEATURE_DIM, *hidden, 1)
    flat = [torch.from_numpy(a).to(device).requires_grad_()
            for wb in init_params(seed, FEATURE_DIM, hidden) for a in wb]
    x_d, y_d, mask_d = (torch.from_numpy(a).to(device) for a in (x_pad, y_pad, mask))
    losses = []
    for _ in range(int(epochs)):
        loss, flat = train_step(flat, x_d, y_d, mask_d, float(lr))
        losses.append(loss)
    first_loss, last_loss = (float(v) for v in torch.stack([losses[0], losses[-1]]).cpu())

    trained = [
        (flat[2 * i].detach().cpu().numpy(), flat[2 * i + 1].detach().cpu().numpy())
        for i in range(len(dims) - 1)
    ]
    meta = {
        "schema": 1,
        "seed": int(seed),
        "epochs": int(epochs),
        "lr": float(lr),
        "hidden": list(hidden),
        "examples": int(n),
        "corpus": dict(dataset.meta),
    }
    model = PolicyModel(
        params=trained,
        feat_mean=feat_mean,
        feat_std=feat_std,
        label_mean=label_mean,
        label_std=label_std,
        history=dataset.history,
        meta=meta,
    )
    summary = {
        "examples": int(n),
        "epochs": int(epochs),
        "seed": int(seed),
        "lossFirst": round(first_loss, 6),
        "lossFinal": round(last_loss, 6),
        "labelMeanS": round(label_mean, 6),
        "domains": len(dataset.history),
    }
    return model, summary


def train_bundles_to_checkpoint(
    bundles_path: str,
    out_path: str,
    seed: int = 0,
    epochs: int = 200,
    lr: float = 0.05,
    hidden: tuple[int, ...] = DEFAULT_HIDDEN,
    device=None,
) -> dict:
    """Corpus -> trained checkpoint at `out_path`; returns the summary."""
    device = resolve_device(device)
    paths = discover_bundles(bundles_path)
    if not paths:
        raise ValueError(f"no debug bundles (*.tgz) under {bundles_path!r}")
    dataset = build_dataset(paths)
    model, summary = train(
        dataset, seed=seed, epochs=epochs, lr=lr, hidden=hidden, device=device
    )
    save_checkpoint(out_path, model)
    summary["checkpoint"] = out_path
    summary["bundles"] = len(paths)
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="train the placement cost model from debug bundles "
                    "(same corpus + seed = byte-identical checkpoint)")
    parser.add_argument("--bundles", required=True, metavar="DIR",
                        help="directory of debug-bundle .tgz archives (or one bundle file)")
    parser.add_argument("--out", required=True, metavar="CKPT",
                        help="checkpoint path to write (plain npz)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--hidden", default="32,16",
                        help="comma-separated MLP hidden layer widths")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the card")
    args = parser.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    hidden = tuple(int(h) for h in args.hidden.split(",") if h.strip())
    try:
        summary = train_bundles_to_checkpoint(
            args.bundles, args.out, seed=args.seed, epochs=args.epochs,
            lr=args.lr, hidden=hidden, device=device)
    except (ValueError, OSError, tarfile.TarError) as exc:
        # Empty corpus, unreadable or corrupt bundle, bad schemaVersion,
        # unwritable --out: one line, exit 1.
        print(f"policy train: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(summary, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
