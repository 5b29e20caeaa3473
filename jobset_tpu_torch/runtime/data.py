"""Host -> device input pipeline with prefetching, and the memory-mapped
token corpus of the LM workload (the port's own copy of
`jobset_tpu/runtime/data.py`'s numpy path: the same windows from the same
seed).

On the card a batch is copied from pinned host memory with
`non_blocking=True`, so the copy is queued on the current stream and the
host goes on; `prefetching_fn` keeps the next batches' copies in flight
behind the running step.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def place_batch(batch: dict, device) -> dict:
    """A host batch (a dict of numpy arrays or tensors) as tensors on
    `device`. To the card the copies come from pinned memory and do not
    block the host."""
    device = torch.device(device)

    def put(x):
        t = torch.as_tensor(x)
        if device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return {name: put(x) for name, x in batch.items()}


def device_batches(batches: Iterable[dict], device, prefetch: int = 2) -> Iterator[dict]:
    """Yield device-resident batches, keeping `prefetch` copies in flight."""
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    queue: collections.deque = collections.deque()
    it = iter(batches)
    for batch in itertools.islice(it, prefetch):
        queue.append(place_batch(batch, device))
    while queue:
        ready = queue.popleft()
        nxt = next(it, _SENTINEL)
        if nxt is not _SENTINEL:
            queue.append(place_batch(nxt, device))
        yield ready


def prefetching_fn(make_batch: Callable[[int], Any], device, prefetch: int = 2,
                   start: int = 0, stop: Optional[int] = None) -> Callable[[int], dict]:
    """Adapt `make_batch(step) -> host batch` into a function whose batches
    are on `device` and prefetched ahead of the requested step. Steps must
    be requested in order from `start`; `stop` bounds the producer so no
    batch is made past the last step."""
    steps = itertools.count(start) if stop is None else iter(range(start, stop))
    source = device_batches((make_batch(s) for s in steps), device, prefetch)
    expected = itertools.count(start)

    def fetch(step: int) -> dict:
        want = next(expected)
        if step != want:
            raise ValueError(
                f"prefetching_fn serves steps in order: expected {want}, got {step}"
            )
        return next(source)

    return fetch


def sequence_shard(seq_len: int, sp: int, index: int) -> slice:
    """The positions of a [B, seq_len] batch that sp rank `index` holds: the
    index-th of sp contiguous chunks (the ring's layout)."""
    if seq_len % sp:
        raise ValueError(f"seq_len {seq_len} not divisible by sp {sp}")
    chunk = seq_len // sp
    return slice(index * chunk, (index + 1) * chunk)


class TokenDataset:
    """Memory-mapped flat file of token ids -> deterministic [B, seq_len+1]
    windows. batch(step) seeds a fresh generator from (seed, step), so a run
    resumed at step k sees the batches an uninterrupted run would have.
    `rank`/`world` keep this process's contiguous slice of the rows."""

    def __init__(self, path: str, seq_len: int, batch_size: int, dtype: str = "uint16",
                 seed: int = 0, rank: int = 0, world: int = 1, vocab_size: int = 0):
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} not divisible by world {world}")
        self.tokens = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        if len(self.tokens) < seq_len + 1:
            raise ValueError(
                f"corpus {path} has {len(self.tokens)} tokens; need at least "
                f"seq_len+1 = {seq_len + 1}"
            )
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.rank = rank
        self.world = world
        self.vocab_size = vocab_size

    def batch(self, step: int) -> dict:
        """{"inputs", "targets"} int32 [batch_size/world, seq_len], targets
        shifted one token right."""
        rng = np.random.default_rng((self.seed, step))
        # The last valid start is len - seq_len - 1: a window is seq_len + 1
        # tokens (inputs and shifted targets).
        starts = rng.integers(0, len(self.tokens) - self.seq_len, size=self.batch_size)
        local = self.batch_size // self.world
        starts = starts[self.rank * local:(self.rank + 1) * local]
        windows = np.stack(
            [np.asarray(self.tokens[s:s + self.seq_len + 1]) for s in starts]
        ).astype(np.int32)
        if self.vocab_size and int(windows.max()) >= self.vocab_size:
            raise ValueError(
                f"corpus contains token id {int(windows.max())} >= the model's "
                f"vocab_size {self.vocab_size}: out-of-vocab ids would embed as zeros"
            )
        return {"inputs": np.ascontiguousarray(windows[:, :-1]),
                "targets": np.ascontiguousarray(windows[:, 1:])}


def write_token_file(path: str, tokens, dtype: str = "uint16") -> None:
    """Write a flat token-id array in TokenDataset's binary layout."""
    np.asarray(tokens, dtype=np.dtype(dtype)).tofile(path)
