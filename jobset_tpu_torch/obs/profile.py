"""Kernel-family telemetry: compile, cache and transfer accounting.

Counterpart of the JIT/kernel half of `jobset_tpu/obs/profile.py`
(`KernelCacheRegistry`, `KERNEL_CACHES`, `timed_compile`, `jit_shape_call`,
`note_transfer`), feeding the same `jobset_jit_*` families under the same
kernel names. The compile-once bucket factories (queue scorer, columnar
aggregate, policy MLP) wrap each bucket's device call in
:func:`timed_compile` and register their ``lru_cache`` handles with
:data:`KERNEL_CACHES`, so the ``jobset_jit_cache_{hits,misses}`` gauges read
``cache_info()`` at collect time; the solver's four auction entry points
go through :func:`jit_shape_call`; :func:`note_transfer` counts the
host<->device bytes at the call sites (``jobset_jit_transfer_bytes_total``).

What a "compile" is here: PyTorch has no trace-and-compile step, so a
kernel family's first call at a shape stands in for it. On the card that
call holds the hand kernel's load (and its ``nvcc`` build, where
``ops/cuda_build.py`` has not built it yet in this process), the caching
allocator's first blocks at that shape and the first launch, timed to the
device's end; ``jobset_jit_compile_seconds`` measures that. On the CPU it
is the first call's wall time. Later calls at the shape pay one set
membership test (or one boolean) and no device wait.

The reference's continuous stack profiler (``StackProfiler``) samples the
controller's threads and stays with the control plane.
"""

from __future__ import annotations

import functools
import threading
import time

import torch

from ..core import metrics


class KernelCacheRegistry:
    """Named ``lru_cache`` handles of the compile-once kernel factories,
    bound to the ``jobset_jit_cache_{hits,misses}`` callback gauges so a
    scrape reads live ``cache_info()`` — no push sites to forget."""

    def __init__(self):
        self._caches: dict[str, object] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def register(self, kernel: str, cached_factory) -> None:
        with self._lock:
            self._caches[kernel] = cached_factory
        # (Re)bind on every registration: metrics.reset() drops bindings.
        metrics.jit_cache_hits.bind(self, KernelCacheRegistry._hits)
        metrics.jit_cache_misses.bind(self, KernelCacheRegistry._misses)

    def _info(self) -> list[tuple[str, object]]:
        with self._lock:
            items = sorted(self._caches.items())
        out = []
        for kernel, factory in items:
            info = getattr(factory, "cache_info", None)
            if info is not None:
                out.append((kernel, info()))
        return out

    def _hits(self) -> list[tuple[tuple, float]]:
        return [((kernel,), float(info.hits))
                for kernel, info in self._info()]

    def _misses(self) -> list[tuple[tuple, float]]:
        return [((kernel,), float(info.misses))
                for kernel, info in self._info()]

    def snapshot(self) -> dict[str, dict]:
        """Per-kernel cache stats."""
        return {
            kernel: {
                "hits": info.hits, "misses": info.misses,
                "maxsize": info.maxsize, "currsize": info.currsize,
            }
            for kernel, info in self._info()
        }


KERNEL_CACHES = KernelCacheRegistry()


def timed_compile(kernel: str, fn):
    """Wrap one bucket's device call so its first invocation — the
    family's "compile" at that bucket (module docstring) — is timed to the
    device's end into ``jobset_jit_compile_seconds{kernel}`` and counted in
    ``jobset_jit_compiles_total{kernel}``. Factories call this per
    specialization (inside the lru_cached body), so every bucket miss
    surfaces its first-call cost; later calls pay one boolean check."""
    state = {"pending": True}
    lock = threading.Lock()

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with lock:
            first, state["pending"] = state["pending"], False
        if not first:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _block(out)
        elapsed = time.perf_counter() - t0
        metrics.jit_compiles_total.inc(kernel)
        metrics.jit_compile_seconds.observe(elapsed, kernel)
        return out

    return wrapper


_SEEN_SHAPES: dict[str, set] = {}  # guarded-by: _SEEN_LOCK
_SEEN_LOCK = threading.Lock()


def jit_shape_call(kernel: str, fn, *args, **kwargs):
    """Call ``fn``, treating its first call per (shapes, dtypes, device,
    kwargs) signature as the family's compile and timing it, to the
    device's end, into the ``jobset_jit_*`` families. The signature is the
    reference's, with the shape and dtype objects kept as they are (the
    reference turns them into a tuple and a string), and the device of the
    first argument that has a shape added: one launch's tensors share a
    device, and a first launch on the card is a first call whatever ran
    on the CPU before. An argument without a shape enters by ``repr``. For
    kernels without a bucket factory (the solver's auctions). Returns
    ``(fn's result, first)``: ``first`` tells the caller that this call
    was the compile."""
    sig_parts: list = []
    device = None
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is None:
            sig_parts.append(repr(a))
            continue
        if device is None:
            device = getattr(a, "device", None)
        sig_parts.append((shape, getattr(a, "dtype", None)))
    sig = (device, tuple(sig_parts), tuple(sorted(kwargs.items())))
    with _SEEN_LOCK:
        seen = _SEEN_SHAPES.setdefault(kernel, set())
        first = sig not in seen
        seen.add(sig)
    if not first:
        return fn(*args, **kwargs), False
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _block(out)
    elapsed = time.perf_counter() - t0
    metrics.jit_compiles_total.inc(kernel)
    metrics.jit_compile_seconds.observe(elapsed, kernel)
    return out, True


def _block(out) -> None:
    """Wait until the device has finished ``out`` (a tensor, or a tuple or
    list of them), so first-call timing covers the work and not only its
    launch: an event recorded on the current stream of each CUDA tensor's
    device, then synchronized. CPU tensors are done when returned."""
    if isinstance(out, (tuple, list)):
        for item in out:
            _block(item)
        return
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        event.synchronize()


def note_transfer(kernel: str, direction: str, *arrays) -> None:
    """Account host<->device bytes at a kernel boundary
    (``direction`` is ``h2d`` or ``d2h``): the ``nbytes`` of the numpy
    arrays or tensors actually crossing it."""
    total = 0
    for a in arrays:
        total += int(getattr(a, "nbytes", 0) or 0)
    if total:
        metrics.jit_transfer_bytes_total.inc(
            kernel, direction, amount=float(total)
        )
