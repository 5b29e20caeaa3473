"""A gang of local processes on `torch.distributed`: `spawn(fn, world,
args)` starts `world` processes (the "spawn" start method), each joins a
process group on a free loopback port and runs `fn(*args)`, and the
results come back by rank. A rank that raises fails the whole call with
its traceback, and a gang past `timeout_s` is killed and raises: a hung
gang fails one call instead of holding its caller. No backend is swapped
on a failure.

`wait_or_kill` is the one wait of every launcher of a gang (`spawn`, and
`runner.WorkloadRunner`'s worker processes): each process until a shared
deadline, the rest killed soon after one exits nonzero (its peers would
otherwise wait in a collective until the rendezvous timeout), and every
process still running killed on the way out.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback

from .distributed import RankInfo, free_port, initialize, shutdown

# How long the other ranks of a gang may run on once one has exited
# nonzero: long enough for ranks failing at the same step to report.
FAILED_PEER_GRACE_S = 10.0


def _exit_code(proc):
    """The exit code of a `multiprocessing.Process` or a `subprocess.Popen`,
    or None while it runs."""
    return proc.poll() if hasattr(proc, "poll") else proc.exitcode


def _reap(proc) -> None:
    if hasattr(proc, "poll"):
        proc.wait()
    else:
        proc.join()


def wait_or_kill(procs: list, timeout_s: float) -> list | None:
    """Wait for every process of a gang: their exit codes, or None where
    the gang ran past `timeout_s`. Once a process exits nonzero the others
    get FAILED_PEER_GRACE_S more; every process still running when this
    returns or raises is killed."""
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [_exit_code(p) for p in procs]
            if all(c is not None for c in codes):
                return codes
            now = time.monotonic()
            if now >= deadline:
                return None
            if any(c not in (None, 0) for c in codes):
                deadline = min(deadline, now + FAILED_PEER_GRACE_S)
            time.sleep(0.05)
    finally:
        for proc in procs:
            if _exit_code(proc) is None:
                proc.kill()
                _reap(proc)


def _rank_main(fn, rank, world, port, backend, device, threads, args, out_path):
    import torch

    if threads:
        torch.set_num_threads(threads)
    failed_at = None  # when fn raised: its peers may fail later on its account
    try:
        initialize(RankInfo("", "", 0, 0, rank, world, 0, world, f"127.0.0.1:{port}"),
                   backend=backend, device=device)
        try:
            result = (True, fn(*args), None)
        except BaseException:
            failed_at = time.time()
            raise
        finally:
            shutdown()
    except BaseException:
        result = (False, traceback.format_exc(), failed_at or time.time())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    if not result[0]:
        raise SystemExit(1)


def spawn(fn, world: int, args=(), backend: str = "gloo", device=None,
          timeout_s: float = 180.0, threads: int = 1) -> list:
    """fn(*args) on each rank of a gang of `world` fresh processes on
    `device` (the card unless the caller names the CPU); returns the ranks'
    results in rank order. `fn` must be importable (a module's top-level
    function) and its result picklable. `threads` caps each rank's torch
    threads (0: torch's default)."""
    import torch.multiprocessing as mp

    from ..device import resolve_device

    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{rank}.pkl") for rank in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, world, port, backend, str(device), threads, args,
                                   paths[rank]), daemon=True)
                 for rank in range(world)]
        for proc in procs:
            proc.start()
        codes = wait_or_kill(procs, timeout_s)
        results = [_load(path) for path in paths]
    failed = [(result[2], rank) for rank, result in enumerate(results)
              if result is not None and not result[0]]
    if failed:  # the first to fail: its peers may fail on its account
        rank = min(failed)[1]
        raise RuntimeError(f"rank {rank} of a gang of {world} failed:\n{results[rank][1]}")
    if codes is None:
        missing = [rank for rank, result in enumerate(results) if result is None]
        raise RuntimeError(f"gang of {world}: ranks {missing} did not finish within "
                           f"{timeout_s} s")
    bad = [rank for rank, code in enumerate(codes) if code != 0 or results[rank] is None]
    if bad:
        raise RuntimeError(f"rank {bad[0]} of a gang of {world} exited {codes[bad[0]]}")
    return [result[1] for result in results]


def _load(path):
    """A rank's (ok, value, when), or None where it wrote none."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
