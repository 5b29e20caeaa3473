"""gRPC solver sidecar of the port: the server side of the controller <->
card bridge.

    python -m jobset_tpu_torch.placement.service --addr HOST:PORT [--cpu]

A grpc server process owns an `AssignmentSolver` on the card and serves the
control plane's `RemoteAssignmentSolver` (which stays with the control
plane) over the same wire as `jobset_tpu/placement/service.py`: the frames
below are byte for byte the reference's, and the method names are its.
Before it announces readiness, the entry solves one problem of the
smallest bucket on its device, so the kernel is built and loaded before
the first request. Without a CUDA device it raises unless given `--cpu`.

Wire format: a fixed struct header + raw array bytes (no protobuf codegen).

* ``Solve``       unary  - one [J, D] problem        -> [J] assignment
* ``SolveBatch``  unary  - one [B, J, D] problem set -> [B, J] assignments
* ``SolveStream`` bidi   - a long-lived stream of problems
"""

from __future__ import annotations

import argparse
import signal
import struct
import sys
import time
from concurrent import futures
from typing import Iterator, Optional

import numpy as np

SERVICE = "jobset.placement.Solver"

# Header: magic, version, ndim, then up to 3 dims (unused dims = 1).
_MAGIC = 0x4A53  # "JS"
_HEADER = struct.Struct("<HBBIII")


def pack_problem(cost: np.ndarray, feasible: Optional[np.ndarray]) -> bytes:
    """Frame one solve problem: header + cost float32 bytes + feasible u8."""
    cost = np.ascontiguousarray(cost, np.float32)
    ndim = cost.ndim
    if ndim not in (2, 3):
        raise ValueError(f"cost must be [J,D] or [B,J,D], got ndim={ndim}")
    dims = (1,) * (3 - ndim) + cost.shape
    if feasible is None:
        feasible = np.ones(cost.shape, bool)
    feas = np.ascontiguousarray(feasible, np.uint8)
    if feas.shape != cost.shape:
        raise ValueError("feasible shape must match cost shape")
    return _HEADER.pack(_MAGIC, 1, ndim, *dims) + cost.tobytes() + feas.tobytes()


def unpack_problem(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of `pack_problem`; returns (cost, feasible) with original ndim."""
    magic, version, ndim, b, j, d = _HEADER.unpack_from(data)
    if magic != _MAGIC or version != 1:
        raise ValueError("bad solver frame header")
    count = b * j * d
    off = _HEADER.size
    cost = np.frombuffer(data, np.float32, count, off).reshape(b, j, d)
    feas = np.frombuffer(data, np.uint8, count, off + 4 * count).reshape(b, j, d)
    if ndim == 2:
        cost, feas = cost[0], feas[0]
    return cost.copy(), feas.astype(bool)


def pack_assignment(assignment: np.ndarray) -> bytes:
    assignment = np.ascontiguousarray(assignment, np.int64)
    ndim = assignment.ndim
    if ndim == 1:
        dims = (1, assignment.shape[0], 1)
    elif ndim == 2:
        dims = (assignment.shape[0], assignment.shape[1], 1)
    else:
        raise ValueError("assignment must be [J] or [B,J]")
    return _HEADER.pack(_MAGIC, 1, ndim, *dims) + assignment.tobytes()


def unpack_assignment(data: bytes) -> np.ndarray:
    magic, version, ndim, b, j, _ = _HEADER.unpack_from(data)
    if magic != _MAGIC or version != 1:
        raise ValueError("bad assignment frame header")
    out = np.frombuffer(data, np.int64, b * j, _HEADER.size).reshape(b, j)
    return out[0].copy() if ndim == 1 else out.copy()


def _identity(b: bytes) -> bytes:
    return b


class SolverService:
    """Server-side handler: owns the solver, services (streamed) solves.
    With no solver given it makes an `AssignmentSolver` on the card."""

    def __init__(self, solver=None, max_iters: int = 20000):
        if solver is None:
            from .solver import AssignmentSolver

            solver = AssignmentSolver(max_iters=max_iters)
        self.solver = solver

    def _solve_frame(self, data: bytes) -> bytes:
        cost, feasible = unpack_problem(data)
        if cost.ndim == 2:
            assignment = self.solver.solve(cost, feasible)
        else:
            assignment = self.solver.solve_batch(cost, feasible)
        return pack_assignment(assignment)

    # grpc handler signatures: (request, context) / (request_iterator, context)
    def solve(self, request: bytes, context) -> bytes:
        return self._solve_frame(request)

    def solve_stream(self, request_iterator: Iterator[bytes], context) -> Iterator[bytes]:
        for request in request_iterator:
            yield self._solve_frame(request)

    def handlers(self):
        import grpc

        def unary():
            return grpc.unary_unary_rpc_method_handler(
                self.solve, request_deserializer=_identity, response_serializer=_identity
            )

        return grpc.method_handlers_generic_handler(SERVICE, {
            "Solve": unary(),
            "SolveBatch": unary(),
            "SolveStream": grpc.stream_stream_rpc_method_handler(
                self.solve_stream, request_deserializer=_identity,
                response_serializer=_identity,
            ),
        })


class SolverServer:
    """Lifecycle wrapper: bind, serve, drain. `address` like "127.0.0.1:0"
    (port 0 -> kernel-assigned; read back from `.port`)."""

    def __init__(self, address: str = "127.0.0.1:0", solver=None, credentials=None):
        import grpc

        self.service = SolverService(solver=solver)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            options=[
                ("grpc.max_receive_message_length", 256 * 1024 * 1024),
                ("grpc.max_send_message_length", 256 * 1024 * 1024),
            ],
        )
        self._server.add_generic_rpc_handlers((self.service.handlers(),))
        if credentials is not None:
            self.port = self._server.add_secure_port(address, credentials)
        else:
            self.port = self._server.add_insecure_port(address)
        if self.port == 0:
            raise RuntimeError(f"solver sidecar failed to bind {address}")
        host = address.rsplit(":", 1)[0]
        self.address = f"{host}:{self.port}"

    def start(self) -> "SolverServer":
        self._server.start()
        return self

    def wait(self, timeout: Optional[float] = None):
        self._server.wait_for_termination(timeout)

    def stop(self, grace: float = 1.0):
        self._server.stop(grace).wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the placement solver sidecar (gRPC)")
    parser.add_argument("--addr", default="127.0.0.1:8500")
    parser.add_argument("--max-iters", type=int, default=20000)
    parser.add_argument("--cpu", action="store_true",
                        help="solve on the CPU (the plain version) instead of the card")
    args = parser.parse_args(argv)

    from .solver import AssignmentSolver

    device = "cpu" if args.cpu else None
    solver = AssignmentSolver(max_iters=args.max_iters, device=device)
    # Build and load the kernel on the smallest bucket before announcing
    # readiness, so the first request pays no build. Pinned to the device:
    # the routed solver would send a problem this small to the host.
    AssignmentSolver(max_iters=args.max_iters, backend="default", device=device).solve(
        np.zeros((1, 1), np.float32))
    server = SolverServer(args.addr, solver=solver).start()
    print(f"solver sidecar listening on {server.address}", flush=True)
    stopped = []
    signal.signal(signal.SIGTERM, lambda *a: stopped.append(1))
    try:
        while not stopped:
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
