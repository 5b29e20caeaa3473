"""The placement solver plane of the port: JobSet's job -> topology-domain
assignment as one batched linear-assignment solve on the card.

`solver.AssignmentSolver` is the surface (the auction in a hand-written
CUDA kernel on the card, its plain PyTorch version on the CPU, scipy's
Hungarian as the host portfolio's fallback); `service` is the gRPC solver
sidecar around it (`python -m jobset_tpu_torch.placement.service`).
"""

from .solver import AssignmentSolver, HostSolve, PendingSolve

__all__ = ["AssignmentSolver", "HostSolve", "PendingSolve"]
