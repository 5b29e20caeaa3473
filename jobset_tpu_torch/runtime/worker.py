"""Per-pod container entry point of the port:

    python -m jobset_tpu_torch.runtime.worker --workload-file f.json [--cpu]
        [--backend nccl|gloo] [--profile-dir DIR]

It reads the workload payload from `--workload-file` or `$JOBSET_WORKLOAD`
(JSON), joins its gang from the rendezvous environment
(`runtime.distributed`; without the environment it runs standalone, a
gang of one) on `torch.distributed` (`--backend`: "nccl" on the card,
"gloo" with `--cpu`; ranks that share one card pass "gloo"), lays the
five-axis mesh over the gang's ranks (the payload's `mesh`, or
`default_mesh_config` of the gang's size, tp first), runs
`runner.train_workload` on the card (the CPU with `--cpu`), whatever kind
the payload names ("lm", "mlp", "cnn"; "mlp" when absent; an lm over dp, pp,
ep, sp and tp, with `"zero1": true` its optimizer state split over dp), and
prints one
JSON result line: the gang's `world`, its `devices` (one a process),
the `mesh`, the losses, and the flash block and grouped kernels this
process launched (0 on the CPU). Exit codes: 0 on success, 1 on a
WorkloadFailure (the JobSet failure policy then decides between failing
and a gang restart), 2 when there is no workload or the mesh does not
cover the gang.

The gang-restart counter arrives as `$JOBSET_RESTART_ATTEMPT`:
`fail_at_step` fires only on attempt 0, and a restarted run resumes from
its latest checkpoint. With `--profile-dir`, a gang's processes trace into
`process_<id>` subdirectories of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .distributed import ENV_RESTART_ATTEMPT, ENV_WORKLOAD

# The kernel launch counters the result line reports, by module.
_FLASH_COUNTERS = ("KERNEL_LAUNCHES", "TENSOR_CORE_LAUNCHES", "F32_LAUNCHES",
                   "TILE_CLASS_LAUNCHES", "BACKWARD_LAUNCHES", "BACKWARD_F32_LAUNCHES",
                   "BACKWARD_F32_MMA_LAUNCHES")
_GROUPED_COUNTERS = ("GROUPED_LAUNCHES", "GROUPED_TMA_LAUNCHES", "GROUPED_F32_LAUNCHES",
                     "GROUPED_DGRAD_LAUNCHES", "GROUPED_WGRAD_LAUNCHES",
                     "GROUPED_WGRAD_F32_LAUNCHES", "GROUPED_WGRAD_TMA_LAUNCHES")


def kernel_launches() -> dict:
    """This process's flash block and grouped kernel launches so far."""
    from ..ops import flash_block, grouped_matmul

    return {**{name: getattr(flash_block, name) for name in _FLASH_COUNTERS},
            **{name: getattr(grouped_matmul, name) for name in _GROUPED_COUNTERS}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload-file",
                        help=f"path to a JSON workload payload (default: ${ENV_WORKLOAD})")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card (tests, laptops)")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        help="the process group's backend (default: nccl on the card, "
                             "gloo with --cpu)")
    parser.add_argument("--profile-dir",
                        help="write a torch.profiler trace of the training run here "
                             "(a process_<id> subdirectory each in a gang)")
    args = parser.parse_args(argv)

    if args.workload_file:
        with open(args.workload_file) as f:
            workload = json.load(f)
    else:
        raw = os.environ.get(ENV_WORKLOAD)
        if not raw:
            print(f"no workload: set ${ENV_WORKLOAD} or --workload-file", file=sys.stderr)
            return 2
        workload = json.loads(raw)

    import torch

    from ..device import resolve_device
    from ..parallel.mesh import MeshConfig, build_mesh, default_mesh_config
    from .distributed import (
        default_backend,
        initialize,
        rank_from_env,
        shutdown,
        standalone_rank,
    )
    from .runner import WorkloadFailure, check_workload, train_workload

    device = resolve_device("cpu" if args.cpu else None)
    check_workload(workload)  # an unknown kind or axis raises before the rendezvous
    try:
        rank = rank_from_env()
    except KeyError:
        rank = standalone_rank()  # no rendezvous contract: one process
    world = rank.total_processes
    spec = workload.get("mesh")
    mesh_cfg = MeshConfig(**spec) if spec else default_mesh_config(world)
    if mesh_cfg.num_devices != world:
        # One process a device: a mesh that does not cover the gang would
        # park processes outside it (or need devices it does not have).
        print(f"workload mesh {dict(spec or {})} covers {mesh_cfg.num_devices} devices but "
              f"the gang has {world}; size the mesh to the gang", file=sys.stderr)
        return 2
    if device.type == "cuda":
        device = torch.device("cuda", rank.process_id % torch.cuda.device_count())

    restarts = int(os.environ.get(ENV_RESTART_ATTEMPT, "0"))
    if args.profile_dir and not workload.get("profile_dir"):
        workload["profile_dir"] = (os.path.join(args.profile_dir, f"process_{rank.process_id}")
                                   if world > 1 else args.profile_dir)
    initialize(rank, backend=args.backend or default_backend(device), device=device)
    try:
        mesh = build_mesh(mesh_cfg, device)
        losses = train_workload(workload, device, mesh, restarts=restarts)
    except WorkloadFailure as exc:
        print(json.dumps({"process_id": rank.process_id, "failed": str(exc),
                          "restart_attempt": restarts}), flush=True)
        return 1
    finally:
        shutdown()

    print(json.dumps({
        "process_id": rank.process_id,
        "world": world,
        "devices": world,
        "mesh": mesh.shape,
        "steps": len(losses),
        "initial_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "losses": list(losses),
        "val_losses": losses.val_losses,
        "kernel_launches": kernel_launches(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
