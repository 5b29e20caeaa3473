"""Per-pod container entry point of the port:

    python -m jobset_tpu_torch.runtime.worker --workload-file f.json [--cpu]

It reads the workload payload from `--workload-file` or `$JOBSET_WORKLOAD`
(JSON), accepts the gang from the rendezvous environment (one process so
far; without the environment it runs standalone), runs
`runner.train_workload` on the card (the CPU with `--cpu`) and prints one
JSON result line, which also counts the flash block kernels the run
launched (0 on the CPU). Exit codes: 0 on success, 1 on a WorkloadFailure
(the JobSet failure policy then decides between failing and a gang
restart), 2 when there is no workload.

The gang-restart counter arrives as `$JOBSET_RESTART_ATTEMPT`:
`fail_at_step` fires only on attempt 0, and a restarted run resumes from
its latest checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ENV_WORKLOAD = "JOBSET_WORKLOAD"
ENV_RESTART_ATTEMPT = "JOBSET_RESTART_ATTEMPT"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload-file",
                        help=f"path to a JSON workload payload (default: ${ENV_WORKLOAD})")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the card (tests, laptops)")
    parser.add_argument("--profile-dir",
                        help="write a torch.profiler trace of the training run here")
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

    from ..ops import flash_block
    from .distributed import initialize, rank_from_env, standalone_rank
    from .runner import WorkloadFailure, train_workload

    try:
        rank = rank_from_env()
    except KeyError:
        rank = standalone_rank()  # no rendezvous contract: one process
    rank = initialize(rank)

    restarts = int(os.environ.get(ENV_RESTART_ATTEMPT, "0"))
    if args.profile_dir and not workload.get("profile_dir"):
        workload["profile_dir"] = args.profile_dir
    try:
        losses = train_workload(workload, "cpu" if args.cpu else None, restarts=restarts)
    except WorkloadFailure as exc:
        print(json.dumps({"process_id": rank.process_id, "failed": str(exc),
                          "restart_attempt": restarts}), flush=True)
        return 1

    print(json.dumps({
        "process_id": rank.process_id,
        "world": rank.total_processes,
        "devices": 1,
        "mesh": {axis: 1 for axis in ("dp", "pp", "ep", "sp", "tp")},
        "steps": len(losses),
        "initial_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "val_losses": losses.val_losses,
        "kernel_launches": {name: getattr(flash_block, name) for name in
                            ("KERNEL_LAUNCHES", "TENSOR_CORE_LAUNCHES", "FMA_LAUNCHES",
                             "TILE_CLASS_LAUNCHES")},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
