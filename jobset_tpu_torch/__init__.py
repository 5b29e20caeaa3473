"""jobset_tpu_torch: the port of jobset_tpu's workload plane, placement
solver plane and control-plane device programs to PyTorch and CUDA on an
NVIDIA H100.

`jobset_tpu/` stays the reference; this package imports none of it (nor
JAX). Ported so far: the flagship transformer's forward, serving path
(greedy or sampled, bf16 or int8) and training path (train and eval steps,
optimizers, the LM workload runner, the per-pod worker and the model
bench), with the flash block step's forward as a hand-written CUDA kernel
(`ops/csrc/flash_block.cu`) and its recompute backward in torch code;
the placement solver (`placement/`: `AssignmentSolver` with the auction as
a hand-written CUDA kernel, `ops/csrc/auction.cu`, and the gRPC solver
sidecar); and the control plane's device programs as torch code (no hand
kernel): the admission scorer (`queue.scorer.score`), the gang-readiness
aggregate (`core.columnar.job_counts`), the placement policy's MLP
(`policy.model.score`) and its trainer (`policy.train.train`,
`python -m jobset_tpu_torch.policy.train --bundles DIR --out CKPT`).
Training and the forward also run as a gang of processes on
`torch.distributed`, one a device, over every axis of the five-axis
mesh (data, pipeline, expert, sequence (ring or Ulysses attention) and
tensor parallel), with ZeRO-1's optimizer state split over dp
(`runtime.worker`, `runtime.WorkloadRunner`, `parallel.mesh`,
`parallel.zero`); serving over its dp and tp axes.
Entry points run on the card unless the caller asks for the CPU
(`device="cpu"`, `--cpu`); with no CUDA device and no such request they
raise. On the card, `python3 chip_smoke.py` drives them all
(`--control-only`: the control plane's programs alone).
"""
