"""jobset_tpu_torch: the port of jobset_tpu's workload plane to PyTorch
and CUDA on an NVIDIA H100.

`jobset_tpu/` stays the reference; this package imports none of it (nor
JAX). Ported so far: the flagship transformer's single-device forward,
greedy bf16 serving path and training path (train and eval steps,
optimizers, the LM workload runner, the per-pod worker and the model
bench), with the flash block step's forward as a hand-written CUDA kernel
(`ops/csrc/flash_block.cu`) and its recompute backward in torch code.
Entry points run on the card unless the caller passes device="cpu".
"""
