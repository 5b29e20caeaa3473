"""The pipeline loop (`drive`) in one process (pp = 1) against the JAX package's
train step on one device, on the CPU: 2 microbatches under gpipe, and the
interleave (pipeline_virtual 2) at pp = 1, where the wrap from the last
chunk to the next is this rank's own. n_layers 4, dense (GQA, a masked
batch, remat "full"); the first step's gradients and loss, the losses of
2 adamw steps and the parameters after them, and the eval loss, at the
bounds of tests/test_torch_tp.py."""

import jax
import numpy as np
import pytest
import torch

from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.runtime import optim

import torch_gang_bodies as bodies
from test_torch_pp_train import DENSE, PP_BASE, _eval_batch, _jax_run
from test_torch_tp import LOSS_RTOL, LR, _adam_close, _batches, _close


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SINGLE = {
    "gpipe_2_micro": (dict(DENSE, n_microbatches=2), True),
    "interleaved_pp1": (dict(DENSE, n_microbatches=2, pipeline_schedule="interleaved",
                             pipeline_virtual=2), True),
}


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_one_process_pipeline_matches_jax(case):
    overrides, masked = SINGLE[case]
    start, want_grads, want_loss, want_losses, want_params, want_eval = _jax_run(
        overrides, masked, {})
    cfg = ttf.TransformerConfig(**dict(PP_BASE, **overrides, dtype=torch.float32))
    params = params_from_jax(start)
    kept = bodies.grads_optimizer(optim.adamw(LR))
    step = ttf.build_train_step(cfg, kept, device="cpu")
    state, losses = kept.init(params), []
    for batch in _batches(masked):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[0], want_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for path, (g, w) in enumerate(zip(tree.leaves(state["g"]), jax.tree.leaves(want_grads))):
        _close(g, w, f"gradient leaf {path}")
    for path, (p, w) in enumerate(zip(tree.leaves(params), jax.tree.leaves(want_params))):
        _adam_close(p, w, f"parameter leaf {path}")
    evaluated = float(ttf.build_eval_step(cfg, "cpu")(params, _eval_batch()))
    np.testing.assert_allclose(evaluated, want_eval, rtol=LOSS_RTOL)
