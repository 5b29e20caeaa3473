"""The port's gang train step with pipeline parallelism against the JAX
package's shard_map train step at (pp 2, sp 2): 1f1b with the ring
attention (the ring's rotations inside each stage's events, among the sp
peers that share the pp index), and gpipe MoE dropless top-2 (its
statistics pooled over the microbatches, then over sp), with the
tolerances and checks of tests/test_torch_pp_train.py, on a mesh of its
own so that each file stays short."""

import pytest
import torch

from test_torch_pp_train import (
    CASES,
    check_adamw_steps,
    check_gradients,
    check_ranks_agree,
    gang_runs,
)

MESH = {"pp": 2, "sp": 2}
SP_CASES = {"1f1b_ring": (dict(CASES["gpipe_dense"][0], pipeline_schedule="1f1b"), True),
            "gpipe_dropless": CASES["gpipe_dropless"]}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return gang_runs(MESH, SP_CASES)


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(SP_CASES))
def test_adamw_steps_and_eval_match_jax(runs, case):
    check_adamw_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, MESH)
