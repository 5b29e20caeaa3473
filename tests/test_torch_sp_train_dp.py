"""The port's gang train step with sequence parallelism against the JAX
package's shard_map train step at (dp 2, sp 2): the cases, tolerances and
checks of tests/test_torch_sp_train.py (which holds them, at sp 2), on a
mesh of its own so that each file stays short."""

import pytest
import torch

from test_torch_sp_train import (
    CASES,
    check_adamw_steps,
    check_gradients,
    check_ranks_agree,
    gang_runs,
)

MESH = {"dp": 2, "sp": 2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return gang_runs(MESH)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_steps_and_eval_match_jax(runs, case):
    check_adamw_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, MESH)
