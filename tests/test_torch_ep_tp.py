"""Expert parallelism beside tensor parallelism, (ep 2, tp 2) on a gang of
four on the CPU, against the JAX shard_map step: every router of
tests/test_torch_ep_train.py (each expert's d_ff_expert columns split
over tp, its outputs summed over (ep, tp)), held there, at its bounds."""

import pytest
import torch

from test_torch_ep_train import (
    ROUTERS,
    check_gradients,
    check_ranks_agree,
    check_steps,
    gang_runs,
)

MESH = {"ep": 2, "tp": 2}
CASES = {name: (overrides, "adamw", False, 1) for name, overrides in ROUTERS.items()}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return gang_runs(MESH, CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_steps_and_eval_match_jax(runs, case):
    check_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, MESH)
