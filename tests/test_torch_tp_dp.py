"""The port's gang train step against the JAX package's shard_map train
step at dp = 2, tp = 1: the cases, tolerances and checks of
tests/test_torch_tp.py (which holds them, at dp = 1, tp = 2), on a mesh of
its own so that each file stays short."""

import pytest
import torch

from test_torch_tp import CASES, check_adamw_steps, check_gradients, check_ranks_agree, gang_runs

DP, TP = 2, 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return gang_runs(DP, TP)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_steps_match_jax(runs, case):
    check_adamw_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, TP)
