"""The port's serving over a dp x tp mesh against the JAX package's
`build_generate` at dp = 2, tp = 2: the cases and checks of
tests/test_torch_serve_mesh.py (which holds them, at tp = 2), on a mesh of
its own so that each file stays short. Greedy tokens identical to JAX's
for every model and int8 variant, top_k 1 equal to greedy, and every rank
drawing noise of its own."""

import pytest
import torch

from test_torch_serve_mesh import (
    GREEDY,
    check_own_noise,
    check_tokens,
    check_top_k_one_is_greedy,
    gang_runs,
)

DP, TP = 2, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return gang_runs(DP, TP)


@pytest.mark.parametrize("name", GREEDY)
def test_greedy_tokens_match_jax(runs, name):
    check_tokens(runs, name)


def test_top_k_one_equals_greedy(runs):
    check_top_k_one_is_greedy(runs)


def test_each_rank_draws_its_own_noise(runs):
    check_own_noise(runs)
