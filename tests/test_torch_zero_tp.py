"""ZeRO-1 in the port at (dp 2, tp 2) against the JAX package's
`init_zero1_opt_state` step and against its own run without zero1: the
checks and tolerances of tests/test_torch_zero.py (which holds them, at
dp 2), on a mesh of its own so that each file stays short."""

import pytest
import torch

from test_torch_zero import CONFIGS, check_against_plain, check_matches_jax, zero_runs

MESH = {"dp": 2, "tp": 2}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return zero_runs(MESH)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_zero1_step_matches_jax(runs, name):
    check_matches_jax(runs, name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_zero1_against_the_run_without_it(runs, name):
    check_against_plain(runs, name)
