"""Expert parallelism beside dp under ZeRO-1, (dp 2, ep 2) on a gang of
four on the CPU, against the JAX shard_map step with its state placed by
`init_zero1_opt_state`: dropless, capacity (dropping, and with
`accum_steps` 2, each chunk of a rank's rows routed on its own) and
expert choice under zero1 adamw (the first step's gradients, kept in
the dp-split state and gathered, at tests/test_torch_tp.py's bounds),
and dropless under zero1 adafactor (its block RMSs sum over dp and ep);
losses, parameters and the eval loss as tests/test_torch_ep_train.py
holds them."""

import pytest
import torch

from test_torch_ep_train import (
    ROUTERS,
    check_gradients,
    check_ranks_agree,
    check_steps,
    gang_runs,
)

MESH = {"dp": 2, "ep": 2}
ADAMW = {"dropless": ("dropless", 1), "capacity_drop_accum2": ("capacity_drop", 2),
         "expert_choice": ("expert_choice", 1)}
CASES = {name: (ROUTERS[router], "adamw", True, accum)
         for name, (router, accum) in ADAMW.items()}
CASES["dropless_adafactor"] = (ROUTERS["dropless"], "adafactor", True, 1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return gang_runs(MESH, CASES)


@pytest.mark.parametrize("case", sorted(ADAMW))
def test_zero1_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero1_steps_and_eval_match_jax(runs, case):
    check_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, MESH)
