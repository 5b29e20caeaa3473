"""Expert parallelism beside pipeline parallelism, (pp 2, ep 2) on a gang
of four on the CPU, against the JAX shard_map step: 4 layers, 4
microbatches of one row. Under gpipe dropless and capacity top-2 (their
statistics pooled over a rank's microbatches, then over (dp, sp, ep),
each unit's router seeded with its cotangents); under 1f1b (the
reference refuses token-choice top-k there) soft dispatch and expert
choice, ep a replication axis of the loss as tp is. Held as
tests/test_torch_ep_train.py holds its cases."""

import pytest
import torch

from test_torch_ep_train import (
    ROUTERS,
    check_gradients,
    check_ranks_agree,
    check_steps,
    gang_runs,
)

MESH = {"pp": 2, "ep": 2}
PIPE = dict(n_layers=4, n_microbatches=4)
SCHEDULES = {"gpipe_dropless": ("dropless", "gpipe"),
             "gpipe_capacity_drop": ("capacity_drop", "gpipe"),
             "1f1b_soft": ("soft", "1f1b"), "1f1b_expert_choice": ("expert_choice", "1f1b")}
CASES = {name: (dict(ROUTERS[router], pipeline_schedule=schedule, **PIPE), "adamw", False, 1)
         for name, (router, schedule) in SCHEDULES.items()}


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
