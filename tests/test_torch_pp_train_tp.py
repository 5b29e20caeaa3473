"""The port's gang train step with pipeline parallelism against the JAX
package's shard_map train step at (pp 2, tp 2), the mesh of
examples/training/lm-pp-interleaved.yaml: the interleave (pipeline_virtual
2) and 1f1b, dense, with the tolerances and checks of
tests/test_torch_pp_train.py (which holds them at pp 2), on a mesh of its
own so that each file stays short. Under 1f1b the loss head's tp
collectives run inside the last rank's backward events: the gradients
show that no 1/|tp| scale crept in (the reference divides its objective
by the replicated axes' size only because of how shard_map types
values)."""

import pytest
import torch

from test_torch_pp_train import (
    CASES,
    check_adamw_steps,
    check_gradients,
    check_ranks_agree,
    gang_runs,
)

MESH = {"pp": 2, "tp": 2}
TP_CASES = {name: CASES[name] for name in ("interleaved_dense", "1f1b_tied")}
TP_CASES["1f1b_dense"] = (dict(CASES["gpipe_dense"][0], pipeline_schedule="1f1b"), True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def runs():
    return gang_runs(MESH, TP_CASES)


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(TP_CASES))
def test_adamw_steps_and_eval_match_jax(runs, case):
    check_adamw_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, MESH)
