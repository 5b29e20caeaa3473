"""Pipeline parallelism with dp at (dp 2, pp 2), on the CPU:

- the gpipe gang step under ZeRO-1 (`optim.zero1`), adam and adafactor,
  against the JAX step built with `init_zero1_opt_state`, and against the
  gang's run without ZeRO-1, with the checks of tests/test_torch_zero.py
  (adafactor's block RMSs now span both stages' layers: its means and
  RMSs sum over pp as well as dp);
- `widen_spec` at pp 2: dp goes on the layer axis of a stacked leaf
  ("pp", None, ...) where dp divides it, as the reference's
  `_widen_spec` puts it on the global [pp, n_layers / pp, ...] shapes;
- a checkpoint saved at pp 2 restores at pp 1 (a gang of dp 4) and that
  one back at pp 2: the layer leaves are saved global, stacked [pp,
  n_layers / pp, ...], and restacked to the restoring mesh's pp. The
  resumed losses equal an uninterrupted run's within 1e-5 (another
  mesh adds its sums in another order), and the first leg's bit for bit.
"""

import numpy as np
import pytest
import torch

from jobset_tpu.models import TransformerConfig as JaxConfig
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.zero import _widen_spec
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.parallel.mesh import MeshConfig
from jobset_tpu_torch.parallel.zero import widen_spec
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies
from test_torch_tp import BASE, MOE
from test_torch_zero import _spec_pairs
from test_torch_zero import CONFIGS, check_against_plain, check_matches_jax, zero_runs

MESH = {"dp": 2, "pp": 2}


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
def test_zero1_pipeline_step_matches_jax(runs, name):
    check_matches_jax(runs, name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_zero1_pipeline_against_the_run_without_it(runs, name):
    check_against_plain(runs, name)


@pytest.mark.parametrize("overrides", [dict(BASE, n_layers=4), dict(BASE, n_layers=8, **MOE)],
                         ids=["dense", "moe"])
def test_widen_spec_at_pp_2_matches_the_reference(overrides):
    tcfg = ttf.TransformerConfig(**overrides)
    shapes = ttf.global_shapes(tcfg, MeshConfig(pp=2))
    assert shapes["layers"]["wq"][:2] == (2, overrides["n_layers"] // 2)
    pairs = list(_spec_pairs(ttf.param_specs(tcfg), jtf.param_specs(JaxConfig(**overrides)),
                             shapes))
    for tspec, jspec, shape in pairs:
        assert widen_spec(tspec, shape, 2) == tuple(_widen_spec(jspec, shape, 2, "dp"))
    assert widen_spec(ttf.param_specs(tcfg)["layers"]["wq"], shapes["layers"]["wq"], 2) == (
        "pp", "dp", None, "tp")


def test_checkpoint_moves_between_pp_sizes(tmp_path):
    base = {"kind": "lm", "batch_size": 4, "seq_len": 8,
            "config": dict(BASE, n_layers=4, remat=False)}
    pp2, pp1 = dict(MESH), {"dp": 4}
    ck = str(tmp_path / "ck")
    legs = [
        (dict(base, steps=6, mesh=pp2), pp2),
        (dict(base, steps=2, checkpoint_every=2, checkpoint_dir=ck, mesh=pp2), pp2),
        (dict(base, steps=4, checkpoint_every=2, checkpoint_dir=ck, mesh=pp1), pp1),
        (dict(base, steps=6, checkpoint_every=2, checkpoint_dir=ck, mesh=pp2), pp2),
    ]
    ranks = gang.spawn(bodies.workload_sequence, 4, (legs, "cpu"), device="cpu", timeout_s=180)
    straight, first, at_pp1, back = ranks[0]
    assert [len(x) for x in (straight, first, at_pp1, back)] == [6, 2, 2, 2]
    assert first == straight[:2]
    np.testing.assert_allclose(at_pp1, straight[2:4], rtol=1e-5)
    np.testing.assert_allclose(back, straight[4:], rtol=1e-5)
    assert all(r == ranks[0] for r in ranks)
