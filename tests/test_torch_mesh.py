"""The port's mesh, rendezvous environment and parameter sharding against
the JAX package's, on the CPU and without starting a process: where each
rank sits on the five-axis mesh (`rank_grid`, `multislice_rank_grid`)
against the device ids of the reference's `build_mesh` and
`build_multislice_mesh` on the virtual CPU devices, for every MeshConfig
of up to 8 devices; `default_mesh_config` for 1-8 devices; `pod_env_for`
against the reference's on the same simulated JobSets; `free_port`
below the ephemeral port ranges; `param_specs`
against the reference's; and `shard_params` cutting a tree into shards
that put back together give it bit for bit. All comparisons are exact."""

import itertools

import numpy as np
import pytest
import torch

import jax

from jobset_tpu.api import Coordinator
from jobset_tpu.core import make_cluster
from jobset_tpu.models import TransformerConfig as JaxConfig
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel import mesh as jmesh
from jobset_tpu.runtime import distributed as jdist
from jobset_tpu.testing import make_jobset, make_replicated_job
from jobset_tpu_torch.convert import shard_params
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.parallel import mesh as tmesh
from jobset_tpu_torch.runtime import distributed as tdist


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _shapes(n):
    return [s for s in itertools.product(range(1, n + 1), repeat=5) if np.prod(s) == n]


def _ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("n", range(1, 9))
def test_rank_grid_is_the_reference_device_order(n):
    devices = jax.devices()[:n]
    assert [d.id for d in devices] == list(range(n))
    for shape in _shapes(n):
        want = _ids(jmesh.build_mesh(jmesh.MeshConfig(*shape), devices))
        got = tmesh.rank_grid(tmesh.MeshConfig(*shape))
        np.testing.assert_array_equal(got, want)
        # Rank r's coordinates are device r's place.
        for r in range(n):
            coords = tmesh.Mesh.at(tmesh.MeshConfig(*shape), r).coords
            assert want[tuple(coords[a] for a in tmesh.AXIS_NAMES)] == r


@pytest.mark.parametrize("n", range(1, 9))
def test_multislice_rank_grid_is_the_reference_layout(n):
    for ici_n in (d for d in range(1, n + 1) if n % d == 0):
        for ici, dcn in itertools.product(_shapes(ici_n), _shapes(n // ici_n)):
            want = _ids(jmesh.build_multislice_mesh(jmesh.MeshConfig(*ici), jmesh.MeshConfig(*dcn),
                                                   jax.devices()[:n]))
            got = tmesh.multislice_rank_grid(tmesh.MeshConfig(*ici), tmesh.MeshConfig(*dcn))
            np.testing.assert_array_equal(got, want)


def test_default_mesh_config_matches_the_reference():
    for n in range(1, 9):
        want = jmesh.default_mesh_config(n)
        assert tmesh.default_mesh_config(n).shape == want.shape
    assert tmesh.default_mesh_config(2) == tmesh.MeshConfig(tp=2)  # tp first
    assert tmesh.AXIS_NAMES == jmesh.AXIS_NAMES


def test_mesh_config_rules():
    with pytest.raises(ValueError, match="tp must be >= 1"):
        tmesh.MeshConfig(tp=0)
    assert tmesh.MeshConfig.of({"dp": 2, "tp": 2}).num_devices == 4
    assert tmesh.MeshConfig.of(None) == tmesh.MeshConfig()
    single = tmesh.single_device_mesh()
    assert single.shape == {a: 1 for a in tmesh.AXIS_NAMES}
    assert all(single.group(a) is None for a in tmesh.AXIS_NAMES)
    with pytest.raises(ValueError, match="not on the mesh"):
        tmesh.Mesh.at(tmesh.MeshConfig(dp=2), 2)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.Mesh.at(tmesh.MeshConfig(dp=2), 0).group("dp")
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.build_mesh(tmesh.MeshConfig())


def test_zero1_raises_naming_its_item():
    """zero1 is ported, and every axis of the reference with it: a zero1
    payload's mesh passes, ep too; a mesh axis the reference does not have
    raises naming it."""
    from jobset_tpu_torch.runtime.runner import check_workload

    assert check_workload({"kind": "lm", "zero1": True, "mesh": {"dp": 2}}) == \
        tmesh.MeshConfig(dp=2)
    assert check_workload({"kind": "lm", "zero1": True, "mesh": {"dp": 2, "pp": 2}}) == \
        tmesh.MeshConfig(dp=2, pp=2)
    assert check_workload({"kind": "lm", "zero1": True, "mesh": {"dp": 2, "ep": 2}}) == \
        tmesh.MeshConfig(dp=2, ep=2)
    with pytest.raises(TypeError, match="unexpected keyword argument 'xp'"):
        check_workload({"kind": "lm", "zero1": True, "mesh": {"dp": 2, "xp": 2}})


# ---------------------------------------------------------------------------
# pod_env_for
# ---------------------------------------------------------------------------


def _jobsets():
    """Simulated JobSets: one replicated job, heterogeneous replicated jobs
    (a parameter-server group and a worker group of two pods a job), an
    explicit coordinator, and a network subdomain."""
    plain = (make_jobset("plain").replicated_job(
        make_replicated_job("w").replicas(2).parallelism(2).completions(2).obj()).obj())
    hetero = (make_jobset("hetero")
              .replicated_job(make_replicated_job("ps").replicas(2).obj())
              .replicated_job(make_replicated_job("worker").replicas(3).parallelism(2)
                              .completions(2).workload({"kind": "mlp", "steps": 2}).obj())
              .obj())
    coordinated = (make_jobset("coord")
                   .replicated_job(make_replicated_job("a").replicas(1).obj())
                   .replicated_job(make_replicated_job("b").replicas(2).parallelism(3)
                                   .completions(3).obj())
                   .coordinator(Coordinator(replicated_job="b", job_index=1, pod_index=2))
                   .obj())
    subdomain = (make_jobset("sub").network_subdomain("mesh-net")
                 .replicated_job(make_replicated_job("w").replicas(3).obj()).obj())
    return [plain, hetero, coordinated, subdomain]


def test_pod_env_for_matches_the_reference():
    cluster = make_cluster()
    cluster.add_topology("rack", num_domains=8, nodes_per_domain=4, capacity=16)
    for js in _jobsets():
        cluster.create_jobset(js)
    cluster.run_until_stable()
    pods = list(cluster.pods.values())
    assert len(pods) == 4 + (2 + 6) + (1 + 6) + 3
    ranks = {}
    for pod in pods:
        got, want = tdist.pod_env_for(cluster, pod), jdist.pod_env_for(cluster, pod)
        assert got == want
        rank = tdist.rank_from_env(got)
        assert vars(rank) == vars(jdist.rank_from_env(want))
        assert rank.process_id == jdist.rank_from_env(want).process_id
        ranks.setdefault(rank.jobset_name, []).append(rank.process_id)
    # Each gang's process ids are 0..N-1, one a pod.
    for name, ids in ranks.items():
        assert sorted(ids) == list(range(len(ids))), name


def test_free_port_is_below_the_ephemeral_ranges_and_listenable():
    import socket

    for _ in range(16):
        port = tdist.free_port()
        assert port in tdist.RENDEZVOUS_PORTS and port < 32768
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))
            s.listen()


def test_free_port_passes_over_a_port_in_use(monkeypatch):
    import socket

    with socket.socket() as busy:
        for port in tdist.RENDEZVOUS_PORTS:
            try:
                busy.bind(("127.0.0.1", port))
                break
            except OSError:
                continue
        busy.listen()
        taken = busy.getsockname()[1]
        draws = []
        real = tdist.random.SystemRandom

        class Draw:
            """The port in use twice, then random draws."""
            def choice(self, ports):
                draws.append(taken if len(draws) < 2 else real().choice(ports))
                return draws[-1]

        monkeypatch.setattr(tdist.random, "SystemRandom", Draw)
        port = tdist.free_port()
        assert draws[:2] == [taken, taken] and len(draws) >= 3
        assert port != taken and port in tdist.RENDEZVOUS_PORTS


# ---------------------------------------------------------------------------
# Parameter specs and shards
# ---------------------------------------------------------------------------

CONFIGS = {
    "dense": dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, n_layers=2),
    "moe": dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, n_experts=4,
                d_ff_expert=32, moe_top_k=2),
    "tied": dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=1, tie_embeddings=True),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_specs_match_the_reference(name):
    want = jtf.param_specs(JaxConfig(**CONFIGS[name]))
    got = ttf.param_specs(ttf.TransformerConfig(**CONFIGS[name]))
    flat_want = jax.tree.leaves(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert [tuple(s) for s in flat_want] == [tuple(s) for s in
                                             jax.tree.leaves(got, is_leaf=lambda x: isinstance(
                                                 x, tuple))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shards_put_back_together_give_the_tree(name, tp):
    cfg = ttf.TransformerConfig(dtype=torch.float32, **CONFIGS[name])
    full = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    config = tmesh.MeshConfig(dp=2, tp=tp)
    specs = ttf.param_specs(cfg)
    shards = [shard_params(full, cfg, tmesh.Mesh.at(config, rank)) for rank in range(2 * tp)]
    local = ttf.param_shapes(cfg, config)

    def walk(full_, spec_, shape_, parts):
        if isinstance(full_, dict):
            for k in full_:
                walk(full_[k], spec_[k], shape_[k], [p[k] for p in parts])
            return
        for p in parts:
            assert tuple(p.shape) == shape_[0] and p.is_contiguous()
        dim = spec_.index("tp") if "tp" in spec_ else None
        if dim is None:
            for p in parts:
                assert torch.equal(p, full_)
            return
        # dp rank 0's tp ranks, in order, cover the leaf; dp rank 1's repeat them.
        assert torch.equal(torch.cat(parts[:tp], dim=dim), full_)
        for a, b in zip(parts[:tp], parts[tp:]):
            assert torch.equal(a, b)

    walk(full, specs, local, shards)
