"""The port's sequence-parallel attention against the JAX package's, on
the CPU: `ring_attention` and `ulysses_attention` on gangs of sp ∈ {2, 4}
processes (gloo), each rank its chunk of the sequence, against the
reference's under `shard_map` on the virtual CPU mesh (as
tests/test_parallel.py runs them): causal and not, MHA and GQA (k/v with
half the heads), f32. The outputs and the gradients of sum(out * w) with
respect to q, k and v are held within 1e-5 of the reference's largest
entry (+1e-6): the same arithmetic, folded in the same block order.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from jobset_tpu.parallel import ring_attention as jax_ring
from jobset_tpu.parallel import ulysses_attention as jax_ulysses
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies

B, T, H, D = 2, 16, 8, 8
CASES = [(impl, causal, kv) for impl in ("ring", "ulysses") for causal in (True, False)
         for kv in (H, H // 2)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _key(case):
    impl, causal, kv = case
    return f"{impl}-{'causal' if causal else 'full'}-kv{kv}"


def _inputs(case):
    rng = np.random.default_rng(CASES.index(case))
    kv = case[2]
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, T, H, D), (B, T, kv, D), (B, T, kv, D), (B, T, H, D))]


def _jax_case(case, sp):
    """(out, dq, dk, dv) of the reference under shard_map over sp devices."""
    impl, causal, _ = case
    fn = jax_ring if impl == "ring" else jax_ulysses
    mesh = Mesh(np.array(jax.devices()[:sp]).reshape(sp), ("sp",))
    spec = P(None, "sp", None, None)
    sharded = jax.shard_map(lambda q, k, v: fn(q, k, v, "sp", causal=causal), mesh=mesh,
                            in_specs=(spec,) * 3, out_specs=spec)
    q, k, v, w = (jnp.asarray(a) for a in _inputs(case))
    out, vjp = jax.vjp(jax.jit(sharded), q, k, v)
    return [np.asarray(x) for x in (out, *vjp(w))]


def _runs(sp):
    ranks = gang.spawn(bodies.sp_attention, sp,
                       ({_key(c): (c[0], c[1], *_inputs(c)) for c in CASES}, sp, "cpu"),
                       device="cpu", timeout_s=180)
    got = {key: [np.concatenate([r[key][i] for r in ranks], axis=1) for i in range(4)]
           for key in ranks[0]}
    return got, {_key(c): _jax_case(c, sp) for c in CASES}


@pytest.fixture(scope="module")
def sp2():
    return _runs(2)


@pytest.fixture(scope="module")
def sp4():
    return _runs(4)


def _check(runs, case):
    got, want = runs
    for name, g, w in zip(("out", "dq", "dk", "dv"), got[_key(case)], want[_key(case)]):
        assert g.shape == w.shape, name
        err, ref = np.abs(g - w).max(), np.abs(w).max()
        assert err <= 1e-5 * ref + 1e-6, f"{_key(case)} {name}: max|d|={err:.3e}"


def _moved_inputs(sp):
    rng = np.random.default_rng(sp)
    return [rng.standard_normal((2, 8, 4, 3)).astype(np.float32) for _ in range(2)]


@functools.cache
def _moved(sp):
    """Each rank's `bodies.sp_collectives` in f32 and bf16, one gang of sp."""
    return gang.spawn(bodies.sp_collectives, sp,
                      (*_moved_inputs(sp), sp, ("float32", "bfloat16"), "cpu"), device="cpu",
                      timeout_s=180)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sp", [2, 4])
def test_rotate_and_all_to_all_match_lax(sp, dtype):
    """`collectives.rotate` is `lax.ppermute` by +1 and `collectives.all_to_all`
    is `lax.all_to_all(tiled=True)`, outputs and gradients (their backward
    the rotation by -1 and the all-to-all with the dims swapped), and
    `collectives.gather` is `lax.all_gather(tiled=True)`, bit for bit in
    f32 and bf16: they move values and add none."""
    from jax import lax

    x, w = _moved_inputs(sp)
    ranks = [r[dtype] for r in _moved(sp)]
    mesh = Mesh(np.array(jax.devices()[:sp]).reshape(sp), ("sp",))
    seq, heads = P(None, "sp", None, None), P(None, None, "sp", None)
    perm = [(i, (i + 1) % sp) for i in range(sp)]
    xj, wj = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w))
    for name, fn, out_spec, axis in (
            ("rotate", lambda t: lax.ppermute(t, "sp", perm), seq, 1),
            ("all_to_all", lambda t: lax.all_to_all(t, "sp", 2, 1, tiled=True), heads, 2)):
        sharded = jax.shard_map(fn, mesh=mesh, in_specs=(seq,), out_specs=out_spec)
        out, vjp = jax.vjp(sharded, xj)
        np.testing.assert_array_equal(np.concatenate([r[name][0] for r in ranks], axis=axis),
                                      np.asarray(out, np.float32))
        np.testing.assert_array_equal(np.concatenate([r[name][1] for r in ranks], axis=1),
                                      np.asarray(vjp(wj)[0], np.float32))
    gathered = jax.shard_map(lambda t: lax.all_gather(t, "sp", axis=1, tiled=True), mesh=mesh,
                             in_specs=(seq,), out_specs=P(), check_vma=False)(xj)
    for r in ranks:
        np.testing.assert_array_equal(r["gather"][0], np.asarray(gathered, np.float32))


def test_masked_mask_skips_every_tile_and_leaves_the_accumulator():
    """The ring's block of later positions: an all-NEG_INF bias whose tiles
    are all MASKED; merged into an accumulator it changes nothing, bit for
    bit, and passes k and v no gradient."""
    from jobset_tpu_torch.ops import flash_block as tfb

    bias, classes = tfb.constant_mask("masked", 70, 130, torch.device("cpu"))
    assert bool((bias == tfb.NEG_INF).all()) and bias.shape == (70, 130)
    assert bool((classes == tfb.MASKED).all()) and classes.shape == (2, 3)
    rng = np.random.default_rng(3)
    q, k, v, k0, v0 = (torch.tensor(rng.standard_normal((2, 70 if i == 0 else 130, 4, 8)),
                                    dtype=torch.float32, requires_grad=True) for i in range(5))
    acc = tfb.block_attention(q, k0, v0, torch.zeros((70, 130)))
    merged = tfb.merge_block_stats(acc, tfb.block_attention(q, k, v, bias, classes=classes))
    out = tfb.normalize_block_stats(merged[1], merged[2])
    assert torch.equal(out, tfb.normalize_block_stats(acc[1], acc[2]))
    out.sum().backward()
    assert bool((k.grad == 0).all()) and bool((v.grad == 0).all())


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_sp2_matches_jax(sp2, case):
    _check(sp2, case)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_sp4_matches_jax(sp4, case):
    _check(sp4, case)
