"""Tile classes of the flash block's bias, and the kernel wrapper's routing.

`tile_classes_reference` (the plain version of the CUDA pre-pass) is held
against a direct numpy computation; the plain `block_attention_reference`
against the JAX package's on the same biases; and skipping the tiles the
classes mark as masked is shown to leave the result unchanged. The
pre-pass kernel itself is compared with the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: f32 1e-5 (same arithmetic, other summation order); bf16 2e-2
on sums and weighted values (the probabilities are rounded to bf16 before
the PV product) and 1e-4 on the max.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jobset_tpu.ops import flash_block as jfb
from jobset_tpu_torch.ops import flash_block as tfb

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MAX_TOL = dict(rtol=1e-5, atol=1e-4)
KINDS = ["triangle", "zero", "all_masked", "band", "reverse_triangle", "alibi"]
# Square, one tile, ragged on either side of a tile edge, and a single entry.
SHAPES = [(128, 128), (64, 64), (65, 63), (127, 129), (130, 200), (1, 1)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bias(kind, tq, tk):
    """The [Tq, Tk] f32 bias kinds that chip_smoke.py also runs."""
    rel = np.arange(tq)[:, None] - np.arange(tk)[None, :]
    cols = np.broadcast_to(np.arange(tk)[None, :], (tq, tk))
    masked = {
        "triangle": rel < 0,
        "reverse_triangle": rel > 0,
        "band": (cols >= tk // 3) & (cols < 2 * tk // 3),
        "zero": np.zeros((tq, tk), bool),
        "all_masked": np.ones((tq, tk), bool),
        "alibi": np.zeros((tq, tk), bool),
    }[kind]
    values = -0.05 * np.abs(rel) if kind == "alibi" else np.zeros((tq, tk))
    return np.where(masked, tfb.NEG_INF, values).astype(np.float32)


def _classes_numpy(bias):
    """One class per 64x64 tile, entry by entry."""
    tq, tk = bias.shape
    nq, nk = -(-tq // 64), -(-tk // 64)
    out = np.empty((nq, nk), np.uint8)
    for i in range(nq):
        for j in range(nk):
            tile = bias[64 * i:64 * (i + 1), 64 * j:64 * (j + 1)]
            if np.all(tile <= tfb.NEG_INF / 2):
                out[i, j] = 0
            elif np.all(tile == 0.0):
                out[i, j] = 1
            else:
                out[i, j] = 2
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", KINDS)
def test_tile_classes_reference_matches_numpy(kind, shape):
    bias = _bias(kind, *shape)
    got = tfb.tile_classes(torch.from_numpy(bias))  # CPU: the plain version
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _classes_numpy(bias))


def test_flagship_triangle_classes():
    # 8x8 tiles of 64: 28 skipped, 28 with no bias to read, 8 on the diagonal.
    got = tfb.tile_classes_reference(torch.from_numpy(_bias("triangle", 512, 512)))
    counts = [int((got == c).sum()) for c in (tfb.MASKED, tfb.ZERO_BIAS, tfb.BIAS)]
    assert counts == [28, 28, 8]
    assert torch.equal(got.diagonal(), torch.full((8,), tfb.BIAS, dtype=torch.uint8))


def test_classes_count_only_entries_inside_the_edges():
    # A masked first column of a ragged last tile: the tile is masked only
    # where every entry inside [Tq, Tk] is.
    bias = np.zeros((70, 65), np.float32)
    bias[:, 64] = tfb.NEG_INF
    got = tfb.tile_classes_reference(torch.from_numpy(bias)).numpy()
    np.testing.assert_array_equal(got, [[1, 0], [1, 0]])
    bias[65, 64] = 0.0  # one live entry: neither masked nor all zero
    got = tfb.tile_classes_reference(torch.from_numpy(bias)).numpy()
    np.testing.assert_array_equal(got, [[1, 0], [1, 2]])


_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(batch, tq, tk, heads, dim, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, tq, heads, dim)).astype(np.float32),
            rng.standard_normal((batch, tk, heads, dim)).astype(np.float32),
            rng.standard_normal((batch, tk, heads, dim)).astype(np.float32))


def _check_triple(got, want, dtype_name):
    tols = [MAX_TOL if dtype_name == "bf16" else F32_TOL] + 2 * [
        BF16_TOL if dtype_name == "bf16" else F32_TOL]
    for g, w, tol in zip(got, want, tols):
        np.testing.assert_allclose(np.asarray(g, np.float32), np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(130, 200), (64, 64)], ids=["ragged", "tile"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_reference_matches_jax(kind, shape, dtype_name):
    tq, tk = shape
    jdt, tdt = _DTYPES[dtype_name]
    q, k, v = _qkv(1, tq, tk, 2, 8, seed=11)
    bias = _bias(kind, tq, tk)
    want = jfb.block_attention_reference(
        *(jnp.asarray(x).astype(jdt) for x in (q, k, v)), jnp.asarray(bias))
    got = tfb.block_attention_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.from_numpy(bias))
    _check_triple([t.numpy() for t in got], want, dtype_name)


@pytest.mark.parametrize("kind", KINDS)
def test_skipping_masked_tiles_is_exact(kind):
    # Per q tile, drop the kv columns of its MASKED tiles: the block step
    # over what is left equals the full one (a fully masked q tile keeps
    # max NEG_INF, sum 0 and weighted 0 without any column).
    tq, tk = 130, 200
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, tq, tk, 2, 8, seed=12))
    bias = torch.from_numpy(_bias(kind, tq, tk))
    full = tfb.block_attention_reference(q, k, v, bias)
    classes = tfb.tile_classes_reference(bias)
    for qt in range(classes.shape[0]):
        rows = slice(64 * qt, 64 * (qt + 1))
        live = [c for c in range(tk) if classes[qt, c // 64] != tfb.MASKED]
        if not live:
            assert torch.all(full[0][:, :, rows] == tfb.NEG_INF)
            assert torch.all(full[1][:, :, rows] == 0) and torch.all(full[2][:, rows] == 0)
            continue
        part = tfb.block_attention_reference(q[:, rows], k[:, live], v[:, live],
                                             bias[rows][:, live])
        for got, want in zip(part, (full[0][:, :, rows], full[1][:, :, rows], full[2][:, rows])):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "tensor_core"),
                                           (torch.float32, "f32")],
                         ids=["dtype0-tensor_core", "dtype1-fma"])  # stable ids: f32 was "fma"
def test_wrapper_routes_by_dtype(dtype, variant):
    q = torch.zeros((2, 8, 4, 16), dtype=dtype)
    k = v = torch.zeros((2, 12, 4, 16), dtype=dtype)
    got_variant, code, *_ = tfb._kernel_args(q, k, v, torch.zeros((8, 12)))
    assert (got_variant, code) == (variant, tfb._VARIANTS[dtype][1])


def test_wrapper_takes_fused_qkv_and_gqa_views_in_place():
    # The forward's fused-QKV split and _repeat_heads' stride-0 expand view
    # reach the tensor-core kernel as they are, without a copy.
    qkv = _bf16(2, 16, (4 + 2 * 2) * 64)
    q, k_c, v_c = torch.split(qkv, [4 * 64, 2 * 64, 2 * 64], dim=-1)
    q = q.reshape(2, 16, 4, 64)
    k, v = (tfb._repeat_heads(t.reshape(2, 16, 2, 64), 2) for t in (k_c, v_c))
    variant, _, k5, v5, dims, strides = tfb._kernel_args(q, k, v, torch.zeros((16, 16)))
    assert variant == "tensor_core" and dims == (2, 4, 16, 16, 64, 2)
    assert k5.data_ptr() == k_c.data_ptr() and v5.data_ptr() == v_c.data_ptr()
    assert strides[:4] == [16 * 512, 512, 64, 1]  # q b, t, h, d in elements


@pytest.mark.parametrize("case", ["base", "row_stride", "d_stride"])
def test_wrapper_rejects_bf16_views_tma_cannot_take(case):
    # Checked before any library is built, so exercised here on CPU tensors.
    q = _bf16(1, 8, 2, 16)
    k = v = _bf16(1, 8, 2, 16)
    if case == "base":  # base 2 bytes past a 16-byte boundary
        q = _bf16(1 * 8 * 2 * 16 + 1)[1:].view(1, 8, 2, 16)
    elif case == "row_stride":  # rows 17 elements (34 bytes) apart
        k = _bf16(1, 8, 2, 17)[..., :16]
    else:  # D not unit-stride
        v = _bf16(1, 8, 2, 32)[..., ::2]
    with pytest.raises(ValueError, match="16-byte"):
        tfb._kernel_args(q, k, v, torch.zeros((8, 8)))
    f32 = [t.float() for t in (q, k, v)]  # the f32 kernel reads any strides
    assert tfb._kernel_args(*f32, torch.zeros((8, 8)))[0] == "f32"
