"""The port's CNN (`jobset_tpu_torch/models/cnn.py`) against the JAX
package's, on the CPU, from the JAX `init_params` converted by
`params_from_jax` and numpy-seeded images.

Tolerances:
- f32 logits, losses and gradients: max|d| <= 1e-5 * max|ref| + 1e-6 per
  tensor (the same arithmetic; the convolutions and reductions add in
  another order).
- bf16 logits: max|d| <= 2e-2 * max|ref| + 1e-2 (both frameworks round
  each convolution's output and GroupNorm's result to bf16; an input one
  bf16 ulp apart moves a logit by about that much).
- Parameters after 3 adam steps (f32): the f32 bound above on every leaf
  but entries of a leaf whose gradient sits near adam's eps; every entry
  within 0.05 * lr a step (adam's update is scale-free, as
  test_torch_train.py states).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax import lax

from jobset_tpu.models import cnn as jcnn
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import cnn as tcnn
from jobset_tpu_torch.runtime import optim
from jobset_tpu_torch.runtime.checkpoint import Checkpointer

SMALL = dict(num_classes=10, in_channels=3, widths=(8, 16), blocks_per_stage=1, groups=4)
_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=1e-5, atol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max() + atol


def _configs(dtype="f32", **overrides):
    jdt, tdt = _DTYPES[dtype]
    kw = dict(SMALL, **overrides)
    return jcnn.CNNConfig(dtype=jdt, **kw), tcnn.CNNConfig(dtype=tdt, **kw)


def _params(jcfg, seed=0):
    jparams = jcnn.init_params(jax.random.key(seed), jcfg)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _images(batch, size, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    return images, rng.integers(0, 10, (batch,))


@pytest.mark.parametrize("size", [16, 9], ids=["even", "odd"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_jax(dtype, size):
    jcfg, tcfg = _configs(dtype)
    jparams, tparams = _params(jcfg)
    images, _ = _images(4, size)
    want = np.asarray(jcnn.forward(jparams, jnp.asarray(images), jcfg))
    got = tcnn.forward(tparams, torch.from_numpy(images), tcfg)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    if dtype == "f32":
        _close(got.numpy(), want)
    else:
        _close(got.numpy(), want, rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("size, pads", [(8, (0, 1)), (9, (1, 1)), (16, (0, 1)), (1, (1, 1))])
def test_same_padding_is_xlas(size, pads):
    assert tcnn.same_padding(size, 3, 2) == pads
    assert tcnn.same_padding(size, 3, 1) == (1, 1)
    assert tcnn.same_padding(size, 1, 2) == (0, 0)


@pytest.mark.parametrize("size", [8, 9], ids=["even", "odd"])
@pytest.mark.parametrize("kernel", [3, 1])
@pytest.mark.parametrize("stride", [2, 1])
def test_conv_same_padding_matches_lax(size, kernel, stride):
    """Stride-2 "SAME" on an even size pads 0 before and 1 after; on an odd
    size 1 and 1. The port's conv equals lax's at both."""
    rng = np.random.default_rng(size + kernel)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 5, 6)).astype(np.float32)
    want = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tcnn.conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert got.shape == want.shape == (2, -(-size // stride), -(-size // stride), 6)
    _close(got.numpy(), np.asarray(want))


def test_symmetric_padding_would_shift_the_stride_2_output():
    """The case the explicit padding exists for: PyTorch's padding=1 on an
    even size is not XLA's "SAME"."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 2)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 2, 2)).astype(np.float32))
    naive = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                       stride=2, padding=1).permute(0, 2, 3, 1)
    assert naive.shape == tcnn.conv(x, w, 2).shape
    assert not torch.allclose(naive, tcnn.conv(x, w, 2), atol=1e-3)


def test_group_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 5, 16)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    want = jcnn._group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 4)
    got = tcnn.group_norm(*map(torch.from_numpy, (x, scale, bias)), 4)
    _close(got.numpy(), np.asarray(want))


def test_gradients_match_jax():
    jcfg, tcfg = _configs("f32")
    jparams, tparams = _params(jcfg)
    images, labels = _images(4, 16, seed=2)

    def jloss(p):
        logits = jcnn.forward(p, jnp.asarray(images), jcfg)
        return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(4), labels])

    want_loss, want_grads = jax.value_and_grad(jloss)(jparams)
    live = tree.tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss = tcnn.loss_fn(live, torch.from_numpy(images), torch.from_numpy(labels), tcfg)
    grads = torch.autograd.grad(loss, tree.leaves(live))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_leaves = jax.tree.leaves(want_grads)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        _close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("widths", [(8, 16), (8, 8)], ids=["widening", "equal"])
def test_three_adam_steps_match_jax(widths):
    jcfg, tcfg = _configs("f32", widths=widths)
    jparams, tparams = _params(jcfg, seed=1)
    mesh = build_mesh(MeshConfig(), jax.devices()[:1], allow_submesh=True)
    lr = 3e-3
    jopt, topt = optax.adam(lr), optim.adam(lr)
    jstep = jcnn.build_train_step(jcfg, mesh, jopt)
    tstep = tcnn.build_train_step(tcfg, topt, "cpu")
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    start = [t.clone() for t in tree.leaves(tparams)]
    for step in range(3):
        images, labels = _images(8, 16, seed=10 + step)
        jparams, jstate, jl = jstep(jparams, jstate, {"images": jnp.asarray(images),
                                                      "labels": jnp.asarray(labels)})
        tparams, tstate, tl = tstep(tparams, tstate, {"images": images, "labels": labels})
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for g, w, p0 in zip(tree.leaves(tparams), jax.tree.leaves(jparams), start):
        g, w = g.numpy(), np.asarray(w)
        assert np.abs(g - w).max() <= 3 * 0.05 * lr
        bad = np.abs(g - w) > 1e-5 * np.abs(w).max() + 1e-6
        assert bad.mean() <= 1e-2, f"{bad.sum()} of {bad.size} entries past the f32 bound"
        assert not torch.equal(torch.from_numpy(g), p0)


def test_projection_at_equal_widths_and_downsampling():
    """Every stage after the first downsamples and projects its shortcut,
    even at an unchanged width; stage 0 projects only on a width change,
    which the stem (out at widths[0]) never makes."""
    _, tcfg = _configs(widths=(8, 8, 16))
    params = tcnn.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert "proj" not in params["stages"][0][0]
    assert params["stages"][1][0]["proj"].shape == (1, 1, 8, 8)
    assert params["stages"][2][0]["proj"].shape == (1, 1, 8, 16)
    seen = []
    real = tcnn._block

    def spy(p, x, cfg, stride):
        out = real(p, x, cfg, stride)
        seen.append((tuple(x.shape[1:3]), tuple(out.shape[1:3]), stride))
        return out

    tcnn._block = spy
    try:
        tcnn.forward(params, torch.zeros(2, 16, 16, 3), tcfg)
    finally:
        tcnn._block = real
    assert seen == [((16, 16), (16, 16), 1), ((16, 16), (8, 8), 2), ((8, 8), (4, 4), 2)]


def test_init_tree_matches_jax_names_and_shapes():
    jcfg, tcfg = _configs(widths=(8, 16), blocks_per_stage=2)
    jparams = jcnn.init_params(jax.random.key(0), jcfg)
    tparams = tcnn.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jparams)) == jax.tree.structure(
        jax.tree.map(lambda _: 0, tree.tree_map(lambda t: t.numpy(), tparams)))
    for g, w in zip(tree.leaves(tparams), jax.tree.leaves(jparams)):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32


def test_tree_leaves_order_is_jax_tree_leaves():
    jcfg, _ = _configs(widths=(8, 16), blocks_per_stage=2)
    jparams = jcnn.init_params(jax.random.key(0), jcfg)
    counter = iter(range(1000))
    numbered = jax.tree.map(lambda a: np.full((1,), next(counter)), jparams)
    converted = params_from_jax(numbered)
    assert isinstance(converted["stages"], list) and isinstance(converted["stages"][0], list)
    assert [int(t) for t in tree.leaves(converted)] == list(range(len(jax.tree.leaves(jparams))))
    rebuilt = tree.rebuild(converted, [t + 1 for t in tree.leaves(converted)])
    assert isinstance(rebuilt["stages"][1], list)
    assert [int(t) for t in tree.leaves(rebuilt)] == list(range(1, len(tree.leaves(rebuilt)) + 1))


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_optimizers_and_checkpoints_take_the_cnn_tree(name, tmp_path):
    _, tcfg = _configs()
    params = tcnn.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    opt = {"adamw": optim.adamw(1e-3), "sgd": optim.sgd(0.1, momentum=0.9),
           "adafactor": optim.adafactor(1e-3)}[name]
    step = tcnn.build_train_step(tcfg, opt, "cpu")
    images, labels = _images(4, 8)
    params, state, loss = step(params, opt.init(params), {"images": images, "labels": labels})
    assert np.isfinite(float(loss))
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(1, {"state": {"params": params, "opt_state": state}, "step": 1})
    restored = ckpt.restore()["state"]
    assert isinstance(restored["params"]["stages"][0], list)
    saved = tree.leaves({"params": params, "opt_state": state})
    assert len(tree.leaves(restored)) == len(saved)
    for a, b in zip(tree.leaves(restored), saved):
        assert torch.equal(a, b) if torch.is_tensor(b) else a == b


def test_groups_must_divide_every_width():
    with pytest.raises(ValueError, match="must divide width 10"):
        tcnn.CNNConfig(widths=(8, 10), groups=4).validate()
    with pytest.raises(ValueError):
        tcnn.init_params(tcnn.CNNConfig(widths=(6,), groups=4), torch.Generator(), "cpu")
    with pytest.raises(ValueError):
        tcnn.build_train_step(tcnn.CNNConfig(widths=(6,), groups=4), optim.sgd(0.1), "cpu")
