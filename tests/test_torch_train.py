"""The port's training path against the JAX package's, on the CPU.

Parameters come from the JAX `init_params` on a one-device mesh and pass
through `params_from_jax`; batches are numpy arrays from a seed. On the
JAX side `block_attention` runs its jnp reference forward and its
hand-written `_bwd`, as the JAX tests run it on the CPU.

Tolerances:
- f32 gradients and `_bwd` outputs: max|d| <= 1e-5 * max|ref| + 1e-6 per
  tensor (same arithmetic, other summation order); losses rtol 1e-5.
- bf16: elementwise rtol 2e-2, atol 1e-1 (test_torch_transformer.py's
  BF16_TOL) on losses and `_bwd` outputs; gradient leaves within 5e-2 of
  the reference in relative norm, ||g - g_ref|| / ||g_ref||: the two
  frameworks round bf16 intermediates at other places, and a relative
  norm is the measure that stays meaningful for leaves whose entries are
  far below 0.1.
- Parameters after Adam steps (f32): the f32 bound above on all but one in
  a thousand entries, and every entry within 0.05 * lr per step. Adam's
  update g / (|g| + eps) is scale-free, so an entry whose gradient is
  near eps = 1e-8 turns the last bits of the gradient into a visible
  part of lr (one wq entry moves 3e-5 after one step at lr 1e-3).
- Parameters after Adam steps (bf16): BF16_TOL elementwise, and each
  leaf's move (p_after - p_before) within 0.15 of the reference's in
  relative norm. The same scale-free update turns every entry whose
  gradient lies within bf16 noise of zero into a move of about lr in
  either direction; three adamw steps on the small config give 0.049.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from jobset_tpu.models import TransformerConfig as JaxConfig, init_params as jax_init
from jobset_tpu.models import transformer as jtf
from jobset_tpu.ops import flash_block as jfb
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.ops import flash_block as tfb
from jobset_tpu_torch.parallel import ring_attention
from jobset_tpu_torch.runtime import optim

BF16_TOL = dict(rtol=2e-2, atol=1e-1)
BF16_GRAD_REL = 5e-2
BF16_ADAM_MOVE_REL = 0.15
LOSS_RTOL = 1e-5
_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-5 * ref + 1e-6, f"max|d|={err:.3e}, max|ref|={ref:.3e}"


def _bf16_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **BF16_TOL)


def _rel_norm_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, ref = np.linalg.norm(got - want), np.linalg.norm(want)
    assert err <= rel * ref + 1e-12, f"||d||={err:.3e}, ||ref||={ref:.3e}"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# block_attention's backward against jax.vjp (which runs _bwd)
# ---------------------------------------------------------------------------


def _bias(kind, t):
    rel = np.arange(t)[:, None] - np.arange(t)[None, :]
    bias = np.where(rel >= 0, 0.0, tfb.NEG_INF) if kind == "triangle" else np.zeros((t, t))
    if kind == "triangle":
        bias[0] = tfb.NEG_INF  # a fully masked row
    return bias.astype(np.float32)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("bias_kind", ["triangle", "zero"])
def test_block_attention_backward_matches_jax(dtype_name, kv_heads, bias_kind):
    jdt, tdt = _DTYPES[dtype_name]
    rng = np.random.default_rng(11)
    b, t, h, d = 2, 24, 4, 16
    group = h // kv_heads
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, kv_heads, d)).astype(np.float32) for _ in range(2))
    bias = _bias(bias_kind, t)
    cot = (rng.standard_normal((b, h, t)).astype(np.float32),
           rng.standard_normal((b, h, t)).astype(np.float32),
           rng.standard_normal((b, t, h, d)).astype(np.float32))

    def jax_fn(q, k, v, bias):
        return jfb.block_attention(q, jfb._repeat_heads(k, group), jfb._repeat_heads(v, group),
                                   bias)

    outs, vjp = jax.vjp(jax_fn, *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                        jnp.asarray(bias))
    want = vjp(tuple(jnp.asarray(c) for c in cot))

    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    tbias = torch.from_numpy(bias).requires_grad_()
    got_outs = tfb.block_attention(tq, tfb._repeat_heads(tk, group), tfb._repeat_heads(tv, group),
                                   tbias)
    got = torch.autograd.grad(got_outs, (tq, tk, tv, tbias),
                              grad_outputs=tuple(torch.from_numpy(c) for c in cot))
    for g, x in zip(got, (tq, tk, tv, tbias)):
        assert g.dtype == x.dtype and g.shape == x.shape
    close = _bf16_close if dtype_name == "bf16" else _f32_close
    for g, w in zip(got, want):
        close(_np(g), _np(w))
    if bias_kind == "triangle":  # the fully masked row gets no gradient
        assert torch.all(got[0][:, 0] == 0) and torch.all(got[3][0] == 0)


def test_block_attention_backward_skips_unneeded_inputs():
    q, k, v = (torch.randn(1, 8, 2, 8) for _ in range(3))
    q.requires_grad_()
    outs = tfb.block_attention(q, k, v, torch.zeros(8, 8))
    (dq,) = torch.autograd.grad(outs[2].sum(), (q,))
    assert dq.shape == q.shape and torch.isfinite(dq).all()
    assert k.grad is None and v.grad is None


def test_ring_attention_gradients_match_dense_softmax():
    # sp = 1: the gradient flows through block_attention's backward and
    # normalize_block_stats; the reference is softmax attention in f64.
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 10, 4, 8))) for _ in range(3))
    w = torch.from_numpy(rng.standard_normal((2, 10, 4, 8)))

    def grads(fn, dtype):
        xs = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        (fn(*xs).double() * w).sum().backward()
        return [x.grad.double() for x in xs]

    def dense(q, k, v):
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 8 ** -0.5
        causal = torch.ones(10, 10, dtype=torch.bool).tril()
        probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)

    for got, want in zip(grads(ring_attention, torch.float32), grads(dense, torch.float64)):
        _f32_close(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# Train and eval steps against the JAX package's
# ---------------------------------------------------------------------------


def _mesh():
    return build_mesh(MeshConfig(), jax.devices()[:1])


def _configs(dtype_name, **kw):
    jdt, tdt = _DTYPES[dtype_name]
    base = dict(vocab_size=128, d_model=64, n_heads=4, d_ff=128, n_layers=2, remat=False)
    base.update(kw)
    return JaxConfig(dtype=jdt, **base), ttf.TransformerConfig(dtype=tdt, **base)


def _batch(t=32, b=4, seed=1, masked=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 128, (b, t + 1)).astype(np.int32)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    if masked:
        mask = np.ones((b, t), np.float32)
        mask[:, t // 2:] = 0.0
        mask[0] = 0.0
        batch["mask"] = mask
    return batch


def _run_both(jcfg, tcfg, jopt, topt, batch, steps=1, accum=1):
    """`steps` train steps of both packages from the same params; returns
    (params before, JAX params, torch params, JAX losses, torch losses)
    as numpy trees."""
    mesh = _mesh()
    jparams = jax_init(jax.random.key(0), jcfg, mesh)
    start = jax.tree.map(np.asarray, jparams)
    tparams = params_from_jax(start)
    jstep = jtf.build_train_step(jcfg, mesh, jopt, accum_steps=accum)
    tstep = ttf.build_train_step(tcfg, topt, accum, "cpu")
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jlosses, tlosses = [], []
    for _ in range(steps):
        jparams, jstate, jloss = jstep(jparams, jstate, jbatch)
        tparams, tstate, tloss = tstep(tparams, tstate, tbatch)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss))
    return (start, jax.tree.map(np.asarray, jparams), tree.tree_map(_np, tparams),
            jlosses, tlosses)


def _check_sgd_grads(dtype_name, start, jparams, tparams, jlosses, tlosses):
    """SGD at lr 1.0: p - p' is the gradient, leaf by leaf."""
    if dtype_name == "bf16":
        _bf16_close(tlosses, jlosses)
    else:
        np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    flat_start = tree.leaves(start)
    want = [s - p for s, p in zip(flat_start, tree.leaves(jparams))]
    got = [s - p for s, p in zip(flat_start, tree.leaves(tparams))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if dtype_name == "bf16":
            _rel_norm_close(g, w, BF16_GRAD_REL)
        else:
            _f32_close(g, w)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["mha", "gqa", "tied"])
def test_sgd_step_gradients_match_jax(dtype_name, variant):
    kw = {"mha": {}, "gqa": {"n_kv_heads": 2}, "tied": {"tie_embeddings": True}}[variant]
    jcfg, tcfg = _configs(dtype_name, **kw)
    out = _run_both(jcfg, tcfg, optax.sgd(1.0), optim.sgd(1.0), _batch())
    _check_sgd_grads(dtype_name, *out)


@pytest.mark.parametrize("option", [
    "loss_chunk", "smoothing_and_z_loss", "masked", "accum_steps_2",
])
def test_sgd_step_options_match_jax(option):
    kw = {"loss_chunk": {"loss_chunk": 8},
          "smoothing_and_z_loss": {"label_smoothing": 0.1, "z_loss_coef": 1e-3}}.get(option, {})
    jcfg, tcfg = _configs("f32", n_kv_heads=2, **kw)
    out = _run_both(jcfg, tcfg, optax.sgd(1.0), optim.sgd(1.0),
                    _batch(masked=option == "masked"),
                    accum=2 if option == "accum_steps_2" else 1)
    _check_sgd_grads("f32", *out)


@pytest.mark.parametrize("remat", ["off", "full", "dots"])
def test_remat_settings_give_the_same_step(remat):
    kw = {"remat": remat != "off", "remat_policy": "full" if remat == "off" else remat}
    jcfg, tcfg = _configs("f32", n_kv_heads=2, **kw)
    out = _run_both(jcfg, tcfg, optax.sgd(1.0), optim.sgd(1.0), _batch())
    _check_sgd_grads("f32", *out)
    # Against the port's own remat-off step the recompute is exact.
    _, plain = _configs("f32", n_kv_heads=2)
    ref = _run_both(jcfg, plain, optax.sgd(1.0), optim.sgd(1.0), _batch())
    for a, b in zip(tree.leaves(out[2]), tree.leaves(ref[2])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_adamw_three_steps_match_jax(dtype_name):
    jcfg, tcfg = _configs(dtype_name)
    start, jparams, tparams, jlosses, tlosses = _run_both(
        jcfg, tcfg, optax.adamw(1e-3), optim.adamw(1e-3), _batch(), steps=3)
    if dtype_name == "bf16":
        _bf16_close(tlosses, jlosses)
    else:
        np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    for s, g, w in zip(tree.leaves(start), tree.leaves(tparams), tree.leaves(jparams)):
        if dtype_name == "bf16":
            _bf16_close(g, w)
            _rel_norm_close(g - s, w - s, BF16_ADAM_MOVE_REL)
        else:
            d = np.abs(g.astype(np.float64) - w)
            assert np.mean(d > 1e-5 * np.abs(w).max() + 1e-6) <= 1e-3
            assert d.max() <= 0.05 * 1e-3 * 3
    assert tlosses[-1] < tlosses[0]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_eval_step_matches_jax(dtype_name):
    jcfg, tcfg = _configs(dtype_name, n_kv_heads=2, label_smoothing=0.1, z_loss_coef=1e-2)
    mesh = _mesh()
    jparams = jax_init(jax.random.key(0), jcfg, mesh)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    batch = _batch(masked=True)
    want = jtf.build_eval_step(jcfg, mesh)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = ttf.build_eval_step(tcfg, "cpu")(tparams, {k: torch.from_numpy(v)
                                                       for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    if dtype_name == "bf16":
        _bf16_close(float(got), float(want))
    else:
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_train_step_leaves_its_arguments_unchanged():
    _, tcfg = _configs("f32")
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    before = tree.tree_map(torch.clone, params)
    opt = optim.adam(1e-2)
    state = opt.init(params)
    new, new_state, loss = ttf.build_train_step(tcfg, opt, device="cpu")(
        params, state, {k: torch.from_numpy(v) for k, v in _batch().items()})
    assert torch.isfinite(loss) and new_state["count"] == 1 and state["count"] == 0
    for a, b in zip(tree.leaves(params), tree.leaves(before)):
        assert torch.equal(a, b) and not a.requires_grad
    assert not torch.equal(new["embed"], params["embed"])


def test_loss_chunk_must_divide_the_sequence():
    _, tcfg = _configs("f32", loss_chunk=12)
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    step = ttf.build_eval_step(tcfg, "cpu")
    with pytest.raises(ValueError, match="must divide"):
        step(params, {k: torch.from_numpy(v) for k, v in _batch(t=32).items()})


def test_accum_steps_must_divide_the_batch():
    _, tcfg = _configs("f32")
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    opt = optim.sgd(0.1)
    step = ttf.build_train_step(tcfg, opt, accum_steps=3, device="cpu")
    with pytest.raises(ValueError, match="accum_steps"):
        step(params, opt.init(params), {k: torch.from_numpy(v) for k, v in _batch().items()})


@pytest.mark.parametrize("bad, error, match", [
    (dict(pipeline_virtual=2), ValueError, "pipeline_virtual"),
    (dict(pipeline_schedule="1f1b", n_experts=4, moe_top_k=2), ValueError, "top-k routing"),
    (dict(pipeline_schedule="bogus"), ValueError, "pipeline_schedule"),
    (dict(remat_policy="everything"), ValueError, "remat_policy"),
    (dict(loss_chunk=-1), ValueError, "loss_chunk"),
    (dict(label_smoothing=1.0), ValueError, "label_smoothing"),
    (dict(z_loss_coef=-0.1), ValueError, "z_loss_coef"),
])
def test_validate_rejects_unported_training_settings(bad, error, match):
    cfg = ttf.TransformerConfig(**{**dict(d_model=64, n_heads=4), **bad})
    with pytest.raises(error, match=match):
        cfg.validate()
    with pytest.raises(error, match=match):
        ttf.build_train_step(cfg, optim.sgd(0.1), device="cpu")


def test_training_defaults_match_jax():
    names = ("remat", "remat_policy", "loss_chunk", "label_smoothing", "z_loss_coef",
             "n_microbatches", "max_seq_len", "moe_aux_coef", "pipeline_schedule",
             "pipeline_virtual")
    jcfg, tcfg = JaxConfig(), ttf.TransformerConfig()
    assert {n: getattr(tcfg, n) for n in names} == {n: getattr(jcfg, n) for n in names}
