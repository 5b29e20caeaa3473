"""The port's mixture-of-experts training against the JAX package's, on
the CPU.

Small configs (vocab 64, d 32, 4 heads, 2 layers, 4 experts, d_ff_expert
32, f32 unless a test says otherwise), parameters from the JAX
`init_params` through `params_from_jax`, batches numpy arrays from a
seed. On the JAX side `block_attention` runs its jnp reference forward and
its hand-written `_bwd`, as the JAX tests run it on the CPU.

- The ragged product's VJP: `jax.vjp` of `lax.ragged_dot` against the
  port's `grouped_matmul` backward (its autograd Function on the plain
  path) and against `grouped_matmul_dgrad_plain` and
  `grouped_matmul_wgrad_plain` alone, under balanced, skewed, empty-group
  and mid-tile boundary group sizes and rows past the last group.
- The balancing aux loss and the router's gradient against JAX's
  `_local_loss_fn` for every router (dropless and capacity at top-k 1 and
  2, soft dispatch, expert choice), at moe_aux_coef 0.01 and 1.0.
- One sgd step's gradients of every leaf, three adamw steps' losses, remat
  off / "full" / "dots", the eval step and accum_steps 2, through
  `build_train_step` and `build_eval_step` of both packages; under a remat
  policy the grouped products run again in the backward (as the
  reference's `checkpoint_dots` recomputes `ragged_dot_general`).
- bf16, held per layer on the same routing (end to end, bf16 routing may
  pick other experts in the two packages): the grouped products'
  gradients, and one dropless MoE layer's output and its input and weight
  gradients.
- `run_model_bench` and `train_workload` on a small MoE config.

Tolerances: f32 max|d| <= 1e-5 * max|ref| + 1e-6 per tensor (the same
arithmetic in another summation order), losses rtol 1e-5; bf16
elementwise rtol 2e-2, atol 1e-1 (`test_torch_train.py`'s BF16_TOL), and
gradient leaves of the MoE layer within 5e-2 of the reference in relative
norm (`test_torch_train.py`'s BF16_GRAD_REL: bf16 intermediates rounded
at other places).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig, init_params as jax_init
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.ops import grouped_matmul as gm
from jobset_tpu_torch.runtime import model_bench as tbench
from jobset_tpu_torch.runtime import optim
from jobset_tpu_torch.runtime.runner import train_workload

BF16_TOL = dict(rtol=2e-2, atol=1e-1)
BF16_GRAD_REL = 5e-2
LOSS_RTOL = 1e-5
MOE = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, n_experts=4,
           d_ff_expert=32, remat=False)
ROUTERS = {
    "dropless_k1": dict(moe_top_k=1, moe_dispatch="dropless"),
    "dropless_k2": dict(moe_top_k=2, moe_dispatch="dropless"),
    "capacity_k1": dict(moe_top_k=1, moe_capacity_factor=1.0),
    "capacity_k2": dict(moe_top_k=2, moe_capacity_factor=0.75),
    "soft": dict(moe_top_k=0),
    "expert_choice": dict(moe_router="expert", moe_top_k=2),
}


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


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _mesh():
    return build_mesh(MeshConfig(), jax.devices()[:1])


def _configs(dtype="f32", **kw):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    base = {**MOE, **kw}
    return JaxConfig(dtype=jdt, **base), ttf.TransformerConfig(dtype=tdt, **base)


def _batch(b=4, t=16, seed=1, masked=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 64, (b, t + 1)).astype(np.int32)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    if masked:
        mask = np.ones((b, t), np.float32)
        mask[:, t // 2:] = 0.0
        batch["mask"] = mask
    return batch


def _params(jcfg, seed=0):
    jparams = jax_init(jax.random.key(seed), jcfg, _mesh())
    start = jax.tree.map(np.asarray, jparams)
    return jparams, start, params_from_jax(start)


# --- the ragged product's VJP -------------------------------------------------


# (group sizes, rows): rows sorted by expert; "boundary" ends every group
# inside a 128-row tile beside a full one (the card kernels' tiles), and
# "rows_past" leaves rows past the last group, which get zero gradients.
SIZES = {
    "balanced": ([75, 75, 75, 75], 300),
    "skewed": ([0, 300, 0, 0], 300),
    "empty": ([120, 0, 0, 180], 300),
    "boundary": ([192, 69, 1, 38], 300),
    "rows_past": ([10, 0, 130, 33], 200),
}


def _ragged_operands(case, dtype, k=24, n=40, seed=0):
    sizes, m = SIZES[case]
    rng = np.random.default_rng(seed + m + sum(sizes[:2]))
    xs = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((len(sizes), k, n)) / np.sqrt(k)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    if dtype == "bf16":  # values exact in bf16, so both packages start alike
        xs, w, dy = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                     for a in (xs, w, dy))
    return xs, w, dy, np.asarray(sizes, np.int32)


def _jax_ragged_vjp(xs, w, dy, sizes, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16

    def product(a, b):
        return jax.lax.ragged_dot(a, b, jnp.asarray(sizes), preferred_element_type=jdt)

    y, vjp = jax.vjp(product, jnp.asarray(xs, jdt), jnp.asarray(w, jdt))
    dxs, dw = vjp(jnp.asarray(dy, jdt))
    return (np.asarray(y.astype(jnp.float32)), np.asarray(dxs.astype(jnp.float32)),
            np.asarray(dw.astype(jnp.float32)))


def _close(dtype, got, want):
    (_f32_close if dtype == "f32" else _bf16_close)(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(SIZES))
def test_grouped_matmul_backward_matches_the_ragged_dot_vjp(case, dtype):
    xs, w, dy, sizes = _ragged_operands(case, dtype)
    want_y, want_dxs, want_dw = _jax_ragged_vjp(xs, w, dy, sizes, dtype)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    t_xs = torch.from_numpy(xs).to(tdt).requires_grad_()
    t_w = torch.from_numpy(w).to(tdt).requires_grad_()
    y = gm.grouped_matmul(t_xs, t_w, torch.from_numpy(sizes))
    assert y.grad_fn is not None and y.dtype == tdt
    y.backward(torch.from_numpy(dy).to(tdt))
    assert t_xs.grad.dtype == t_w.grad.dtype == tdt
    _close(dtype, _np(y), want_y)
    _close(dtype, _np(t_xs.grad), want_dxs)
    _close(dtype, _np(t_w.grad), want_dw)
    end = int(sizes.sum())
    assert torch.all(t_xs.grad[end:] == 0)  # rows past the last group
    for e in np.nonzero(sizes == 0)[0]:  # an empty group's gradient is exactly 0
        assert torch.all(t_w.grad[e] == 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(SIZES))
@pytest.mark.parametrize("which", ["dgrad", "wgrad"])
def test_backward_plain_versions_match_the_ragged_dot_vjp(which, case, dtype):
    xs, w, dy, sizes = _ragged_operands(case, dtype, k=40, n=24, seed=1)
    _, want_dxs, want_dw = _jax_ragged_vjp(xs, w, dy, sizes, dtype)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    t_xs, t_w, t_dy = (torch.from_numpy(a).to(tdt) for a in (xs, w, dy))
    t_sizes = torch.from_numpy(sizes)
    if which == "dgrad":
        got = gm.grouped_matmul_dgrad_plain(t_dy, t_w, t_sizes)
        assert got.shape == t_xs.shape and got.dtype == tdt
        _close(dtype, _np(got), want_dxs)
        # The CPU dispatch of the wrapper is the plain version.
        assert torch.equal(gm.grouped_matmul_dgrad(t_dy, t_w, t_sizes), got)
    else:
        got = gm.grouped_matmul_wgrad_plain(t_xs, t_dy, t_sizes)
        assert got.shape == t_w.shape and got.dtype == tdt
        _close(dtype, _np(got), want_dw)
        assert torch.equal(gm.grouped_matmul_wgrad(t_xs, t_dy, t_sizes), got)


def test_no_gradient_recorded_goes_straight_to_the_forward():
    xs, w, _, sizes = _ragged_operands("boundary", "f32")
    args = (torch.from_numpy(xs), torch.from_numpy(w), torch.from_numpy(sizes))
    y = gm.grouped_matmul(*args)
    assert y.grad_fn is None
    with torch.no_grad():
        z = gm.grouped_matmul(args[0].requires_grad_(), args[1], args[2])
    assert z.grad_fn is None and torch.equal(y, z)


def test_slot_gather_backward_equals_the_scatter_it_replaces():
    # `_SlotGather`'s gathered backward against autograd's own (an
    # accumulating scatter) on the same permutation: each source row's k
    # slot gradients, summed.
    rng = np.random.default_rng(4)
    n, k, d = 13, 3, 8
    order = torch.from_numpy(rng.permutation(n * k))
    inverse = torch.empty_like(order).scatter_(0, order, torch.arange(n * k))
    src = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).requires_grad_()
    grad = torch.from_numpy(rng.standard_normal((n * k, d)).astype(np.float32))
    rows = ttf._SlotGather.apply(src, order, inverse, k)
    assert torch.equal(rows, src[order // k])
    (got,) = torch.autograd.grad(rows, src, grad)
    (want,) = torch.autograd.grad(src[order // k], src, grad)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    # k = 1: a permutation of the rows (the combine's gather), whose
    # backward is the inverse permutation, exact.
    slots = torch.from_numpy(rng.standard_normal((n * k, d)).astype(np.float32)).requires_grad_()
    rows = ttf._SlotGather.apply(slots, inverse, order, 1)
    assert torch.equal(rows, slots[inverse])
    (got,) = torch.autograd.grad(rows, slots, grad)
    assert torch.equal(got, torch.autograd.grad(slots[inverse], slots, grad)[0])


# --- the aux loss and the router's gradient ----------------------------------


def _jax_loss_parts(jcfg, jparams, batch):
    """JAX's `_local_loss_fn` on a one-device mesh: (loss_sum, count, aux)
    and the gradient of ce + moe_aux_coef * aux."""
    mesh = _mesh()
    specs = jtf.param_specs(jcfg)
    data = jax.P("dp", "sp")

    def parts(p, inputs, targets, mask):
        return jtf._local_loss_fn(p, inputs, targets, mask, jcfg, 1)

    sharded = jax.shard_map(parts, mesh=mesh, in_specs=(specs, data, data, data),
                            out_specs=(jax.P(), jax.P(), jax.P()))
    args = [jnp.asarray(batch[k]) for k in ("inputs", "targets")]
    args.append(jnp.ones(batch["targets"].shape, jnp.float32))

    def total(p):
        loss_sum, count, aux = sharded(p, *args)
        return loss_sum / jnp.maximum(count, 1.0) + jcfg.moe_aux_coef * aux, (loss_sum, count, aux)

    (_, values), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)
    return [float(v) for v in values], jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("coef", [0.01, 1.0])
@pytest.mark.parametrize("router", list(ROUTERS))
def test_aux_loss_and_router_gradient_match_jax(router, coef):
    jcfg, tcfg = _configs(moe_aux_coef=coef, **ROUTERS[router])
    jparams, _, tparams = _params(jcfg, seed=2)
    batch = _batch(seed=3)
    (want_sum, want_count, want_aux), want_grads = _jax_loss_parts(jcfg, jparams, batch)
    live = tree.tree_map(lambda t: t.detach().requires_grad_(), tparams)
    loss_sum, count, aux = ttf._local_loss(
        live, torch.from_numpy(batch["inputs"]), torch.from_numpy(batch["targets"]),
        torch.ones(batch["targets"].shape), tcfg)
    loss = loss_sum / torch.clamp(count, min=1.0) + coef * aux
    (wg_grad,) = torch.autograd.grad(loss, [live["layers"]["wg"]])
    loss_sum, count, aux = (float(v.detach()) for v in (loss_sum, count, aux))
    np.testing.assert_allclose([loss_sum, count, aux], [want_sum, want_count, want_aux],
                               rtol=LOSS_RTOL, atol=1e-7)
    if ROUTERS[router].get("moe_top_k", 0) > 0 and router != "expert_choice":
        assert aux > 0.5  # ~1 at balance: the aux is on, not a zero placeholder
    else:
        assert aux == 0.0
    _f32_close(wg_grad.numpy(), want_grads["layers"]["wg"])


def test_balancing_aux_of_known_statistics():
    # Two layers of 2 experts, k = 1, 8 tokens: layer 0 routes all 8 to
    # expert 0 with gate sums (6, 2); layer 1 splits 4 / 4 with (4, 4).
    # E * sum f * P: 2 * (1 * 6/8) = 1.5 and 2 * (0.5 * 0.5 * 2) = 1.0.
    cfg = ttf.TransformerConfig(n_experts=2, moe_top_k=1, n_layers=2)
    stats = torch.tensor([[[8.0, 0.0], [6.0, 2.0]], [[4.0, 4.0], [4.0, 4.0]]])
    assert float(ttf._balancing_aux(stats, cfg)) == pytest.approx((1.5 + 1.0) / 2)


# --- the train and eval steps -------------------------------------------------


def _run_both(jcfg, tcfg, jopt, topt, batch, steps=1, accum=1, seed=0):
    """`steps` train steps of both packages from the same params: (params
    before, JAX params, torch params, JAX losses, torch losses), numpy."""
    mesh = _mesh()
    jparams, start, tparams = _params(jcfg, seed)
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


def _check_sgd_grads(start, jparams, tparams, jlosses, tlosses):
    """SGD at lr 1.0: p - p' is the gradient, leaf by leaf (f32)."""
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    flat_start = tree.leaves(start)
    want = [s - p for s, p in zip(flat_start, tree.leaves(jparams))]
    got = [s - p for s, p in zip(flat_start, tree.leaves(tparams))]
    assert len(got) == len(want) == len(flat_start)
    for g, w in zip(got, want):
        _f32_close(g, w)


@pytest.mark.parametrize("router", list(ROUTERS))
def test_sgd_step_gradients_match_jax(router):
    jcfg, tcfg = _configs(moe_aux_coef=0.1, **ROUTERS[router])
    out = _run_both(jcfg, tcfg, optax.sgd(1.0), optim.sgd(1.0), _batch())
    _check_sgd_grads(*out)
    # The experts and the router moved: their gradients reached the params.
    start, _, tparams = out[:3]
    for name in ("wg", "we1", "we2"):
        assert np.abs(tparams["layers"][name] - start["layers"][name]).max() > 0


@pytest.mark.parametrize("router", ["dropless_k2", "capacity_k2"])
def test_adamw_three_steps_losses_match_jax(router):
    jcfg, tcfg = _configs(**ROUTERS[router])
    _, _, _, jlosses, tlosses = _run_both(jcfg, tcfg, optax.adamw(1e-3), optim.adamw(1e-3),
                                          _batch(), steps=3)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tlosses[-1] < tlosses[0]


def _count_grouped_calls(monkeypatch):
    """Calls of the grouped product's forward and of its backward's two
    halves (the dispatchers a CUDA tensor would launch from)."""
    calls = {"forward": 0, "dgrad": 0, "wgrad": 0}
    for key, name in (("forward", "_forward"), ("dgrad", "grouped_matmul_dgrad"),
                      ("wgrad", "grouped_matmul_wgrad")):
        original = getattr(gm, name)

        def counted(*args, _key=key, _fn=original):
            calls[_key] += 1
            return _fn(*args)

        monkeypatch.setattr(gm, name, counted)
    return calls


@pytest.mark.parametrize("remat", ["off", "full", "dots"])
def test_remat_settings_give_the_same_step(remat, monkeypatch):
    kw = {"remat": remat != "off", "remat_policy": "full" if remat == "off" else remat}
    jcfg, tcfg = _configs(**ROUTERS["dropless_k2"], **kw)
    calls = _count_grouped_calls(monkeypatch)
    out = _run_both(jcfg, tcfg, optax.sgd(1.0), optim.sgd(1.0), _batch())
    _check_sgd_grads(*out)
    # Two grouped products a layer, each differentiated once; under "full"
    # and "dots" the forward's run again in the backward.
    layers = tcfg.n_layers
    assert calls == {"forward": (2 if remat == "off" else 4) * layers, "dgrad": 2 * layers,
                     "wgrad": 2 * layers}
    # Against the port's own remat-off step the recompute is exact.
    _, plain = _configs(**ROUTERS["dropless_k2"])
    ref = _run_both(jcfg, plain, optax.sgd(1.0), optim.sgd(1.0), _batch())
    for a, b in zip(tree.leaves(out[2]), tree.leaves(ref[2])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("router", ["dropless_k2", "capacity_k1", "soft", "expert_choice"])
def test_eval_step_matches_jax(router):
    jcfg, tcfg = _configs(**ROUTERS[router])
    jparams, _, tparams = _params(jcfg)
    batch = _batch(masked=True)
    want = jtf.build_eval_step(jcfg, _mesh())(jparams, {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
    got = ttf.build_eval_step(tcfg, "cpu")(tparams, {k: torch.from_numpy(v)
                                                       for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("router", ["dropless_k2", "capacity_k2"])
def test_accum_steps_2_matches_jax(router):
    # Each chunk pools its own statistics (the reference's scan does too).
    jcfg, tcfg = _configs(**ROUTERS[router])
    out = _run_both(jcfg, tcfg, optax.sgd(1.0), optim.sgd(1.0), _batch(masked=True), accum=2)
    _check_sgd_grads(*out)


# --- bf16, a layer at a time --------------------------------------------------


def _jax_dropless_vjp(jcfg, layer, xn, cotangents):
    mesh = _mesh()

    def fn(p, x):
        return jtf._moe_mlp_dropless(p, x, jcfg)

    sharded = jax.shard_map(fn, mesh=mesh, in_specs=(jax.P(), jax.P()),
                            out_specs=(jax.P(), jax.P()), check_vma=False)
    def run(layer, xn, cotangents):
        (out, stats), vjp = jax.vjp(sharded, layer, xn)
        return out, stats, *vjp(cotangents)

    return jax.jit(run)(layer, xn, cotangents)


@pytest.mark.parametrize("k", [1, 2])
def test_bf16_dropless_layer_gradients_match_jax_on_the_same_routing(k):
    jcfg, tcfg = _configs("bf16", moe_top_k=k, moe_dispatch="dropless")
    jparams, start, tparams = _params(jcfg, seed=5)
    rng = np.random.default_rng(6)
    xn = np.array(jnp.asarray(rng.standard_normal((2, 24, 32)), jnp.bfloat16)
                  .astype(jnp.float32))
    cot = np.array(jnp.asarray(rng.standard_normal((2, 24, 32)), jnp.bfloat16)
                   .astype(jnp.float32))
    # The statistics' cotangent, as the aux loss gives them one: none on the
    # choice counts (no gradient there), some on the gate-probability sums.
    cot_stats = np.zeros((2, 4), np.float32)
    cot_stats[1] = rng.standard_normal(4)
    names = ("wg", "we1", "we2")
    jlayer = {n: jparams["layers"][n][0, 0] for n in names}
    out, stats, d_layer, d_xn = _jax_dropless_vjp(
        jcfg, jlayer, jnp.asarray(xn, jnp.bfloat16),
        (jnp.asarray(cot, jnp.bfloat16), jnp.asarray(cot_stats)))
    tlayer = {n: tparams["layers"][n][0, 0].clone().requires_grad_() for n in names}
    t_xn = torch.from_numpy(xn).to(torch.bfloat16).requires_grad_()
    t_out, t_stats = ttf._moe_mlp_dropless(tlayer, t_xn, tcfg)
    # The same routing: the same expert choice counts.
    np.testing.assert_array_equal(_np(t_stats[0]), np.asarray(stats[0]))
    torch.autograd.backward([t_out, t_stats], [torch.from_numpy(cot).to(torch.bfloat16),
                                               torch.from_numpy(cot_stats)])
    _bf16_close(_np(t_out), np.asarray(out.astype(jnp.float32)))
    _rel_norm_close(_np(t_xn.grad), np.asarray(d_xn.astype(jnp.float32)), BF16_GRAD_REL)
    for n in names:
        assert tlayer[n].grad.dtype == torch.float32
        _rel_norm_close(_np(tlayer[n].grad), np.asarray(d_layer[n]), BF16_GRAD_REL)


# --- the entry points -----------------------------------------------------------


def test_run_model_bench_on_a_small_moe_config():
    cfg = dataclasses.replace(_configs(**ROUTERS["dropless_k2"])[1], max_seq_len=16)
    out = tbench.run_model_bench(steps=2, warmup=1, batch=2, seq_len=16, config=cfg,
                                 device="cpu")
    assert out["n_experts"] == 4 and out["moe_top_k"] == 2 and out["moe_dispatch"] == "dropless"
    assert out["active_params_m"] <= out["params_m"]
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["mfu_pct"] is None and out["peak_memory_gb"] is None


def test_train_workload_trains_an_moe_config():
    config = {k: v for k, v in MOE.items() if k != "remat"}
    result = train_workload({"kind": "lm", "steps": 3, "batch_size": 2, "seq_len": 16,
                             "config": {**config, "moe_top_k": 2, "moe_dispatch": "dropless"}},
                            device="cpu")
    assert len(result) == 3 and all(np.isfinite(result))
