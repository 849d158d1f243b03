"""The port's training path against the JAX package's, on the CPU.

Params and states are built by the JAX package and carried across with
``params_from_numpy``; tokens come from numpy with a seed.  Everything runs
in float32 (bf16 only where the optimizer's cast is the point).
Tolerances: gradients, train-step states and attention 1e-4 relative to the
largest value of each leaf (f32 sums taken in other orders through a
backward pass); losses 1e-5; one AdamW update 1e-6 in f32 and one bf16 ulp
in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ShapeConfig as JaxShapeConfig
from repro.configs import get as jax_get
from repro.launch import steps as jax_steps
from repro.launch.mesh import make_host_mesh
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro.models.attention import \
    chunked_causal_attention as jax_chunked_causal_attention
from repro.models.transformer import lm_loss_chunked as jax_lm_loss_chunked
from repro.train.optimizer import adamw_update as jax_adamw_update
from repro_torch.configs import ShapeConfig, get
from repro_torch.convert import params_from_numpy
from repro_torch.launch.steps import abstract_state, make_init_fn, \
    make_train_step
from repro_torch.models import forward, lm_loss
from repro_torch.models.attention import chunked_causal_attention
from repro_torch.models.transformer import lm_loss_chunked
from repro_torch.train.optimizer import OptHyper, adamw_update, \
    global_norm
from repro_torch.utils import tree_leaves, tree_paths, tree_unflatten

SMOKE = get("smollm_135m", smoke=True).replace(param_dtype="float32")
GQA = SMOKE.replace(n_heads=9, n_kv_heads=3, head_dim=16)
VARIANTS = GQA.replace(qkv_bias=True, qk_norm=True)
CFGS = {"smoke": SMOKE, "gqa": GQA, "bias_qknorm": VARIANTS}
SHAPE = ShapeConfig("t", seq_len=32, global_batch=4, kind="train")
JAX_SHAPE = JaxShapeConfig("t", seq_len=32, global_batch=4, kind="train")


def _jax_cfg(cfg):
    return jax_get("smollm_135m", smoke=True).replace(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _np(x):
    return np.asarray(x, np.float32)


def _close_per_leaf(got, ref, rel):
    """Every element within ``rel`` of the leaf's largest |ref| (or
    elementwise rel, whichever is looser)."""
    got, ref = _np(got), _np(ref)
    top = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * top + 1e-30)


def _batch(cfg, seed=1, B=4, S=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


def _port_grads(params, tokens, labels, cfg):
    """{name: grad} of the train-mode loss; torch.autograd.grad raises if
    any parameter is not reached by the graph."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    logits, _ = forward(tree_unflatten(params, live),
                        torch.from_numpy(tokens), cfg, mode="train")
    loss = lm_loss(logits, torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), dict(zip([n for n, _ in tree_paths(params)],
                                   grads))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_mode_gradients_match_jax_for_every_parameter(name):
    cfg = CFGS[name]
    jcfg = _jax_cfg(cfg)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens, labels = _batch(cfg)

    def jloss(p):
        logits, _ = jax_forward(p, jnp.asarray(tokens), jcfg, mode="train")
        return jax_lm_loss(logits, jnp.asarray(labels))

    jl, jg = jax.value_and_grad(jloss)(jp)
    loss, grads = _port_grads(tp, tokens, labels, cfg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    ref = dict(tree_paths(jax.tree.map(np.asarray, jg)))
    assert sorted(grads) == sorted(ref)
    attn = [n for n in grads if "/attn/" in n]
    assert {n.rsplit("/", 1)[1] for n in attn} >= {"wq", "wk", "wv"}
    for n, g in grads.items():
        assert g is not None and bool(torch.isfinite(g).all()), n
        assert float(g.abs().max()) > 0.0, n
        _close_per_leaf(g.numpy(), ref[n], 1e-4)


def test_chunked_attention_gradients_match_jax_over_several_chunks():
    """Query chunks of 64 over 256 positions at 9/3 heads, each recomputed
    in the backward pass, give jax.grad's gradients of q, k and v."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 256, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 256, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 256, 3, 16)).astype(np.float32)
    w = rng.standard_normal((2, 256, 9, 16)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_chunked_causal_attention(q, k, v, chunk=64) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = chunked_causal_attention(tq, tk, tv, chunk=64)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        _close_per_leaf(t.grad.numpy(), g, 1e-4)


def test_lm_loss_and_chunked_loss_match_jax():
    cfg = SMOKE.replace(loss_chunk=8)
    jcfg = _jax_cfg(cfg)
    jp = jax_init_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens, labels = _batch(cfg, seed=4)
    mask = (np.random.default_rng(5).random(labels.shape) < 0.7).astype(
        np.float32)
    jlogits, _ = jax_forward(jp, jnp.asarray(tokens), jcfg, mode="train")
    logits, _ = forward(tp, torch.from_numpy(tokens), cfg, mode="train")
    tl = torch.from_numpy(labels)
    np.testing.assert_allclose(
        float(lm_loss(logits, tl)),
        float(jax_lm_loss(jlogits, jnp.asarray(labels))), rtol=1e-5)
    np.testing.assert_allclose(
        float(lm_loss(logits, tl, torch.from_numpy(mask))),
        float(jax_lm_loss(jlogits, jnp.asarray(labels), jnp.asarray(mask))),
        rtol=1e-5)
    jh, _ = jax_forward(jp, jnp.asarray(tokens), jcfg, mode="train",
                        return_hidden=True)
    h, _ = forward(tp, torch.from_numpy(tokens), cfg, mode="train",
                   return_hidden=True)
    assert h.shape == (4, 32, cfg.d_model)
    chunked = lm_loss_chunked(tp, h, tl, cfg)
    np.testing.assert_allclose(
        float(chunked),
        float(jax_lm_loss_chunked(jp, jh, jnp.asarray(labels), jcfg)),
        rtol=1e-5)
    np.testing.assert_allclose(float(chunked), float(lm_loss(logits, tl)),
                               rtol=1e-5)


class _CountOps(TorchDispatchMode):
    """Counts the ATen matmuls dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_chunked_loss_never_holds_the_full_logits():
    """With loss_chunk, the backward pass recomputes one chunk's logits at a
    time: no tensor of B * S * V elements is ever allocated."""
    cfg = SMOKE.replace(loss_chunk=8)
    tp = make_init_fn(cfg, "cpu")(0)["params"]
    tokens, labels = _batch(cfg)
    full = 4 * 32 * cfg.vocab_size
    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    sizes.append(t.numel())
            return out

    live = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    with Sizes():
        h, _ = forward(tree_unflatten(tp, live), torch.from_numpy(tokens),
                       cfg, mode="train", return_hidden=True)
        loss = lm_loss_chunked(tree_unflatten(tp, live), h,
                               torch.from_numpy(labels), cfg)
        torch.autograd.grad(loss, live)
    assert max(sizes) < full
    assert max(sizes) >= full // 4      # one chunk's logits (32 / 8 = 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step,grad_scale", [(0, 1.0), (5, 1.0), (3, 1e3)])
def test_adamw_update_matches_jax(dtype, step, grad_scale):
    """One update from equal params, grads and moments; grad_scale 1e3
    engages the global-norm clip."""
    rng = np.random.default_rng(step)
    shapes = {"a": (16, 8), "b": {"w": (8,), "z": (3, 4, 5)}}

    def tree(scale=1.0, positive=False):
        def leaf(s):
            x = rng.standard_normal(s).astype(np.float32) * scale
            return np.abs(x) if positive else x
        return {"a": leaf(shapes["a"]), "b": {k: leaf(s) for k, s in
                                              shapes["b"].items()}}

    p, g = tree(), tree(0.05 * grad_scale)
    m, v = tree(0.01), tree(1e-4, positive=True)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), p)
    jg = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), g)
    ref = jax_adamw_update(jp, jg, jax.tree.map(jnp.asarray, m),
                           jax.tree.map(jnp.asarray, v),
                           jnp.asarray(step, jnp.int32))
    tdt = getattr(torch, dtype)
    conv = lambda t: params_from_numpy(jax.tree.map(np.asarray, t),
                                       device="cpu")
    out = adamw_update(conv(jp), conv(jg), conv(m), conv(v),
                       torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(float(out[3]), float(ref[3]), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(conv(jg))), float(ref[3]),
                               rtol=1e-6)
    for (n, a), (_, b) in zip(tree_paths(out[0]), tree_paths(ref[0])):
        assert a.dtype == tdt, n
        b = np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)
        else:
            # one bf16 ulp of the larger magnitude: 2**(exponent - 7)
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                np.abs(b), np.abs(a.float().numpy())) + 1e-38)) - 7)
            assert (np.abs(a.float().numpy() - b) <= ulp).all(), n
    for i in (1, 2):
        for (n, a), (_, b) in zip(tree_paths(out[i]), tree_paths(ref[i])):
            assert a.dtype == torch.float32, n
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6,
                                       atol=1e-9)


def _jax_state(cfg, seed=0):
    init_fn, _ = jax_steps.make_init_fn(_jax_cfg(cfg), make_host_mesh())
    return init_fn(jax.random.PRNGKey(seed))


def _port_state(jstate):
    return params_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")


@pytest.mark.parametrize("name", ["gqa", "bias_qknorm"])
def test_train_step_matches_jax(name):
    cfg = CFGS[name]
    jstate = _jax_state(cfg)
    state, before = _port_state(jstate), _port_state(jstate)
    tokens, labels = _batch(cfg, seed=7)
    jstep, *_ = jax_steps.make_train_step(_jax_cfg(cfg), make_host_mesh(),
                                          JAX_SHAPE)
    jnew, jm = jstep(jstate, {"tokens": jnp.asarray(tokens),
                              "labels": jnp.asarray(labels)})
    new, m = make_train_step(cfg, SHAPE, device="cpu")(
        state, {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert int(new["step"]) == int(jnew["step"]) == 1
    assert new["step"].dtype == torch.int32
    ref = dict(tree_paths(jax.tree.map(np.asarray, jnew)))
    for n, t in tree_paths(new):
        if not n.startswith("params/"):
            _close_per_leaf(t.numpy(), ref[n], 1e-4)     # m, v: the grads
            continue
        # the first AdamW step moves each element by about lr * sign(g):
        # where |g| is within what the two gradients differ by (m holds
        # (1 - b1) * g, clip scale included), its sign is not determined,
        # so only the step's size is held there
        m_name = "m/" + n[len("params/"):]
        m_ref = ref[m_name]
        m_err = np.abs(dict(tree_paths(new))[m_name].numpy() - m_ref).max()
        open_sign = np.abs(m_ref) <= m_err
        assert open_sign.mean() < 1e-3, n
        got, want = t.numpy(), ref[n]
        _close_per_leaf(got[~open_sign], want[~open_sign], 1e-4)
        old = dict(tree_paths(before))[n].numpy()[open_sign]
        hyper = OptHyper()
        assert (np.abs(got[open_sign] - old) <= 1.01 * hyper.lr * (
            1 + hyper.weight_decay * np.abs(old))).all(), n
    # the input state is left as it was
    for (n, a), (_, b) in zip(tree_paths(state), tree_paths(before)):
        assert torch.equal(a, b), n


def _one_step(cfg, state, tokens, labels):
    return make_train_step(cfg, SHAPE, device="cpu")(
        state, {"tokens": torch.from_numpy(tokens),
                "labels": torch.from_numpy(labels)})


def test_grad_accum_two_equals_one():
    cfg = GQA
    state = make_init_fn(cfg, "cpu")(0)
    tokens, labels = _batch(cfg, seed=8)
    new1, m1 = _one_step(cfg, state, tokens, labels)
    new2, m2 = _one_step(cfg.replace(grad_accum=2), state, tokens, labels)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for (n, a), (_, b) in zip(tree_paths(new2), tree_paths(new1)):
        _close_per_leaf(a.numpy(), b.numpy(), 1e-5)


def test_remat_none_full_dots_give_equal_steps():
    tokens, labels = _batch(GQA, seed=9)
    state = make_init_fn(GQA, "cpu")(0)
    runs = {r: _one_step(GQA.replace(remat=r), state, tokens, labels)
            for r in ("none", "full", "dots")}
    base_state, base_m = runs["none"]
    for r in ("full", "dots"):
        new, m = runs[r]
        assert float(m["loss"]) == float(base_m["loss"]), r
        assert float(m["grad_norm"]) == float(base_m["grad_norm"]), r
        for (n, a), (_, b) in zip(tree_paths(new), tree_paths(base_state)):
            assert torch.equal(a, b), (r, n)


@pytest.mark.parametrize("remat,recomputes_mm", [
    ("none", False), ("full", True), ("dots", False)])
def test_remat_policy_decides_what_the_backward_recomputes(remat,
                                                           recomputes_mm):
    """"full" recomputes every layer's projections in the backward pass;
    "dots" keeps them (only the elementwise work is redone); "none" keeps
    everything.  Counted as ATen mm calls of the backward pass beyond the
    two per projection that its gradient needs."""
    cfg = GQA.replace(remat=remat)
    params = make_init_fn(cfg, "cpu")(0)["params"]
    tokens, labels = _batch(cfg, seed=10)
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    logits, _ = forward(tree_unflatten(params, live),
                        torch.from_numpy(tokens), cfg, mode="train")
    loss = lm_loss(logits, torch.from_numpy(labels))
    with _CountOps() as backward:
        torch.autograd.grad(loss, live)
    # forward mm calls: 7 projections per layer (wq wk wv wo_attn wi wg wo)
    # plus the tied unembed; the backward takes two per forward mm.  The
    # recompute stops once it has what the backward needs, which leaves out
    # the layer's last projection (wo): 6 per layer
    extra = backward.mm - 2 * (7 * cfg.n_layers + 1)
    assert extra == (6 * cfg.n_layers if recomputes_mm else 0), backward.mm


def test_one_train_step_descends():
    """As tests/test_arch_smoke.py: one AdamW step lowers the loss on the
    batch it was taken on."""
    cfg = SMOKE
    state = make_init_fn(cfg, "cpu")(0)
    tokens, labels = _batch(cfg, seed=11)
    step = make_train_step(cfg, SHAPE, device="cpu")
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    new, m0 = step(state, batch)
    _, m1 = step(new, batch)
    assert np.isfinite(float(m0["loss"])) and np.isfinite(
        float(m0["grad_norm"]))
    assert float(m1["loss"]) < float(m0["loss"])


def test_abstract_state_matches_jax_and_allocates_nothing():
    cfg = GQA.replace(param_dtype="bfloat16")
    ref = jax_steps.abstract_state(_jax_cfg(cfg))
    mine = abstract_state(cfg)
    assert [(n, tuple(a.shape), str(a.dtype)) for n, a in tree_paths(ref)] \
        == [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for n, t in tree_paths(mine)]
    assert all(t.device.type == "meta" for _, t in tree_paths(mine))
    real = make_init_fn(cfg, "cpu")(0)
    assert [(n, t.shape, t.dtype) for n, t in tree_paths(real)] == \
        [(n, t.shape, t.dtype) for n, t in tree_paths(mine)]


def test_train_entry_points_default_to_cuda():
    import inspect

    from repro_torch.runtime.coordinator import TrainRunner
    for fn in (make_init_fn, make_train_step, TrainRunner):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_train_step(SMOKE, SHAPE)
