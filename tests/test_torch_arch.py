"""Every attention-block config of the port against the JAX package's, on
the CPU.

The seven configs beside smollm_135m (dense, qk-norm, qkv-bias, embeds
input and MoE), at their ``SMOKE`` widths in float32.  Params are built by
JAX ``init_params`` and carried across with ``params_from_numpy``; inputs
come from numpy with a seed ((B, S) tokens, or (B, S, d) embeds for
musicgen_medium).  The port runs with ``device="cpu"``, i.e. the plain
versions of its kernels.  Logits and losses are held to 3e-4 (the
tolerance of tests/test_arch_smoke.py).  The MoE functions are held in
tests/test_torch_moe.py, the engine for these configs in
tests/test_torch_serving.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import lm_loss as jax_lm_loss
from repro_torch.configs import ARCH_IDS, ShapeConfig, get
from repro_torch.configs.base import MLSTM, SLSTM
from repro_torch.convert import params_from_numpy
from repro_torch.launch.steps import make_train_step
from repro_torch.models import forward, init_cache, init_params, lm_loss
from repro_torch.utils import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEW = [a for a in ARCH_IDS if a != "smollm_135m"]
LOGIT_TOL = dict(rtol=3e-4, atol=3e-4)
BS = 8      # KV block size at smoke width, as tests/test_arch_smoke.py


def _cfgs(arch, **kw):
    """(port cfg, JAX cfg) of ``arch`` at SMOKE width in f32."""
    kw = dict(param_dtype="float32", kv_block_size=BS, **kw)
    return (get(arch, smoke=True).replace(**kw),
            jax_get(arch, smoke=True).replace(**kw))


_PARAMS = {}


def _params(arch):
    """(JAX params, the same params in torch) of the f32 SMOKE config."""
    if arch not in _PARAMS:
        p = jax_init_params(jax.random.PRNGKey(0), _cfgs(arch)[1])
        _PARAMS[arch] = (p, params_from_numpy(jax.tree.map(np.asarray, p),
                                              device="cpu"))
    return _PARAMS[arch]


def _inputs(cfg, B, S, seed):
    """(B, S) tokens or (B, S, d) embeds, from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "embeds":
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_jax_configs(arch):
    """CONFIG and SMOKE field for field, and the parameter counts."""
    for smoke in (False, True):
        mine, ref = get(arch, smoke=smoke), jax_get(arch, smoke=smoke)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", NEW)
def test_init_params_names_shapes_dtypes_match_jax(arch):
    """The default (bf16, f32 router) tree of every new config."""
    ref = jax_init_params(jax.random.PRNGKey(0), jax_get(arch, smoke=True))
    mine = init_params(get(arch, smoke=True), seed=0, device="cpu")
    assert [(n, tuple(a.shape), str(a.dtype)) for n, a in tree_paths(ref)] \
        == [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for n, t in tree_paths(mine)]


@pytest.mark.parametrize("arch", NEW)
def test_forward_logits_match_jax(arch):
    cfg, jcfg = _cfgs(arch)
    jp, tp = _params(arch)
    x = _inputs(cfg, 2, 16, seed=1)
    ref, _ = jax_forward(jp, jnp.asarray(x), jcfg, mode="train")
    out, _ = forward(tp, torch.from_numpy(x), cfg, mode="train")
    assert out.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), _np(ref), **LOGIT_TOL)


@pytest.mark.parametrize("arch", NEW)
def test_adamw_step_matches_jax_and_descends(arch):
    """One train step of the port (make_train_step): its loss and gradient
    norm equal jax.value_and_grad's, and the step descends.  The batch
    splits into each config's grad_accum.  Remat (tests/test_torch_train.py
    holds it) stays on for the MoE config only: it multiplies the JAX
    compile time."""
    cfg, jcfg = _cfgs(arch, remat="full" if arch == "olmoe_1b_7b" else
                      "none")
    jp, tp = _params(arch)
    B = max(2, cfg.grad_accum)
    x = _inputs(cfg, B, 16, seed=2)
    labels = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 16))

    def jax_loss(p):
        logits, _ = jax_forward(p, jnp.asarray(x), jcfg, mode="train")
        return jax_lm_loss(logits, jnp.asarray(labels))

    jl, grads = jax.value_and_grad(jax_loss)(jp)
    jnorm = np.sqrt(sum(float(jnp.sum(jnp.square(g)))
                        for g in jax.tree.leaves(grads)))

    step = make_train_step(cfg, ShapeConfig("t", 16, B, "train"),
                           device="cpu")
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jp)
    state = {"params": tp, "m": params_from_numpy(zeros, device="cpu"),
             "v": params_from_numpy(zeros, device="cpu"),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {"tokens": torch.from_numpy(x),
             "labels": torch.from_numpy(labels)}
    new, metrics = step(state, batch)
    with torch.no_grad():
        logits, _ = forward(new["params"], batch["tokens"], cfg, mode="train")
        after = float(lm_loss(logits, batch["labels"]))
    np.testing.assert_allclose(float(metrics["loss"]), float(jl),
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jnorm,
                               **LOGIT_TOL)
    assert after < float(metrics["loss"])


def _prefill_decode(arch, layout, S, pos, max_seq=32, B=3):
    """Prefill S inputs, then decode one input per sequence at ``pos``,
    on both packages.  Returns (port logits, JAX logits) of prefill and of
    decode, the JAX forward logits over S + 1 inputs, and both caches."""
    cfg, jcfg = _cfgs(arch)
    jp, tp = _params(arch)
    x = _inputs(cfg, B, S + 1, seed=4)
    step = np.stack([x[b, min(p, S)] for b, p in enumerate(pos)])[:, None]
    ref, _ = jax_forward(jp, jnp.asarray(x), jcfg, mode="train")
    jcache = jax_init_cache(jcfg, B, max_seq, layout)
    cache = init_cache(cfg, B, max_seq, layout, device="cpu")
    jpre, jcache = jax_forward(jp, jnp.asarray(x[:, :S]), jcfg,
                               mode="prefill", caches=jcache)
    pre, cache = forward(tp, torch.from_numpy(x[:, :S]), cfg,
                         mode="prefill", caches=cache)
    jdec, jcache = jax_forward(jp, jnp.asarray(step), jcfg, mode="decode",
                               caches=jcache, pos=jnp.asarray(pos, jnp.int32))
    dec, cache = forward(tp, torch.from_numpy(step), cfg, mode="decode",
                         caches=cache, pos=torch.tensor(pos))
    return (pre, jpre), (dec, jdec), ref, (cache, jcache)


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", NEW)
def test_prefill_decode_match_jax(arch, layout):
    """Prefill then a ragged decode step, against the JAX forward and the
    JAX decode.  Dense: S = 13, not a multiple of the block size, and one
    sequence at pos == max_seq (its write is dropped, its attention reads
    the whole cache).  Paged: S = 16, whole blocks."""
    max_seq = 32
    S, pos = (13, [13, 6, max_seq]) if layout == "dense" else (16, [16, 5, 9])
    (pre, jpre), (dec, jdec), ref, (cache, jcache) = _prefill_decode(
        arch, layout, S, pos, max_seq)
    np.testing.assert_allclose(pre.numpy(), _np(jpre), **LOGIT_TOL)
    np.testing.assert_allclose(pre.numpy(), _np(ref[:, :S]), **LOGIT_TOL)
    np.testing.assert_allclose(dec.numpy(), _np(jdec), **LOGIT_TOL)
    for b, p in enumerate(pos):
        if p <= S:      # a position the forward computed
            np.testing.assert_allclose(dec[b, 0].numpy(), _np(ref[b, p]),
                                       **LOGIT_TOL)
    for (name, got), (_, want) in zip(tree_paths(cache), tree_paths(jcache)):
        np.testing.assert_allclose(got.numpy(), _np(want), **LOGIT_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", [MLSTM, SLSTM, "shared_attn"])
def test_recurrent_kinds_and_shared_attention_raise(kind):
    cfg = get("smollm_135m", smoke=True)
    cfg = cfg.replace(shared_attn_every=2) if kind == "shared_attn" else \
        cfg.replace(block_pattern=(kind,))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        init_cache(cfg, 1, 16, device="cpu")
