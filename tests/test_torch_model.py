"""The port's model layers and forward against the JAX package's, on the CPU.

Params are built by JAX ``init_params`` and carried across with
``params_from_numpy``; inputs come from numpy with a seed.  The port runs
with ``device="cpu"``, i.e. the plain versions of its kernels.  Logits are
held to 3e-4 (the tolerance of tests/test_arch_smoke.py), layers in f32 to
2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jax_get
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models.attention import \
    chunked_causal_attention as jax_chunked_causal_attention
from repro_torch.configs import get
from repro_torch.configs.base import MAMBA2
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import forward, init_cache, init_params
from repro_torch.models import layers
from repro_torch.models.attention import attn_decode, \
    flash_prefill_attention, init_attn_cache
from repro_torch.utils import tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LOGIT_TOL = dict(rtol=3e-4, atol=3e-4)
F32_TOL = dict(rtol=2e-5, atol=2e-5)

SMOKE = get("smollm_135m", smoke=True).replace(param_dtype="float32",
                                               kv_block_size=8)
# smollm's 9/3 head ratio at smoke width (SMOKE itself has 3/3, rep = 1)
GQA = SMOKE.replace(n_heads=9, n_kv_heads=3, head_dim=16)
# the attention variants _project_qkv carries (qwen2 bias, qwen3 qk-norm)
VARIANTS = SMOKE.replace(qkv_bias=True, qk_norm=True)
CFGS = {"smoke": SMOKE, "gqa": GQA, "bias_qknorm": VARIANTS}


def _jax_cfg(cfg):
    return jax_get("smollm_135m", smoke=True).replace(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _params(cfg, seed=0):
    p = jax_init_params(jax.random.PRNGKey(seed), _jax_cfg(cfg))
    np_p = jax.tree.map(np.asarray, p)
    return p, params_from_numpy(np_p, device="cpu")


def _np(x):
    return np.asarray(x, np.float32)


def test_rmsnorm_rope_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(x), 1e-5).numpy(),
        _np(jax_layers.rmsnorm({"scale": jnp.asarray(scale)},
                               jnp.asarray(x), 1e-5)), **F32_TOL)
    pos = rng.integers(0, 300, (2, 5))
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          10_000.0).numpy(),
        _np(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                  10_000.0)), rtol=1e-4, atol=1e-4)
    h = rng.standard_normal((3, 48)).astype(np.float32)
    for kind in ("swiglu", "gelu"):
        cfg = SMOKE.replace(mlp_kind=kind)
        p = jax_layers.mlp_init(jax.random.PRNGKey(1), _jax_cfg(cfg))
        tp = params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
        np.testing.assert_allclose(
            layers.mlp(tp, torch.from_numpy(h), cfg).numpy(),
            _np(jax_layers.mlp(p, jnp.asarray(h), _jax_cfg(cfg))), **F32_TOL)


def test_chunked_causal_attention_matches_jax():
    """The prefill attention (B, S, heads, hd) at 9/3 heads, against the
    JAX function run in several query chunks."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 256, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 256, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 256, 3, 16)).astype(np.float32)
    out = flash_prefill_attention(*map(torch.from_numpy, (q, k, v)))
    ref = jax_chunked_causal_attention(*map(jnp.asarray, (q, k, v)),
                                       chunk=64)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32_TOL)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_prefill_decode_logits_match_jax(name):
    cfg = CFGS[name]
    jcfg = _jax_cfg(cfg)
    jp, tp = _params(cfg)
    B, S = 2, 16
    x = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1))
    ref, _ = jax_forward(jp, jnp.asarray(x), jcfg, mode="train")
    out, _ = forward(tp, torch.from_numpy(x), cfg, mode="train")
    np.testing.assert_allclose(out.numpy(), _np(ref), **LOGIT_TOL)

    jcache = jax_init_cache(jcfg, B, 32, "paged")
    cache = init_cache(cfg, B, 32, device="cpu")
    jpre, jcache = jax_forward(jp, jnp.asarray(x[:, :S]), jcfg,
                               mode="prefill", caches=jcache)
    pre, cache = forward(tp, torch.from_numpy(x[:, :S]), cfg,
                         mode="prefill", caches=cache)
    np.testing.assert_allclose(pre.numpy(), _np(jpre), **LOGIT_TOL)
    for leaf in ("pool_k", "pool_v"):
        np.testing.assert_allclose(cache["layers"][0][leaf].numpy(),
                                   _np(jcache["layers"][0][leaf]),
                                   **LOGIT_TOL)
    dec, _ = forward(tp, torch.from_numpy(x[:, S:]), cfg, mode="decode",
                     caches=cache, pos=torch.tensor([S, S]))
    np.testing.assert_allclose(dec[:, 0].numpy(), _np(ref[:, S]),
                               **LOGIT_TOL)


@pytest.mark.parametrize("name", ["smoke", "gqa"])
def test_ragged_paged_decode_matches_jax(name):
    """Per-slot positions through scrambled tables: the port's decode gives
    the JAX decode's logits and cache."""
    cfg = CFGS[name]
    jcfg = _jax_cfg(cfg)
    jp, tp = _params(cfg, seed=2)
    B, S, max_seq = 3, 16, 32
    rng = np.random.default_rng(3)
    x = rng.integers(0, cfg.vocab_size, (B, S))
    jcache = jax_init_cache(jcfg, B, max_seq, "paged")
    nblk = max_seq // cfg.kv_block_size
    table = np.stack([rng.permutation(nblk) for _ in range(B)]).astype(
        np.int32)
    jcache["layers"][0]["table"] = jnp.broadcast_to(
        jnp.asarray(table), jcache["layers"][0]["table"].shape)
    _, jcache = jax_forward(jp, jnp.asarray(x), jcfg, mode="prefill",
                            caches=jcache)
    cache = params_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    pos = np.array([5, 11, 16])
    tok = rng.integers(0, cfg.vocab_size, (B, 1))
    jdec, jcache = jax_forward(jp, jnp.asarray(tok), jcfg, mode="decode",
                               caches=jcache, pos=jnp.asarray(pos, jnp.int32))
    dec, cache = forward(tp, torch.from_numpy(tok), cfg, mode="decode",
                         caches=cache, pos=torch.from_numpy(pos))
    np.testing.assert_allclose(dec.numpy(), _np(jdec), **LOGIT_TOL)
    np.testing.assert_allclose(cache["layers"][0]["pool_k"].numpy(),
                               _np(jcache["layers"][0]["pool_k"]),
                               **LOGIT_TOL)


def test_decode_at_pool_end_drops_write_and_spares_live_slots():
    """A freed slot left at pos == max_seq has no block to write: the write
    is dropped (JAX drops the out-of-range scatter), the slot's attention
    reads the whole pool, and the live slot beside it is unaffected."""
    cfg = GQA
    _, tp = _params(cfg)
    p = {k: v[0] for k, v in tp["layers"][0]["attn"].items()}
    max_seq, bs = 32, cfg.kv_block_size
    rng = np.random.default_rng(4)
    cache = init_attn_cache(cfg, 2, max_seq, device="cpu")
    for leaf in ("pool_k", "pool_v"):
        cache[leaf].copy_(torch.from_numpy(
            rng.standard_normal(cache[leaf].shape).astype(np.float32)))
    cache["table"].copy_(torch.from_numpy(np.stack(
        [rng.permutation(max_seq // bs) for _ in range(2)]).astype(np.int32)))
    x = torch.from_numpy(rng.standard_normal((2, 1, 48)).astype(np.float32))
    before = {k: v.clone() for k, v in cache.items()}
    out, cache = attn_decode(p, cache, x, torch.tensor([max_seq, 7]), cfg)
    assert torch.isfinite(out).all()
    assert torch.equal(cache["pool_k"][0], before["pool_k"][0])
    assert torch.equal(cache["pool_v"][0], before["pool_v"][0])
    # the live slot wrote exactly its own position and gives what it gives
    # alone
    live_blk = int(before["table"][1, 7 // bs])
    changed = (cache["pool_k"][1] != before["pool_k"][1]).any(-1).any(-1)
    assert changed.nonzero().tolist() == [[live_blk, 7 % bs]]
    solo = {k: v[1:].clone() for k, v in before.items()}
    alone, _ = attn_decode(p, solo, x[1:], torch.tensor([7]), cfg)
    np.testing.assert_allclose(out[1:].numpy(), alone.numpy(), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(dtype):
    cfg = GQA.replace(param_dtype=dtype)
    p = jax.tree.map(np.asarray,
                     jax_init_params(jax.random.PRNGKey(5), _jax_cfg(cfg)))
    tp = params_from_numpy(p, device="cpu")
    assert all(str(t.dtype) == f"torch.{dtype}" for _, t in tree_paths(tp))
    back = params_to_numpy(tp)
    for (n1, a), (n2, b) in zip(tree_paths(p), tree_paths(back)):
        assert n1 == n2 and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), n1


def test_init_params_names_shapes_dtypes_match_jax():
    cfg = GQA.replace(param_dtype="bfloat16")
    ref = jax_init_params(jax.random.PRNGKey(0), _jax_cfg(cfg))
    mine = init_params(cfg, seed=0, device="cpu")
    assert [(n, tuple(a.shape), str(a.dtype)) for n, a in tree_paths(ref)] \
        == [(n, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for n, t in tree_paths(mine)]
    again = init_params(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_paths(mine), tree_paths(again)))


def test_unported_block_kinds_raise():
    cfg = SMOKE.replace(block_pattern=(MAMBA2,))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_cache(cfg, 1, 16, device="cpu")
