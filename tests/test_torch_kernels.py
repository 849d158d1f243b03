"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is held
against the JAX Pallas kernel in interpret mode and against the JAX
``ref.py``, at the tolerances of tests/test_kernels.py (f32 2e-5, bf16
2e-2); compaction must be bit-exact.  Inputs come from numpy with a seed and
cross to torch bit-exactly.  The CUDA kernels themselves run only on a card:
tests/test_torch_cuda.py holds each against its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.kv_compaction.ops import compact_kv_pool as jax_compact
from repro.kernels.paged_attention.ops import \
    paged_decode_attention as jax_paged
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention.ops import WGMMA_ROW_REL, \
    flash_attention, row_relative_error
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, \
    flash_attention_tiled_ref
from repro_torch.kernels.kv_compaction.ops import compact_kv_pool
from repro_torch.kernels.kv_compaction.ref import compact_kv_pool_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.ref import \
    paged_decode_attention_ref, paged_decode_attention_split_ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == jnp.bfloat16 else \
        dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, dt):
    """The same values as a JAX array and a torch (CPU) tensor."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32), dt)
    return j, params_from_numpy(np.asarray(j), device="cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tables(rng, B, nblk):
    return np.stack([rng.permutation(nblk) for _ in range(B)]).astype(
        np.int32)


FLASH_SWEEP = [
    # (B, nh, nkv, S, hd, dtype, bq, bk): tests/test_kernels.py's sweep
    (2, 4, 2, 256, 64, jnp.float32, 128, 128),
    (1, 8, 8, 512, 128, jnp.bfloat16, 256, 128),
    (2, 6, 2, 128, 64, jnp.bfloat16, 128, 128),
    (1, 2, 1, 384, 64, jnp.float32, 128, 128),
    (3, 4, 4, 128, 256, jnp.float32, 64, 64),
    (1, 9, 3, 256, 64, jnp.bfloat16, 128, 64),   # smollm-style 9/3 heads
]


@pytest.mark.parametrize("B,nh,nkv,S,hd,dt,bq,bk", FLASH_SWEEP)
def test_flash_plain_matches_pallas_and_ref(B, nh, nkv, S, hd, dt, bq, bk):
    rng = np.random.default_rng(S + hd)
    jq, q = _pair(rng, (B, nh, S, hd), dt)
    jk, k = _pair(rng, (B, nkv, S, hd), dt)
    jv, v = _pair(rng, (B, nkv, S, hd), dt)
    out = flash_attention(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape
    pallas = jax_flash_attention(jq, jk, jv, backend="pallas_interpret",
                                 block_q=bq, block_k=bk)
    ref = jax_flash_attention(jq, jk, jv, backend="reference")
    np.testing.assert_allclose(_np(out), _np(pallas), **tol(dt))
    np.testing.assert_allclose(_np(out), _np(ref), **tol(dt))


def test_flash_plain_non_causal_matches_pallas():
    rng = np.random.default_rng(7)
    jq, q = _pair(rng, (1, 4, 256, 64), jnp.float32)
    jk, k = _pair(rng, (1, 4, 256, 64), jnp.float32)
    jv, v = _pair(rng, (1, 4, 256, 64), jnp.float32)
    out = flash_attention(q, k, v, causal=False)
    pallas = jax_flash_attention(jq, jk, jv, causal=False,
                                 backend="pallas_interpret", block_q=128,
                                 block_k=128)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=2e-5, atol=2e-5)


# The card's limit for bf16 flash on the wgmma route against the plain
# version run in f32, which the kernel misses by rounding P to bf16 before
# P @ V: each row within WGMMA_ROW_REL of its largest plain value.  The tiled
# version makes the same rounding on the CPU; held here against the plain
# version and the Pallas kernel, both on the inputs upcast to f32, it is the
# ground for that limit in chip_smoke.py and tests/test_torch_cuda.py.
@pytest.mark.parametrize(
    "B,nh,nkv,S,hd,dt,bq,bk",
    [c for c in FLASH_SWEEP if c[5] == jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiled_bf16_p_stays_within_card_limit(B, nh, nkv, S, hd, dt,
                                                    bq, bk, causal):
    rng = np.random.default_rng(S + hd)
    jq, q = _pair(rng, (B, nh, S, hd), dt)
    jk, k = _pair(rng, (B, nkv, S, hd), dt)
    jv, v = _pair(rng, (B, nkv, S, hd), dt)
    tiled = flash_attention_tiled_ref(q, k, v, causal=causal)
    assert tiled.dtype == q.dtype and tiled.shape == q.shape
    f32 = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    up = [x.astype(jnp.float32) for x in (jq, jk, jv)]
    pallas = jax_flash_attention(*up, causal=causal,
                                 backend="pallas_interpret", block_q=bq,
                                 block_k=bk)
    for theirs in (f32, torch.from_numpy(_np(pallas))):
        assert row_relative_error(tiled, theirs) <= WGMMA_ROW_REL
    # in f32 the tiled version is the plain one, to f32 rounding
    np.testing.assert_allclose(
        _np(flash_attention_tiled_ref(q.float(), k.float(), v.float(),
                                      causal=causal)), _np(f32),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fault", ["dropped key tile", "one future key"])
def test_flash_row_limit_rejects_late_row_faults(fault):
    """The row limit is tight where outputs are smallest: a fault confined
    to the last rows of a long causal prefill breaks it, while the tiled
    version (sound, P in bf16) keeps it."""
    S, start = 1024, 900
    rng = np.random.default_rng(3)
    _, q = _pair(rng, (1, 9, S, 64), jnp.bfloat16)
    _, k = _pair(rng, (1, 3, S, 64), jnp.bfloat16)
    _, v = _pair(rng, (1, 3, S, 64), jnp.bfloat16)
    plain = flash_attention_ref(q.float(), k.float(), v.float())
    out = flash_attention_tiled_ref(q, k, v)
    assert row_relative_error(out, plain) <= WGMMA_ROW_REL
    pos, rows = torch.arange(S), torch.arange(start, S)[:, None]
    visible = pos <= rows + (fault == "one future key")
    if fault == "dropped key tile":
        visible &= (pos < 256) | (pos >= 320)
    s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, start:].float(),
                     k.float().repeat_interleave(3, dim=1)) * 64 ** -0.5
    p = torch.softmax(torch.where(visible, s, -torch.inf), dim=-1)
    out[:, :, start:] = torch.einsum(
        "bhqk,bhkd->bhqd", p, v.float().repeat_interleave(3, dim=1)).to(
            out.dtype)
    assert row_relative_error(out, plain) > 4 * WGMMA_ROW_REL


PAGED_SWEEP = [
    # (B, nh, nkv, nblk, bs, hd, dtype): tests/test_kernels.py's sweep
    (2, 8, 2, 8, 16, 64, jnp.float32),
    (3, 4, 4, 4, 32, 128, jnp.bfloat16),
    (1, 16, 8, 16, 8, 64, jnp.bfloat16),
    (4, 2, 2, 2, 64, 128, jnp.float32),
    (3, 9, 3, 4, 64, 64, jnp.bfloat16),          # smollm-style 9/3 heads
]


@pytest.mark.parametrize("B,nh,nkv,nblk,bs,hd,dt", PAGED_SWEEP)
def test_paged_plain_matches_pallas_and_ref(B, nh, nkv, nblk, bs, hd, dt):
    rng = np.random.default_rng(nblk * bs + hd)
    jq, q = _pair(rng, (B, nh, hd), dt)
    jpk, pk = _pair(rng, (B, nblk, bs, nkv, hd), dt)
    jpv, pv = _pair(rng, (B, nblk, bs, nkv, hd), dt)
    table = _tables(rng, B, nblk)
    length = np.array([max(1, nblk * bs - 5)] + [nblk * bs] * (B - 1),
                      np.int32)
    out = paged_decode_attention(q, pk, pv, torch.from_numpy(table),
                                 torch.from_numpy(length))
    args = (jq, jpk, jpv, jnp.asarray(table), jnp.asarray(length))
    pallas = jax_paged(*args, backend="pallas_interpret")
    ref = jax_paged(*args, backend="reference")
    np.testing.assert_allclose(_np(out), _np(pallas), **tol(dt))
    np.testing.assert_allclose(_np(out), _np(ref), **tol(dt))


@pytest.mark.parametrize("B,nh,nkv,nblk,bs,hd,dt", PAGED_SWEEP)
@pytest.mark.parametrize("blocks_per_split", [1, 2, 3])
def test_paged_split_plain_matches_plain_and_pallas(B, nh, nkv, nblk, bs, hd,
                                                    dt, blocks_per_split):
    """The split kernel's algorithm (per-split partials merged in logical
    order) at the edge lengths 0, 1, bs, bs + 1, nblk * bs and
    nblk * bs + 1, one per sequence; three blocks per split never divide
    the sweep's block counts."""
    lengths = [0, 1, bs, bs + 1, nblk * bs, nblk * bs + 1]
    B = len(lengths)
    rng = np.random.default_rng(nblk * bs + hd + blocks_per_split)
    jq, q = _pair(rng, (B, nh, hd), dt)
    jpk, pk = _pair(rng, (B, nblk, bs, nkv, hd), dt)
    jpv, pv = _pair(rng, (B, nblk, bs, nkv, hd), dt)
    table = _tables(rng, B, nblk)
    length = np.array(lengths, np.int32)
    tt, tl = torch.from_numpy(table), torch.from_numpy(length)
    split = paged_decode_attention_split_ref(q, pk, pv, tt, tl,
                                             blocks_per_split)
    assert split.dtype == q.dtype and split.shape == q.shape
    assert torch.count_nonzero(split[0]) == 0
    pallas = jax_paged(jq, jpk, jpv, jnp.asarray(table), jnp.asarray(length),
                       backend="pallas_interpret")
    np.testing.assert_allclose(
        _np(split), _np(paged_decode_attention_ref(q, pk, pv, tt, tl)),
        **tol(dt))
    np.testing.assert_allclose(_np(split), _np(pallas), **tol(dt))


def test_paged_plain_edge_lengths_match_pallas():
    """length == 0 gives zeros (the Pallas kernel's answer; the JAX ref.py
    gives the mean of V there), a length past the pool reads every block,
    and a length inside a block masks the rest of it."""
    B, nh, nkv, nblk, bs, hd = 4, 9, 3, 2, 8, 16
    rng = np.random.default_rng(11)
    jq, q = _pair(rng, (B, nh, hd), jnp.float32)
    jpk, pk = _pair(rng, (B, nblk, bs, nkv, hd), jnp.float32)
    jpv, pv = _pair(rng, (B, nblk, bs, nkv, hd), jnp.float32)
    table = _tables(rng, B, nblk)
    length = np.array([0, 5, nblk * bs, nblk * bs + 3], np.int32)
    out = paged_decode_attention(q, pk, pv, torch.from_numpy(table),
                                 torch.from_numpy(length))
    pallas = jax_paged(jq, jpk, jpv, jnp.asarray(table), jnp.asarray(length),
                       backend="pallas_interpret")
    assert np.all(_np(out)[0] == 0.0)
    np.testing.assert_allclose(_np(out), _np(pallas), rtol=2e-5, atol=2e-5)
    clipped = paged_decode_attention(
        q, pk, pv, torch.from_numpy(table),
        torch.from_numpy(np.minimum(length, nblk * bs)))
    assert torch.equal(out, clipped)


COMPACT_CASES = [
    # (B, nblk, bs, C, dtype, seed)
    (1, 1, 8, 32, jnp.float32, 0),
    (2, 5, 8, 64, jnp.float32, 1),
    (3, 8, 16, 32, jnp.float32, 2),
    (2, 7, 16, 64, jnp.bfloat16, 3),
    (3, 4, 8, 48, jnp.bfloat16, 4),
]


@pytest.mark.parametrize("B,nblk,bs,C,dt,seed", COMPACT_CASES)
def test_compaction_is_permutation_inverse_bit_exact(B, nblk, bs, C, dt,
                                                     seed):
    """Output block i == input block table[i], bit for bit, as the Pallas
    kernel gives; compacting an identity table is a no-op."""
    rng = np.random.default_rng(seed)
    jpool, pool = _pair(rng, (B, nblk, bs, C), dt)
    table = _tables(rng, B, nblk)
    out, ident = compact_kv_pool(pool, torch.from_numpy(table))
    pallas, _ = jax_compact(jpool, jnp.asarray(table),
                            backend="pallas_interpret")
    ref, _ = jax_compact(jpool, jnp.asarray(table), backend="reference")
    mine = out.view(torch.int16 if dt == jnp.bfloat16 else torch.int32)
    for theirs in (pallas, ref):
        assert mine.numpy().tobytes() == np.asarray(theirs).tobytes()
    assert torch.equal(ident, torch.arange(nblk, dtype=torch.int32)
                       .repeat(B, 1))
    again, _ = compact_kv_pool(out, ident)
    assert torch.equal(again.view(mine.dtype), mine)
    assert pool.data_ptr() != out.data_ptr()   # out of place


def test_paged_attention_invariant_under_compaction():
    """Attention(q, pool, table) == Attention(q, compact(pool), identity):
    the kernel-level statement of the paper's GC correctness."""
    B, nh, nkv, nblk, bs, hd = 2, 9, 3, 8, 16, 64
    rng = np.random.default_rng(12)
    _, q = _pair(rng, (B, nh, hd), jnp.float32)
    _, pk = _pair(rng, (B, nblk, bs, nkv, hd), jnp.float32)
    _, pv = _pair(rng, (B, nblk, bs, nkv, hd), jnp.float32)
    table = torch.from_numpy(_tables(rng, B, nblk))
    length = torch.tensor([nblk * bs - 3, nblk * bs], dtype=torch.int32)
    before = paged_decode_attention(q, pk, pv, table, length)
    ck, ident = compact_kv_pool(pk.reshape(B, nblk, bs, -1), table)
    cv, _ = compact_kv_pool(pv.reshape(B, nblk, bs, -1), table)
    after = paged_decode_attention(q, ck.reshape(pk.shape),
                                   cv.reshape(pv.shape), ident, length)
    np.testing.assert_allclose(before.numpy(), after.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(13)
    _, q = _pair(rng, (1, 3, 64, 16), jnp.float32)
    _, k = _pair(rng, (1, 1, 64, 16), jnp.float32)
    _, pq = _pair(rng, (2, 3, 16), jnp.float32)
    _, pool = _pair(rng, (2, 4, 8, 16), jnp.float32)
    pk = pool.reshape(2, 4, 8, 1, 16)
    table = torch.from_numpy(_tables(rng, 2, 4))
    length = torch.tensor([9, 32], dtype=torch.int32)
    wrappers = (flash_attention, paged_decode_attention, compact_kv_pool)
    counts = [f.launches for f in wrappers]
    assert torch.equal(flash_attention(q, k, k), flash_attention_ref(q, k, k))
    assert torch.equal(
        paged_decode_attention(pq, pk, pk, table, length),
        paged_decode_attention_ref(pq, pk, pk, table, length))
    assert torch.equal(compact_kv_pool(pool, table)[0],
                       compact_kv_pool_ref(pool, table))
    assert counts == [f.launches for f in wrappers]


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    """Off the CPU a wrapper launches its kernel or raises: it never runs
    the plain version on another device."""
    q = torch.empty((1, 3, 64, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q[:, :1], q[:, :1])
    pool = torch.empty((1, 2, 8, 1, 16), device="meta")
    tbl = torch.empty((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(q[:, :, 0], pool, pool, tbl, tbl[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        compact_kv_pool(pool.reshape(1, 2, 8, 16), tbl)
