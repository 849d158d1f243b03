"""GQA attention: causal prefill/train attention + paged-cache decode.

The paged cache mirrors the paper's storage states: a block pool
(B, n_blocks, block, n_kv, hd) is the scattered ValueLog and the per-sequence
int32 block table (logical -> physical) is the key->offset index.

Both attention calls go through kernel wrappers that route by the tensors'
device: prefill/train attention through ``flash_attention`` and decode
through ``paged_decode_attention``, which read the block table themselves.
For CUDA tensors they launch the hand-written kernels; for CPU tensors they
run the plain versions, which compute what the JAX package's
``chunked_causal_attention`` and gather-then-attend decode compute.

Unlike the functional JAX package, cache writes happen in place: the
pool tensors passed in are updated and returned.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models.layers import apply_rope, dense_init, param_dtype, \
    rmsnorm


def attn_init(gen, cfg):
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = param_dtype(cfg)
    p = {
        "wq": dense_init(gen, (d, nh * hd), dt),
        "wk": dense_init(gen, (d, nkv * hd), dt),
        "wv": dense_init(gen, (d, nkv * hd), dt),
        "wo_attn": dense_init(gen, (nh * hd, d), dt, fan_in=nh * hd),
    }
    if cfg.qkv_bias:
        p["wq_bias"] = torch.zeros((nh * hd,), dtype=dt)
        p["wk_bias"] = torch.zeros((nkv * hd,), dtype=dt)
        p["wv_bias"] = torch.zeros((nkv * hd,), dtype=dt)
    if cfg.qk_norm:
        p["q_norm_scale"] = torch.ones((hd,), dtype=dt)
        p["k_norm_scale"] = torch.ones((hd,), dtype=dt)
    return p


def _project_qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["wq_bias"]
        k = k + params["wk_bias"]
        v = v + params["wv_bias"]
    q = q.reshape(B, S, nh, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm({"scale": params["q_norm_scale"]}, q, cfg.norm_eps)
        k = rmsnorm({"scale": params["k_norm_scale"]}, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_causal_attention(q, k, v):
    """q: (B, S, nh, hd); k, v: (B, S, nkv, hd).  Returns (B, S, nh, hd).

    Causal GQA attention with f32 softmax from position 0 (the JAX
    function's ``q_offset=0``): the flash kernel on CUDA, its plain
    (query-chunked) version on the CPU."""
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=True)
    return o.transpose(1, 2)


# ------------------------------------------------------------ cache layout
def init_attn_cache(cfg, batch: int, max_seq: int, device="cuda"):
    """The paged layout: pools (batch, n_blk, bs, nkv, hd) and an identity
    int32 table (batch, n_blk)."""
    nkv, hd, bs = cfg.n_kv_heads, cfg.hd, cfg.kv_block_size
    dt = param_dtype(cfg)
    n_blk = max_seq // bs
    return {
        "pool_k": torch.zeros((batch, n_blk, bs, nkv, hd), dtype=dt,
                              device=device),
        "pool_v": torch.zeros((batch, n_blk, bs, nkv, hd), dtype=dt,
                              device=device),
        # logical block -> physical block (identity = fully compacted)
        "table": torch.arange(n_blk, dtype=torch.int32,
                              device=device)[None].repeat(batch, 1),
    }


def attn_decode(params, cache, x, pos, cfg):
    """One-token decode. x: (B, 1, d); pos: scalar OR per-sequence (B,)
    position (continuous batching serves ragged sequences in one lockstep
    batch).

    The new K/V go to slot ``pos % bs`` of block ``table[pos // bs]``.  A
    position at or past the pool's end (a freed slot left at
    ``pos == max_seq``) has no block: its write is dropped, as JAX drops an
    out-of-range scatter, and its attention reads the whole pool."""
    B = x.shape[0]
    nh, hd, bs = cfg.n_heads, cfg.hd, cfg.kv_block_size
    pos_b = torch.as_tensor(pos, device=x.device).long().reshape(-1).expand(B)
    q, k_new, v_new = _project_qkv(params, x, cfg, pos_b[:, None])
    pool_k, pool_v, table = cache["pool_k"], cache["pool_v"], cache["table"]
    nblk = table.shape[1]
    bi = torch.arange(B, device=x.device)
    logical = pos_b // bs
    inside = (logical < nblk)[:, None, None]
    blk = table[bi, logical.clamp(max=nblk - 1)].long()
    slot = pos_b % bs
    pool_k[bi, blk, slot] = torch.where(inside, k_new[:, 0].to(pool_k.dtype),
                                        pool_k[bi, blk, slot])
    pool_v[bi, blk, slot] = torch.where(inside, v_new[:, 0].to(pool_v.dtype),
                                        pool_v[bi, blk, slot])
    length = (pos_b + 1).to(torch.int32)
    o = paged_decode_attention(q[:, 0].contiguous(), pool_k, pool_v, table,
                               length)
    out = o.reshape(B, 1, nh * hd).to(x.dtype) @ params["wo_attn"]
    return out, cache


def attn_apply(params, x, cfg, *, mode="train", cache=None, pos=None):
    """Unified entry. Returns (out, cache)."""
    if mode == "decode":
        return attn_decode(params, cache, x, pos, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None]
    q, k, v = _project_qkv(params, x, cfg, positions)
    o = chunked_causal_attention(q, k, v)
    out = o.reshape(B, S, -1) @ params["wo_attn"]
    if mode == "prefill" and cache is not None:
        bs = cfg.kv_block_size
        if S % bs:
            raise ValueError(f"prefill length {S} must be a multiple of the "
                             f"KV block size {bs}")
        kb = k.reshape(B, S // bs, bs, *k.shape[2:])
        vb = v.reshape(B, S // bs, bs, *v.shape[2:])
        # write THROUGH the block table (physical placement may be
        # scattered: the serving allocator owns the table)
        dest = cache["table"][:, :S // bs].long()            # (B, nwb)
        bi = torch.arange(B, device=x.device)[:, None]
        cache["pool_k"][bi, dest] = kb.to(cache["pool_k"].dtype)
        cache["pool_v"][bi, dest] = vb.to(cache["pool_v"].dtype)
    return out, cache
