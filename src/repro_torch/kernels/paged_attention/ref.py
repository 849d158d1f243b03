"""Plain PyTorch version of paged decode attention (block-table gather)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_decode_attention_ref(q, pool_k, pool_v, table, length):
    """q: (B, nh, hd); pool_k/v: (B, nblk, bs, nkv, hd); table: (B, nblk)
    int32 (logical block -> physical block); length: (B,) number of valid
    tokens.  Returns (B, nh, hd) in q's dtype.

    A sequence with ``length == 0`` attends to nothing and gets zeros, as
    the Pallas and CUDA kernels give (the JAX ``ref.py`` returns the mean of
    V there instead)."""
    B, nh, hd = q.shape
    nblk, bs, nkv = pool_k.shape[1], pool_k.shape[2], pool_k.shape[3]
    rep = nh // nkv
    bi = torch.arange(B, device=q.device)[:, None]
    k = pool_k[bi, table.long()].reshape(B, nblk * bs, nkv, hd).float()
    v = pool_v[bi, table.long()].reshape(B, nblk * bs, nkv, hd).float()
    qf = q.float().reshape(B, nkv, rep, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qf, k) * hd ** -0.5
    length = length.to(device=q.device).reshape(B)
    mask = torch.arange(nblk * bs, device=q.device)[None] < length[:, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask[:, None, None]
    o = torch.einsum("bgrk,bkgd->bgrd", p, v)
    o = o / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return o.reshape(B, nh, hd).to(q.dtype)


def paged_decode_attention_split_ref(q, pool_k, pool_v, table, length,
                                     blocks_per_split: int):
    """The split kernel's algorithm in plain PyTorch, for tests only: the
    logical blocks are cut into splits of ``blocks_per_split``; each split
    gives an f32 partial (m, l, acc) of its valid tokens (an empty split
    gives m = -1e30, l = 0), and the partials are merged in logical split
    order with the log-sum-exp rule, skipping empty ones.  Same arguments and
    result as ``paged_decode_attention_ref``."""
    B, nh, hd = q.shape
    nblk, bs, nkv = pool_k.shape[1], pool_k.shape[2], pool_k.shape[3]
    rep = nh // nkv
    bi = torch.arange(B, device=q.device)[:, None]
    k = pool_k[bi, table.long()].reshape(B, nblk * bs, nkv, hd).float()
    v = pool_v[bi, table.long()].reshape(B, nblk * bs, nkv, hd).float()
    qf = q.float().reshape(B, nkv, rep, hd)
    ntok = length.to(device=q.device).reshape(B).clamp(0, nblk * bs)
    pos = torch.arange(nblk * bs, device=q.device)
    span = blocks_per_split * bs
    parts = []
    for t0 in range(0, nblk * bs, span):
        ks, vs = k[:, t0:t0 + span], v[:, t0:t0 + span]
        mask = (pos[t0:t0 + span][None] < ntok[:, None])[:, None, None]
        s = torch.einsum("bgrd,bkgd->bgrk", qf, ks) * hd ** -0.5
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]) * mask
        parts.append((m, p.sum(-1), torch.einsum("bgrk,bkgd->bgrd", p, vs)))
    m_all = torch.full_like(parts[0][0], NEG_INF)
    for m, l, _ in parts:
        m_all = torch.where(l > 0, torch.maximum(m_all, m), m_all)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:                 # logical order
        w = torch.where(l > 0, torch.exp(m - m_all), 0.0)
        den = den + w * l
        num = num + w[..., None] * acc
    o = num / torch.clamp(den, min=1e-30)[..., None]
    return o.reshape(B, nh, hd).to(q.dtype)
