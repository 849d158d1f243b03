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
