"""Plain PyTorch version of GQA flash attention (the prefill attention)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, chunk: int = 512):
    """q: (B, nh, Sq, hd); k, v: (B, nkv, Skv, hd).  Returns (B, nh, Sq, hd)
    in q's dtype; f32 softmax; query head h reads KV head h // (nh / nkv);
    under ``causal`` key c is visible to query r iff c <= r.  Queries are
    taken ``chunk`` rows at a time so the f32 scores stay
    O(chunk * Skv) per head."""
    B, nh, Sq, hd = q.shape
    nkv, Skv = k.shape[1], k.shape[2]
    rep = nh // nkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    kv_pos = torch.arange(Skv, device=q.device)
    out = []
    for start in range(0, Sq, chunk):
        qc = q[:, :, start:start + chunk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * hd ** -0.5
        if causal:
            q_pos = torch.arange(start, start + qc.shape[2], device=q.device)
            s = torch.where(kv_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out.append(o / torch.clamp(p.sum(-1, keepdim=True), min=1e-30))
    return torch.cat(out, dim=2).to(q.dtype)


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True,
                              block_k: int = 64):
    """The tensor-core kernel's arithmetic in plain PyTorch, for tests only:
    an online softmax over key tiles of ``block_k`` (the kernel's BK) with
    m, l and the output accumulator in f32, where P is rounded to q's dtype
    before P @ V (the kernel feeds P to the bf16 tensor cores) while l sums
    the f32 P.  Same arguments and result as ``flash_attention_ref``."""
    B, nh, Sq, hd = q.shape
    nkv, Skv = k.shape[1], k.shape[2]
    rep = nh // nkv
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, nh, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, nh, Sq, 1), device=q.device)
    acc = torch.zeros((B, nh, Sq, hd), device=q.device)
    for k0 in range(0, Skv, block_k):
        s = torch.einsum("bhqd,bhkd->bhqk", qf,
                         kf[:, :, k0:k0 + block_k]) * hd ** -0.5
        if causal:
            kv_pos = torch.arange(k0, k0 + s.shape[-1], device=q.device)
            s = torch.where(kv_pos[None, :] <= q_pos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(s > NEG_INF, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd",
                                         p.to(q.dtype).float(),
                                         vf[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
