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
