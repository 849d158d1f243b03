"""Plain PyTorch version of KV-pool compaction (gather to logical order)."""
from __future__ import annotations

import torch


def compact_kv_pool_ref(pool: torch.Tensor, table: torch.Tensor):
    """pool: (B, nblk, bs, C); table: (B, nblk) logical->physical.
    Returns the pool re-packed in logical order (a new tensor)."""
    bi = torch.arange(pool.shape[0], device=pool.device)[:, None]
    return pool[bi, table.long()]
