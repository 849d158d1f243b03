"""KV-pool compaction: CUDA kernel for CUDA tensors, plain version for CPU.

The wrapper runs ``compact_kv_pool_ref`` only when the pool lies on the CPU;
for a CUDA pool it launches ``csrc/kv_compaction.cu`` or raises.

The kernel is forward only: a CUDA call on inputs that require grad
raises (``_build.require_cuda``) rather than return an output with no
``grad_fn``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_compaction.ref import compact_kv_pool_ref

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p]


def compact_kv_pool(pool: torch.Tensor, table: torch.Tensor):
    """pool: (B, nblk, bs, C) any dtype; table: (B, nblk) int32.
    Returns (compacted_pool, identity_table); the pool is not modified."""
    B, nblk = table.shape
    ident = torch.arange(nblk, dtype=table.dtype,
                         device=table.device)[None].repeat(B, 1)
    if pool.device.type == "cpu":
        return compact_kv_pool_ref(pool, table), ident
    _build.require_cuda("compact_kv_pool", pool, table)
    if pool.dim() != 4 or pool.shape[:2] != (B, nblk):
        raise ValueError(f"pool {tuple(pool.shape)} does not match table "
                         f"{tuple(table.shape)}")
    if table.dtype != torch.int32:
        raise TypeError("table must be int32")
    block_bytes = pool.shape[2] * pool.shape[3] * pool.element_size()
    if block_bytes % 16:
        raise ValueError(f"block of {block_bytes} bytes: the kernel copies "
                         "16-byte vectors")
    out = torch.empty_like(pool)
    fn = _build.function("kv_compaction", "compact_kv_pool", _ARGS)
    with torch.cuda.device(pool.device):
        err = fn(pool.data_ptr(), table.data_ptr(), out.data_ptr(), B, nblk,
                 block_bytes, _build.stream_ptr(pool.device))
    _build.check("kv_compaction", err)
    compact_kv_pool.launches += 1
    return out, ident


compact_kv_pool.launches = 0
