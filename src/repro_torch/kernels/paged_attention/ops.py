"""Paged decode attention: CUDA kernel for CUDA tensors, plain version for
CPU.

The wrapper runs ``paged_decode_attention_ref`` only when q lies on the
CPU; for CUDA tensors it launches ``csrc/paged_attention.cu`` (a split pass
over the sequence axis and a merge pass, into a workspace the wrapper
allocates) or raises.

The kernel is forward only: a CUDA call on inputs that require grad
raises (``_build.require_cuda``) rather than return an output with no
``grad_fn``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_decode_attention_ref

_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
SPLIT_TOKENS = 64  # a split covers at least this many tokens (kChunk)


def blocks_per_split(bs: int) -> int:
    """Logical blocks per split: enough for SPLIT_TOKENS tokens.  It depends
    on the block size alone, so the grid never depends on ``length``."""
    return max(1, SPLIT_TOKENS // bs)


def split_plan(B: int, nh: int, nkv: int, nblk: int, bs: int, hd: int):
    """(blocks per split, splits, workspace floats) of one launch."""
    bps = blocks_per_split(bs)
    nsplit = -(-nblk // bps)
    parts = B * nkv * nsplit * (nh // nkv)
    return bps, nsplit, parts * (hd + 2)


def paged_decode_attention(q, pool_k, pool_v, table, length):
    """q: (B, nh, hd); pool_k/v: (B, nblk, bs, nkv, hd); table: (B, nblk)
    int32; length: (B,) int32 valid tokens.  Returns (B, nh, hd)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool_k, pool_v, table, length)
    _build.require_cuda("paged_decode_attention", q, pool_k, pool_v, table,
                        length)
    B, nh, hd = q.shape
    if pool_k.dim() != 5 or pool_k.shape != pool_v.shape:
        raise ValueError("pool_k/pool_v must be (B, nblk, bs, nkv, hd)")
    _, nblk, bs, nkv, _ = pool_k.shape
    if pool_k.shape[0] != B or pool_k.shape[4] != hd or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not match pool "
                         f"{tuple(pool_k.shape)}")
    if table.shape != (B, nblk) or length.shape != (B,):
        raise ValueError("table must be (B, nblk) and length (B,)")
    if table.dtype != torch.int32 or length.dtype != torch.int32:
        raise TypeError("table and length must be int32")
    if not (q.dtype == pool_k.dtype == pool_v.dtype):
        raise TypeError("q and the pools must share a dtype")
    if hd % 8:
        raise ValueError(f"head_dim {hd} must be a multiple of 8")
    code = _build.dtype_code(q)
    fn = _build.function("paged_attention", "paged_decode_attention", _ARGS)
    bps, nsplit, n_ws = split_plan(B, nh, nkv, nblk, bs, hd)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    ws_acc = ws[:n_ws // (hd + 2) * hd]
    ws_ml = ws[ws_acc.numel():]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                 table.data_ptr(), length.data_ptr(), out.data_ptr(),
                 ws_acc.data_ptr(), ws_ml.data_ptr(), B, nh, nkv, nblk, bs,
                 hd, bps, code, _build.stream_ptr(q.device))
    _build.check("paged_attention", err)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
